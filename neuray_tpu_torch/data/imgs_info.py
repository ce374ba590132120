"""imgs_info: the host-side numpy dicts fed to the renderer (port
of ``neuray_tpu/data/imgs_info.py``; reference utils/imgs_info.py and
utils/base_utils.py). Channels-last, coords (x, y) float32. The random
draws call ``np.random.RandomState`` in the JAX package's order, so one
seed draws the same rays and crops in both.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def color_map_forward(rgb: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [0, 1]."""
    return rgb.astype(np.float32) / 255


def pad_img_end(img: np.ndarray, th: int, tw: int, mode: str = "edge",
                constant_values=0) -> np.ndarray:
    """Pad an [h, w, c] image at the bottom and right to (th, tw)."""
    h, w = img.shape[:2]
    hp, wp = th - h, tw - w
    if hp == 0 and wp == 0:
        return img
    if mode == "constant":
        return np.pad(img, ((0, hp), (0, wp), (0, 0)), mode,
                      constant_values=constant_values)
    return np.pad(img, ((0, hp), (0, wp), (0, 0)), mode)


def pad_imgs_info(imgs_info: Dict[str, np.ndarray],
                  pad_interval: int) -> Dict[str, np.ndarray]:
    """Reflect-pad imgs, depth, masks and true_depth at the bottom and
    right to a multiple of pad_interval."""
    h, w = imgs_info["imgs"].shape[1:3]
    ph = (pad_interval - (h % pad_interval)) % pad_interval
    pw = (pad_interval - (w % pad_interval)) % pad_interval
    if ph == 0 and pw == 0:
        return imgs_info
    for k in ("imgs", "depth", "masks", "true_depth"):
        if k in imgs_info and imgs_info[k] is not None:
            imgs_info[k] = np.pad(
                imgs_info[k], ((0, 0), (0, ph), (0, pw), (0, 0)), "reflect")
    return imgs_info


def build_imgs_info(database, ref_ids: List[str], pad_interval: int = -1,
                    is_aligned: bool = True, align_depth_range: bool = False,
                    has_depth: bool = True,
                    replace_none_depth: bool = False) -> Dict[str, np.ndarray]:
    """Load images, poses, Ks and depths of ref_ids into one dict:
    {imgs [n, h, w, 3] f32 in [0, 1], poses [n, 3, 4], Ks [n, 3, 3],
    depth_range [n, 2], masks [n, h, w, 1] f32, depth [n, h, w, 1] f32
    (with has_depth)}. With is_aligned=False, views of different sizes
    are padded at the bottom and right to the largest."""
    if not is_aligned:
        if not has_depth:
            raise ValueError("is_aligned=False pads the depth maps too: it "
                             "needs has_depth")
        imgs, masks, depths, shapes = [], [], [], []
        for ref_id in ref_ids:
            img = database.get_image(ref_id)
            shapes.append(img.shape[:2])
            imgs.append(img)
            masks.append(database.get_mask(ref_id))
            depths.append(database.get_depth(ref_id))
        th, tw = np.max(np.asarray(shapes), 0)
        for i in range(len(ref_ids)):
            imgs[i] = pad_img_end(imgs[i], th, tw, "reflect")
            masks[i] = pad_img_end(
                np.asarray(masks[i], np.float32)[:, :, None], th, tw,
                "constant", 0)
            depths[i] = pad_img_end(
                np.asarray(depths[i], np.float32)[:, :, None], th, tw,
                "constant", 0)
        ref_imgs = color_map_forward(np.stack(imgs, 0))
        ref_masks = np.stack(masks, 0).astype(np.float32)
        ref_depths = np.stack(depths, 0).astype(np.float32)
    else:
        ref_imgs = color_map_forward(
            np.asarray([database.get_image(i) for i in ref_ids]))
        ref_masks = np.asarray([database.get_mask(i) for i in ref_ids],
                               np.float32)[..., None]
        if has_depth:
            depths = [database.get_depth(i) for i in ref_ids]
            if replace_none_depth:
                h, w = ref_imgs.shape[1:3]
                depths = [np.zeros([h, w], np.float32) if d is None else d
                          for d in depths]
            ref_depths = np.asarray(depths, np.float32)[..., None]
        else:
            ref_depths = None

    poses = np.asarray([database.get_pose(i) for i in ref_ids], np.float32)
    Ks = np.asarray([database.get_K(i) for i in ref_ids], np.float32)
    depth_range = np.asarray([database.get_depth_range(i) for i in ref_ids],
                             np.float32)
    if align_depth_range:
        depth_range[:, 0] = np.min(depth_range[:, 0])
        depth_range[:, 1] = np.max(depth_range[:, 1])
    info = {"imgs": ref_imgs, "poses": poses, "Ks": Ks,
            "depth_range": depth_range, "masks": ref_masks}
    if has_depth:
        info["depth"] = ref_depths
    if pad_interval != -1:
        info = pad_imgs_info(info, pad_interval)
    return info


def build_render_imgs_info(que_pose: np.ndarray, que_K: np.ndarray,
                           que_shape, que_depth_range) -> Dict:
    """The query info of one pose rendered over its full pixel grid."""
    h, w = int(que_shape[0]), int(que_shape[1])
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
    coords = coords.reshape([1, -1, 2]).astype(np.float32)
    return {"poses": que_pose.astype(np.float32)[None],
            "Ks": que_K.astype(np.float32)[None],
            "coords": coords,
            "depth_range": np.asarray(que_depth_range, np.float32)[None],
            "shape": (h, w)}


def imgs_info_slice(imgs_info: Dict, indices) -> Dict:
    """Select views along axis 0."""
    return {k: v[indices] for k, v in imgs_info.items()}


def random_crop(ref_imgs_info: Dict, que_imgs_info: Dict, target_size,
                rng: Optional[np.random.RandomState] = None):
    """One random window of target_size (h, w) cut from the ref and the
    query views alike, the principal points moved with it; nothing is cut
    when the window does not fit."""
    rng = rng or np.random
    h, w = ref_imgs_info["imgs"].shape[1:3]
    out_h, out_w = target_size
    if out_w >= w or out_h >= h:
        return ref_imgs_info, que_imgs_info
    center_h = rng.randint(low=out_h // 2 + 1, high=h - out_h // 2 - 1)
    center_w = rng.randint(low=out_w // 2 + 1, high=w - out_w // 2 - 1)
    h0, w0 = center_h - out_h // 2, center_w - out_w // 2

    def crop_info(info):
        for k in ("imgs", "depth", "true_depth", "masks"):
            if k in info and info[k] is not None:
                info[k] = info[k][:, h0:h0 + out_h, w0:w0 + out_w]
        Ks = info["Ks"].copy()
        Ks[:, 0, 2] -= w0
        Ks[:, 1, 2] -= h0
        info["Ks"] = Ks
        return info

    return crop_info(ref_imgs_info), crop_info(que_imgs_info)


def random_flip(ref_imgs_info: Dict, que_imgs_info: Dict):
    """The ref and query views flipped left to right, the Ks with them."""
    def flip_info(info):
        for k in ("imgs", "depth", "true_depth", "masks"):
            if k in info and info[k] is not None:
                info[k] = np.ascontiguousarray(np.flip(info[k], 2))
        Ks = info["Ks"].copy()
        Ks[:, 0, :] *= -1
        Ks[:, 0, 2] += info["imgs"].shape[2] - 1
        info["Ks"] = Ks
        return info

    return flip_info(ref_imgs_info), flip_info(que_imgs_info)


def get_coords_mask(que_mask: np.ndarray, train_ray_num: int,
                    foreground_ratio: float,
                    rng: Optional[np.random.RandomState] = None
                    ) -> np.ndarray:
    """Foreground-biased pixel sampling: at least
    train_ray_num * foreground_ratio rays inside the mask [h, w] (bool),
    the rest from the other pixels and the unused foreground; a mask with
    too few pixels is topped up by drawing with replacement, so the batch
    always has train_ray_num rays. Returns (x, y) float32
    [train_ray_num, 2]."""
    rng = rng or np.random
    min_pos_num = int(train_ray_num * foreground_ratio)
    y0, x0 = np.nonzero(que_mask)
    y1, x1 = np.nonzero(~que_mask)
    xy0 = np.stack([x0, y0], 1).astype(np.float32)
    xy1 = np.stack([x1, y1], 1).astype(np.float32)
    idx = rng.permutation(xy0.shape[0])
    xy0 = xy0[idx]
    coords0 = xy0[:min_pos_num]
    if min_pos_num < train_ray_num:
        xy1 = np.concatenate([xy1, xy0[min_pos_num:]], 0)
        idx = rng.permutation(xy1.shape[0])
        coords1 = xy1[idx[:train_ray_num - min_pos_num]]
        coords = np.concatenate([coords0, coords1], 0)
    else:
        coords = coords0
    if coords.shape[0] < train_ray_num:
        pool = np.concatenate([xy0, xy1], 0)
        extra = pool[rng.randint(0, pool.shape[0],
                                 train_ray_num - coords.shape[0])]
        coords = np.concatenate([coords, extra], 0)
    return coords
