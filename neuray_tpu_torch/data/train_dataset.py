"""Training datasets (port of ``neuray_tpu/data/train_dataset.py``;
reference dataset/train_dataset.py): ``GeneralRendererDataset`` over the
dataset families of ``data/database.py`` and ``data/train_databases.py``
(training: the weighted family draw and its augmentations; eval: one val
scene), with the cost-volume source-view wiring
``build_src_imgs_info_select``; ``FinetuningRendererDataset`` (indices
only); and the synthetic sphere scenes of ``SyntheticRendererDataset``.
Each draws from ``np.random.RandomState`` in the JAX package's order, so
one index and one seed give the same sample in both packages.

Samples are dicts of numpy arrays: {"ref", "que", "scene_name",
"is_gso"} and, where used, "src" and "depth_loss_coords".
"""
from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np

from neuray_tpu_torch.data.database import (
    get_database_split, parse_database_name)
from neuray_tpu_torch.data.imgs_info import (
    build_imgs_info, get_coords_mask, imgs_info_slice, pad_imgs_info,
    random_crop, random_flip)
from neuray_tpu_torch.data.synthetic import make_query, make_sphere_scene
from neuray_tpu_torch.data.train_databases import scan_scene_names
from neuray_tpu_torch.data.view_select import compute_nearest_camera_indices


def select_train_ids_for_real_estate(img_ids, rng):
    """(query frame, <= 8 source frames) of a RealEstate10K clip: the
    sources drawn without replacement from the 64 frames before the
    query's + 32 (jittered by one frame), the query itself kept a
    candidate with probability 1%."""
    n = len(img_ids)
    que_i = rng.randint(4, n - 5)
    hi = min(que_i + 32 + rng.randint(-1, 2), n - 1)
    pool = np.arange(max(0, hi - 64), hi)
    if rng.random_sample() >= 0.01:
        pool = pool[pool != que_i]
    src_i = rng.choice(pool, size=min(8, pool.size), replace=False)
    ids = np.asarray(img_ids)
    return ids[que_i], ids[src_i]


def add_depth_offset(depth, mask, region_min, region_max, offset_min,
                     offset_max, noise_ratio, depth_length, rng):
    """Corrupt a random rectangle of masked depth pixels, in place: the
    rectangle centred on a random masked pixel, its half-sizes
    U(region_min, region_max) times the mask's bounding box; every masked
    pixel in it shifted by one +-U(offset_min, offset_max) * depth_length
    (the sign flipped with probability 0.5) plus its own
    U(-noise_ratio, noise_ratio) * depth_length."""
    ys, xs = np.nonzero(mask)
    if xs.size == 0:
        return
    k = rng.randint(0, xs.size)
    half_x, half_y = rng.uniform(region_min, region_max, 2) * (
        xs.max() - xs.min(), ys.max() - ys.min())
    inside = ((np.abs(xs - xs[k]) < half_x)
              & (np.abs(ys - ys[k]) < half_y))
    base = rng.uniform(offset_min, offset_max) * depth_length
    if rng.random_sample() < 0.5:
        base = -base
    noise = rng.uniform(-noise_ratio, noise_ratio, int(inside.sum()))
    depth[ys[inside], xs[inside]] += base + noise * depth_length


def build_src_imgs_info_select(database, ref_ids, ref_ids_all,
                               cost_volume_nn_num: int,
                               pad_interval: int = -1):
    """One imgs_info over the union of the selected ref views and each
    one's ``cost_volume_nn_num`` nearest views among ref_ids_all (itself
    left out), as the cost-volume init net takes them (reference
    train_dataset.py:44-64). Returns (the union's imgs_info, ref_cv_idx
    [rfn, nn] the source views' indices into the union, ref_real_idx
    [rfn] the ref views')."""
    order = compute_nearest_camera_indices(database, ref_ids, ref_ids_all)
    src_ids = np.asarray(ref_ids_all)[order[:, 1:1 + cost_volume_nn_num]]
    sel_ids = np.asarray(ref_ids)
    union_ids = np.unique(np.concatenate([src_ids.ravel(), sel_ids]))
    # np.unique sorts, so a view's place in the union is a searchsorted hit
    ref_real_idx = np.searchsorted(union_ids, sel_ids)
    ref_cv_idx = np.searchsorted(union_ids, src_ids)
    is_aligned = not database.database_name.startswith("space")
    union_info = build_imgs_info(database, list(union_ids), pad_interval,
                                 is_aligned, replace_none_depth=True)
    return union_info, ref_cv_idx, ref_real_idx


class GeneralRendererDataset:
    """Training samples from the mixture of dataset families (train: a
    family drawn by weight, a scene, a query view and its working views,
    the augmentations, the crop and flip of the forward-facing families,
    foreground-biased rays) or every query view of one val scene (eval),
    as the JAX package's ``GeneralRendererDataset`` makes them: one index
    and one seed draw the same sample from ``np.random.RandomState``."""

    default_cfg = {
        "train_database_types": ["dtu_train", "space", "real_iconic",
                                 "real_estate", "gso"],
        "type2sample_weights": {"gso": 20, "dtu_train": 20,
                                "real_iconic": 20, "space": 10,
                                "real_estate": 10},
        "val_database_name": "nerf_synthetic/lego/black_800",
        "val_database_split_type": "val",

        "min_wn": 8,
        "max_wn": 9,
        "ref_pad_interval": 16,
        "train_ray_num": 512,
        "foreground_ratio": 0.5,
        "resolution_type": "hr",
        "use_consistent_depth_range": True,
        "use_depth_loss_for_all": False,
        "use_depth": True,
        "use_src_imgs": False,
        "cost_volume_nn_num": 3,
        "depth_loss_coords_num": 8192,

        "aug_gso_shrink_range_prob": 0.5,
        "aug_depth_range_prob": 0.05,
        "aug_depth_range_min": 0.95,
        "aug_depth_range_max": 1.05,
        "aug_use_depth_offset": True,
        "aug_depth_offset_prob": 0.25,
        "aug_depth_offset_region_min": 0.05,
        "aug_depth_offset_region_max": 0.1,
        "aug_depth_offset_min": 0.5,
        "aug_depth_offset_max": 1.0,
        "aug_depth_offset_local": 0.1,
        "aug_use_depth_small_offset": True,
        "aug_use_global_noise": True,
        "aug_global_noise_prob": 0.5,
        "aug_depth_small_offset_prob": 0.5,
        "aug_forward_crop_size": (400, 600),
        "aug_pixel_center_sample": False,
        "aug_view_select_type": "easy",

        "use_consistent_min_max": False,
    }

    def __init__(self, cfg: Dict[str, Any], is_train: bool):
        self.cfg = {**self.default_cfg, **cfg}
        self.is_train = is_train
        if is_train:
            self.num = 999999
            self.type2scene_names = {}
            self.database_types, weights = [], []
            for dt in self.cfg["train_database_types"]:
                names = scan_scene_names(dt, self.cfg["resolution_type"])
                if not names:
                    continue  # dataset not on disk — skip its weight
                self.type2scene_names[dt] = names
                self.database_types.append(dt)
                weights.append(self.cfg["type2sample_weights"][dt])
            if not self.database_types:
                raise FileNotFoundError(
                    "no training datasets found on disk under "
                    "NEURAY_DATA_ROOT")
            w = np.asarray(weights, np.float64)
            self.database_weights = w / np.sum(w)
        else:
            self.database = parse_database_name(
                self.cfg["val_database_name"])
            self.ref_ids, self.que_ids = get_database_split(
                self.database, self.cfg["val_database_split_type"])
            self.num = len(self.que_ids)

    # ---------------- sampling ----------------

    def get_database_ref_que_ids(self, index, rng):
        """(database, query id, reference ids); a training scene with no
        view with depth is drawn again."""
        if not self.is_train:
            return self.database, self.que_ids[index], \
                np.asarray(self.ref_ids)
        while True:
            dt = rng.choice(self.database_types, 1, False,
                            p=self.database_weights)[0]
            scene = rng.choice(self.type2scene_names[dt])
            database = parse_database_name(scene)
            ref_ids = database.get_img_ids(check_depth_exist=True)
            if len(ref_ids) > 0:
                break
        que_id = rng.choice(ref_ids)
        if database.database_name.startswith("real_estate"):
            que_id, ref_ids = select_train_ids_for_real_estate(ref_ids, rng)
        return database, que_id, np.asarray(ref_ids)

    def select_working_views_impl(self, database_name, dist_idx, ref_num,
                                  rng):
        """The nearest views a family's working views are drawn from."""
        easy = self.cfg["aug_view_select_type"] == "easy"
        if database_name.startswith(("space", "real_estate")):
            pass
        elif database_name.startswith("gso"):
            pool_ratio = 3 if easy else rng.randint(1, 5)
            dist_idx = dist_idx[:min(ref_num * pool_ratio,
                                     24 if easy else 32)]
        elif database_name.startswith("real_iconic"):
            pool_ratio = rng.randint(1, 4) if easy else rng.randint(1, 5)
            dist_idx = dist_idx[:min(ref_num * pool_ratio,
                                     20 if easy else 32)]
        elif database_name.startswith("dtu_train"):
            pool_ratio = rng.randint(1, 3)
            dist_idx = dist_idx[:min(ref_num * pool_ratio, 12)]
        else:
            raise NotImplementedError(database_name)
        return dist_idx

    def select_working_views(self, database, que_id, ref_ids, rng):
        """The working views of the query among ref_ids."""
        name = database.database_name
        dist_idx = compute_nearest_camera_indices(
            database, [que_id], list(ref_ids))[0]
        if self.is_train:
            if rng.random_sample() > 0.02:  # else the query view may serve
                dist_idx = dist_idx[ref_ids[dist_idx] != que_id]
            ref_num = rng.randint(self.cfg["min_wn"], self.cfg["max_wn"])
            dist_idx = self.select_working_views_impl(
                name, dist_idx, ref_num, rng)
            if not name.startswith("real_estate"):
                rng.shuffle(dist_idx)
                return ref_ids[dist_idx[:ref_num]]
            return ref_ids[:ref_num]
        return ref_ids[dist_idx[:self.cfg["min_wn"]]]

    # ---------------- augmentation ----------------

    def depth_range_aug_for_gso(self, depth_range, depth, mask, rng):
        """GSO's depth ranges shrunk towards the views' depths (with
        probability aug_gso_shrink_range_prob), then widened a little;
        depth and mask [n, h, w, 1]."""
        new = depth_range.copy()
        if rng.random_sample() < self.cfg["aug_gso_shrink_range_prob"]:
            far_ratios, near_ratios = [], []
            for rfi in range(depth.shape[0]):
                dv = depth[rfi][mask[rfi].astype(bool)]
                dv = dv[(dv > 1e-3) & (dv < 1e4)]
                if dv.size == 0:
                    continue
                near, far = depth_range[rfi]
                far_ratios.append(np.max(dv) * 1.1 / far)
                near_ratios.append(near / (np.min(dv) * 0.9))
            if far_ratios:
                far_ratio, near_ratio = np.max(far_ratios), \
                    np.max(near_ratios)
                if far_ratio < 1.0:
                    new[:, 1] *= rng.uniform(far_ratio, 1.0)
                if near_ratio < 1.0:
                    new[:, 0] /= rng.uniform(near_ratio, 1.0)
        if rng.random_sample() < 0.8:
            ratio0, ratio1 = rng.uniform(0.025, 0.1, 2)
            new[:, 0] *= 1 - ratio0
            new[:, 1] *= 1 + ratio1
        return new

    def random_change_depth_range(self, depth_range, depth, mask, name,
                                  rng):
        """The depth ranges of a sample, augmented per family."""
        if name.startswith("gso"):
            return self.depth_range_aug_for_gso(depth_range, depth, mask,
                                                rng)
        new = depth_range.copy()
        if rng.random_sample() < self.cfg["aug_depth_range_prob"]:
            new[:, 0] *= rng.uniform(self.cfg["aug_depth_range_min"], 1.0)
            new[:, 1] *= rng.uniform(1.0, self.cfg["aug_depth_range_max"])
        return new

    def add_depth_noise(self, depths, masks, depth_ranges, rng):
        """GSO's reference depths with offsets and noise, [n, h, w, 1]."""
        c = self.cfg
        out = []
        for rfi in range(depths.shape[0]):
            depth = depths[rfi, :, :, 0].copy()
            mask = masks[rfi, :, :, 0]
            near, far = depth_ranges[rfi]
            length = far - near
            if c["aug_use_depth_offset"] and \
                    rng.random_sample() < c["aug_depth_offset_prob"]:
                add_depth_offset(
                    depth, mask, c["aug_depth_offset_region_min"],
                    c["aug_depth_offset_region_max"],
                    c["aug_depth_offset_min"], c["aug_depth_offset_max"],
                    c["aug_depth_offset_local"], length, rng)
            if c["aug_use_depth_small_offset"] and \
                    rng.random_sample() < c["aug_depth_small_offset_prob"]:
                add_depth_offset(depth, mask, 0.1, 0.2, 0.01, 0.05, 0.005,
                                 length, rng)
            if c["aug_use_global_noise"] and \
                    rng.random_sample() < c["aug_global_noise_prob"]:
                depth += rng.uniform(
                    -0.005, 0.005, depth.shape).astype(np.float32) * length
            out.append(depth)
        return np.asarray(out, np.float32)[..., None]

    def generate_coords_for_training(self, database, que_imgs_info, rng):
        """The query's training rays: foreground-biased, or drawn from the
        central 80% window for the forward-facing families with
        aug_pixel_center_sample."""
        name = database.database_name
        forward_facing = name.startswith(
            ("real_estate", "real_iconic", "space"))
        if forward_facing and self.cfg["aug_pixel_center_sample"]:
            h, w = que_imgs_info["masks"].shape[1:3]
            mask = np.zeros((h, w), bool)
            begin = 0.1  # central 80% window
            hb, he = int(h * begin), int(h * 0.9)
            wb, we = int(w * begin), int(w * 0.9)
            mask[hb:he, wb:we] = True
            coords = get_coords_mask(mask, self.cfg["train_ray_num"],
                                     0.9, rng)
        else:
            mask = que_imgs_info["masks"][0, :, :, 0] > 0
            coords = get_coords_mask(mask, self.cfg["train_ray_num"],
                                     self.cfg["foreground_ratio"], rng)
        return coords.reshape(1, -1, 2).astype(np.float32)

    def consistent_depth_range(self, ref_imgs_info, que_imgs_info):
        """One depth range length for the reference and query views."""
        dr = np.concatenate([ref_imgs_info["depth_range"],
                             que_imgs_info["depth_range"]], 0)
        if self.cfg["use_consistent_min_max"]:
            dr[:, 0] = np.min(dr)
            dr[:, 1] = np.max(dr)
        else:
            range_len = dr[:, 1] - dr[:, 0]
            max_len = np.max(range_len)
            margin = (max_len - range_len) / 2
            near = np.maximum(dr[:, 0] - margin, dr[:, 0] * 0.5)
            dr[:, 0] = near
            dr[:, 1] = near + max_len
        ref_imgs_info["depth_range"] = dr[:-1]
        que_imgs_info["depth_range"] = dr[-1:]

    # ---------------- assembly ----------------

    def __getitem__(self, index) -> Dict[str, Any]:
        seed = ((index + int(time.time())) if self.is_train else index) \
            % (2 ** 16)
        rng = np.random.RandomState(seed)
        c = self.cfg
        database, que_id, ref_ids_all = \
            self.get_database_ref_que_ids(index, rng)
        name = database.database_name
        ref_ids = self.select_working_views(database, que_id, ref_ids_all,
                                            rng)
        src_info = None
        if c["use_src_imgs"]:
            ref_imgs_info, ref_cv_idx, ref_real_idx = \
                build_src_imgs_info_select(database, ref_ids, ref_ids_all,
                                           c["cost_volume_nn_num"])
        else:
            ref_idx = compute_nearest_camera_indices(
                database, list(ref_ids))[:, 1:4]
            is_aligned = not name.startswith("space")
            ref_imgs_info = build_imgs_info(database, list(ref_ids), -1,
                                            is_aligned,
                                            replace_none_depth=True)
        que_imgs_info = build_imgs_info(database, [que_id],
                                        has_depth=self.is_train,
                                        replace_none_depth=True)

        if self.is_train:
            dr_all = np.concatenate([ref_imgs_info["depth_range"],
                                     que_imgs_info["depth_range"]], 0)
            if name.startswith("gso"):
                depth_all = np.concatenate(
                    [ref_imgs_info["depth"], que_imgs_info["depth"]], 0)
                mask_all = np.concatenate(
                    [ref_imgs_info["masks"], que_imgs_info["masks"]], 0)
            else:
                depth_all, mask_all = None, None
            dr_all = self.random_change_depth_range(
                dr_all, depth_all, mask_all, name, rng)
            ref_imgs_info["depth_range"] = dr_all[:-1]
            que_imgs_info["depth_range"] = dr_all[-1:]

            if name.startswith("gso") and c["use_depth"]:
                aug = self.add_depth_noise(
                    ref_imgs_info["depth"], ref_imgs_info["masks"],
                    ref_imgs_info["depth_range"], rng)
                ref_imgs_info["true_depth"] = ref_imgs_info["depth"]
                ref_imgs_info["depth"] = aug

            if name.startswith(("real_estate", "real_iconic", "space")):
                ref_imgs_info, que_imgs_info = random_crop(
                    ref_imgs_info, que_imgs_info,
                    c["aug_forward_crop_size"], rng)
                if rng.random_sample() < 0.5:
                    ref_imgs_info, que_imgs_info = random_flip(
                        ref_imgs_info, que_imgs_info)

            if c["use_depth_loss_for_all"] and c["use_depth"] and \
                    not name.startswith("gso"):
                ref_imgs_info["true_depth"] = ref_imgs_info["depth"]

        if c["use_consistent_depth_range"]:
            self.consistent_depth_range(ref_imgs_info, que_imgs_info)

        if self.is_train:
            coords = self.generate_coords_for_training(
                database, que_imgs_info, rng)
        else:
            h, w = que_imgs_info["imgs"].shape[1:3]
            coords = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
            coords = coords.reshape(1, -1, 2).astype(np.float32)
        que_imgs_info["coords"] = coords
        ref_imgs_info = pad_imgs_info(ref_imgs_info, c["ref_pad_interval"])

        if not c["use_depth"]:
            for k in ("depth", "true_depth"):
                ref_imgs_info.pop(k, None)
            que_imgs_info.pop("depth", None)

        if c["use_src_imgs"]:
            src_info = {k: ref_imgs_info[k] for k in
                        ("imgs", "poses", "Ks", "depth_range")}
            ref_imgs_info = imgs_info_slice(ref_imgs_info, ref_real_idx)
            ref_imgs_info["nn_ids"] = ref_cv_idx.astype(np.int64)
        else:
            ref_imgs_info["nn_ids"] = ref_idx.astype(np.int64)

        # host-only keys stay on the host
        que_imgs_info.pop("masks", None)
        que_imgs_info.pop("depth", None)
        ref_imgs_info.pop("masks", None)

        sample = {"ref": ref_imgs_info, "que": que_imgs_info,
                  "scene_name": name,
                  "is_gso": np.asarray(
                      float(name.startswith("gso")), np.float32)}
        if src_info is not None:
            sample["src"] = src_info
        if self.is_train and "true_depth" in ref_imgs_info:
            rfn, h, w = ref_imgs_info["imgs"].shape[:3]
            pn = c["depth_loss_coords_num"]
            xs = rng.randint(0, w, (rfn, pn))
            ys = rng.randint(0, h, (rfn, pn))
            sample["depth_loss_coords"] = np.stack(
                [xs, ys], -1).astype(np.float32)
        return sample

    def __len__(self):
        return self.num


class FinetuningRendererDataset:
    """Indices only: finetuning's data lives in ``FtRenderer``."""

    default_cfg = {
        "database_name": "nerf_synthetic/lego/black_800",
        "database_split": "val_all",
    }

    def __init__(self, cfg: Dict[str, Any], is_train: bool):
        self.cfg = {**self.default_cfg, **cfg}
        self.is_train = is_train
        self.train_ids, self.val_ids = get_database_split(
            parse_database_name(self.cfg["database_name"]),
            self.cfg["database_split"])

    def __getitem__(self, index):
        return {"index": index}

    def __len__(self):
        return 99999999 if self.is_train else len(self.val_ids)


class SyntheticRendererDataset:
    """Sample ``index``: rfn reference views of the unit sphere at h x w
    with their exact depth as ``true_depth``, one query view (train:
    ``train_ray_num`` random pixels; eval: the full image) and
    ``depth_loss_coords_num`` random pixels per reference view for the
    depth loss, all drawn from ``RandomState(index % 2**16)``."""

    default_cfg = {
        "rfn": 3,
        "h": 32,
        "w": 32,
        "train_ray_num": 64,
        "depth_loss_coords_num": 16,
        "num": 1024,
    }

    def __init__(self, cfg: Dict[str, Any], is_train: bool):
        self.cfg = {**self.default_cfg, **cfg}
        self.is_train = is_train

    def __getitem__(self, index) -> Dict[str, Any]:
        c = self.cfg
        rng = np.random.RandomState(index % (2 ** 16))
        ref = make_sphere_scene(rng, c["rfn"], c["h"], c["w"])
        ref["true_depth"] = ref["depth"]
        que = make_query(rng, c["h"], c["w"], c["train_ray_num"],
                         full_image=not self.is_train)
        xs = rng.randint(0, c["w"], (c["rfn"], c["depth_loss_coords_num"]))
        ys = rng.randint(0, c["h"], (c["rfn"], c["depth_loss_coords_num"]))
        return {"ref": ref, "que": que,
                "depth_loss_coords": np.stack([xs, ys], -1).astype(
                    np.float32),
                "is_gso": np.zeros([], np.float32),
                "scene_name": "synthetic/sphere"}

    def __len__(self):
        return self.cfg["num"]


name2dataset = {
    "gen": GeneralRendererDataset,
    "ft": FinetuningRendererDataset,
    "synthetic": SyntheticRendererDataset,
}
