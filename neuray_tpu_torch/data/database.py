"""Scene databases (port of ``neuray_tpu/data/database.py``; reference
dataset/database.py): ``BaseDatabase``, the test-time families
(``nerf_synthetic``, ``llff_colmap`` with its ``cache/<res>`` JPEG cache,
``dtu_test``, ``example``), the ``<dataset>/<scene>/<setting>`` names of
``parse_database_name`` over these and the training families of
``data/train_databases.py``, and the val/test splits of
``get_database_split``.

Images are returned [h, w, 3] uint8, masks [h, w] bool, poses [3, 4]
OpenCV world->cam, Ks [3, 3]. Files are read and written with
``utils/imageio.py`` (PNG and baseline JPEG; the card's machine has no
cv2), resized with ``data/image_ops.py``'s numpy copies of cv2's resizes.
``DATA_ROOT`` is read when a database is built, so a caller may point it
elsewhere.
"""
from __future__ import annotations

import abc
import glob
import json
import os
import pickle
import random
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from neuray_tpu_torch.data import colmap_io
from neuray_tpu_torch.data.image_ops import (
    decompose_projection_matrix, downsample_gaussian_blur, resize_area,
    resize_img, resize_linear, resize_nearest)
from neuray_tpu_torch.utils.imageio import imread as _imread
from neuray_tpu_torch.utils.imageio import imwrite as _imsave

DATA_ROOT = os.environ.get("NEURAY_DATA_ROOT", "data")


class BaseDatabase(abc.ABC):
    def __init__(self, database_name: str):
        self.database_name = database_name

    @abc.abstractmethod
    def get_image(self, img_id):
        ...

    @abc.abstractmethod
    def get_K(self, img_id):
        ...

    @abc.abstractmethod
    def get_pose(self, img_id):
        ...

    @abc.abstractmethod
    def get_img_ids(self, check_depth_exist=False):
        ...

    @abc.abstractmethod
    def get_depth(self, img_id):
        ...

    @abc.abstractmethod
    def get_mask(self, img_id):
        ...

    @abc.abstractmethod
    def get_depth_range(self, img_id):
        ...


class NeRFSyntheticDatabase(BaseDatabase):
    """nerf_synthetic/<scene>/<background>_<size>, background black or
    white; ids ``<split>-r_<i>`` over the train, val and test splits."""

    def __init__(self, database_name: str):
        super().__init__(database_name)
        _, model_name, background_size = database_name.split("/")
        background, size = background_size.split("_")
        self.model_name = model_name
        self.img_size = int(size)
        self.background = background
        self.root_dir = f"{DATA_ROOT}/nerf_synthetic/{model_name}"

        self.img_ids, self.poses = [], []
        K = None
        for split in ("train", "val", "test"):
            ids, poses, K = self._parse_info(split)
            self.img_ids += ids
            self.poses += poses
        ratio = self.img_size / 800
        self.K = np.diag([ratio, ratio, 1.0]).astype(np.float32) @ K
        self.range_dict = {i: np.asarray((2.0, 6.0), np.float32)
                           for i in self.img_ids}
        self.depth_img_ids = [i for i in self.img_ids
                              if os.path.exists(self._depth_path(i))]

    def _parse_info(self, split):
        with open(f"{self.root_dir}/transforms_{split}.json") as f:
            info = json.load(f)
        focal_angle = float(info["camera_angle_x"])
        img_ids, poses = [], []
        for frame in info["frames"]:
            img_ids.append("-".join(frame["file_path"].split("/")[1:]))
            # cam->world OpenGL -> world->cam OpenCV
            pose = np.asarray(frame["transform_matrix"], np.float32)
            R = pose[:3, :3].T
            t = -R @ pose[:3, 3:]
            flip = np.diag(np.asarray([1, -1, -1], np.float32))
            poses.append(np.concatenate([flip @ R, flip @ t], 1))
        h, w = _imread(
            f"{self.root_dir}/{self._img_path(img_ids[0])}.png").shape[:2]
        focal = 0.5 * w / np.tan(0.5 * focal_angle)
        K = np.asarray([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                       np.float32)
        return img_ids, poses, K

    @staticmethod
    def _img_path(img_id):
        return "/".join(img_id.split("-"))

    def _depth_path(self, img_id):
        return f"{self.root_dir}/colmap_depth/{img_id}.png.geometric.bin"

    def get_image(self, img_id):
        img = _imread(f"{self.root_dir}/{self._img_path(img_id)}.png")
        alpha = img[:, :, 3:].astype(np.float32) / 255.0
        img = img[:, :, :3].astype(np.float32) / 255.0
        if self.background == "black":
            img = img * alpha
        elif self.background == "white":
            img = img * alpha + 1.0 - alpha
        else:
            raise NotImplementedError(self.background)
        img = np.clip(img * 255, 0, 255).astype(np.uint8)
        if self.img_size != 800:
            img = resize_img(img, self.img_size / 800)
        return img

    def get_K(self, img_id):
        return self.K.astype(np.float32).copy()

    def get_pose(self, img_id):
        return self.poses[self.img_ids.index(img_id)].astype(np.float32).copy()

    def get_img_ids(self, check_depth_exist=False):
        return self.depth_img_ids if check_depth_exist else self.img_ids

    def get_depth(self, img_id):
        fn = self._depth_path(img_id)
        if not os.path.exists(fn):
            return None
        depth = colmap_io.read_array(fn)
        if self.img_size != 800:
            depth = resize_nearest(depth, (self.img_size, self.img_size))
        return depth

    def get_mask(self, img_id):
        alpha = _imread(
            f"{self.root_dir}/{self._img_path(img_id)}.png")[:, :, 3]
        if self.img_size != 800:
            alpha = resize_nearest(alpha, (self.img_size, self.img_size))
        return alpha > 0

    def get_depth_range(self, img_id):
        return self.range_dict[img_id].copy()


class LLFFColmapDatabase(BaseDatabase):
    """llff_colmap/<scene>/<high|low>: a COLMAP sparse model
    (``sparse/{cameras,images}.bin``), the original images in
    ``images/``, ``depth_range.npy`` and dense depths in
    ``colmap_depth/<id>.jpg.geometric.bin``. The first build writes each
    image blurred and reduced (INTER_AREA) to 1008x756 (high) or 504x378
    (low) into ``cache/<res>/`` under its own name (a JPEG for a .jpg),
    which later builds reuse."""

    def __init__(self, database_name: str):
        super().__init__(database_name)
        _, self.model_name, self.res_type = database_name.split("/")
        self.root_dir = f"{DATA_ROOT}/llff_colmap/{self.model_name}"
        self.cameras = colmap_io.read_cameras_binary(
            f"{self.root_dir}/sparse/cameras.bin")
        self.images = colmap_io.read_images_binary(
            f"{self.root_dir}/sparse/images.bin")
        self.img_ids = [str(k + 1) for k in range(len(self.images))]
        self._cache_resolution()
        self.bounds = np.load(f"{self.root_dir}/depth_range.npy")

    def get_resolution(self):
        if self.res_type == "high":
            return 756, 1008
        if self.res_type == "low":
            return 756 // 2, 1008 // 2
        raise NotImplementedError(self.res_type)

    def _cache_resolution(self):
        self.image_dir = f"{self.root_dir}/cache/{self.res_type}"
        Path(self.image_dir).mkdir(exist_ok=True, parents=True)
        h, w = self.get_resolution()
        ratio = w / 4032

        def cache(fn):
            img = _imread(f"{self.root_dir}/images/{fn}")
            img = downsample_gaussian_blur(img, ratio)
            _imsave(f"{self.image_dir}/{fn}", resize_area(img, (w, h)))

        todo = [self.images[int(i)].name for i in self.img_ids]
        todo = [fn for fn in todo if not os.path.exists(
            f"{self.image_dir}/{fn}")]
        # the codecs and numpy's large operations release the interpreter
        # lock, so the views are reduced side by side
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            for done in [pool.submit(cache, fn) for fn in todo]:
                done.result()

    def get_image(self, img_id):
        fn = self.images[int(img_id)].name
        return _imread(f"{self.image_dir}/{fn}")

    def get_K(self, img_id):
        cam = self.cameras[self.images[int(img_id)].camera_id]
        h, w = self.get_resolution()
        fx, fy, cx, cy = cam.params[:4]
        K = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        K = np.diag([w / cam.width, h / cam.height, 1]) @ K
        return K.astype(np.float32)

    def get_pose(self, img_id):
        return self.images[int(img_id)].pose34().astype(np.float32)

    def get_img_ids(self, check_depth_exist=False):
        return self.img_ids

    def get_depth(self, img_id):
        return colmap_io.read_array(
            f"{self.root_dir}/colmap_depth/{img_id}.jpg.geometric.bin")

    def get_mask(self, img_id):
        h, w = self.get_resolution()
        return np.ones([h, w], dtype=bool)

    def get_depth_range(self, img_id):
        return self.bounds[int(img_id) - 1]


def idr_camera(cams, i: int, flip: np.ndarray):
    """(K [3, 3] with K[2, 2] = 1, world->cam pose [3, 4]) of view i of
    an IDR-style ``cameras.npz`` (``world_mat_<i>``, optional
    ``scale_mat_<i>``), in the OpenCV frame after ``flip``."""
    P = cams["world_mat_" + str(i)][:3]
    K, R, t = decompose_projection_matrix(P)
    K = K / K[2, 2]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.transpose()
    pose[:3, 3] = (t[:3] / t[3])[:, 0]
    scale_mtx = cams.get("scale_mat_" + str(i))
    if scale_mtx is not None:
        pose[:3, 3:] -= scale_mtx[:3, 3:]
        pose[:3, 3:] /= np.diagonal(scale_mtx[:3, :3])[..., None]
    pose = (flip @ pose)[:3]
    return K, np.concatenate([pose[:, :3].T, -pose[:, :3].T @ pose[:, 3:]], 1)


class DTUTestDatabase(BaseDatabase):
    """dtu_test/<scene>/<background>_<size>: IDR-style ``cameras.npz``,
    images ``image/<id:06>.png`` at 1600x1200 resized to size wide, masks
    ``mask/<id:03>.png``, ``depth_range.npy``, dense depths in
    ``colmap_depth/``; background black only."""

    def __init__(self, database_name: str):
        super().__init__(database_name)
        _, model_name, background_size = database_name.split("/")
        background, image_size = background_size.split("_")
        self.root_dir = f"{DATA_ROOT}/dtu_test/{model_name}"
        self.background = background
        image_size = int(image_size)
        self.ratio = image_size / 1600
        self.h, self.w = int(self.ratio * 1200), image_size

        flip = np.diag([1, -1, -1, 1]).astype(np.float32)
        rgb_paths = sorted(
            x for x in glob.glob(os.path.join(self.root_dir, "image", "*"))
            if x.endswith((".jpg", ".png")))
        self.depth_range = np.load(f"{self.root_dir}/depth_range.npy")
        all_cam = np.load(os.path.join(self.root_dir, "cameras.npz"))
        self.Ks, self.Rts, self.img_ids = [], [], []
        for i, _ in enumerate(rgb_paths):
            K, pose = idr_camera(all_cam, i, flip)
            self.Ks.append(np.diag([self.ratio, self.ratio, 1]) @ K)
            self.Rts.append(pose[:3])
            self.img_ids.append(f"{i}")
        self._img_cache, self._mask_cache, self._depth_cache = {}, {}, {}

    def get_image(self, img_id):
        if img_id not in self._img_cache:
            img = _imread(
                os.path.join(self.root_dir, "image", f"{int(img_id):06}.png"))
            if self.w != 1600:
                img = resize_linear(downsample_gaussian_blur(img, self.ratio),
                                    (self.w, self.h))
            if self.background != "black":
                raise NotImplementedError(self.background)
            img = img * self.get_mask(img_id).astype(np.uint8)[:, :, None]
            self._img_cache[img_id] = img
        return self._img_cache[img_id]

    def get_K(self, img_id):
        return self.Ks[int(img_id)].astype(np.float32).copy()

    def get_pose(self, img_id):
        return self.Rts[int(img_id)].astype(np.float32).copy()

    def get_img_ids(self, check_depth_exist=False):
        return self.img_ids

    def get_depth(self, img_id):
        if img_id not in self._depth_cache:
            fn = f"{self.root_dir}/colmap_depth/{img_id}.jpg.geometric.bin"
            depth = np.ascontiguousarray(
                colmap_io.read_array(fn), dtype=np.float32)
            if self.w != 800:
                depth = resize_nearest(depth, (self.w, self.h))
            depth[~self.get_mask(img_id)] = 0
            self._depth_cache[img_id] = depth
        return self._depth_cache[img_id]

    def get_mask(self, img_id):
        if img_id not in self._mask_cache:
            mask = np.sum(_imread(os.path.join(
                self.root_dir, "mask", f"{int(img_id):03}.png")), -1) > 0
            if self.w != 1600:
                mask = resize_nearest(mask.astype(np.uint8),
                                      (self.w, self.h)) > 0
            self._mask_cache[img_id] = mask
        return self._mask_cache[img_id]

    def get_depth_range(self, img_id):
        return self.depth_range.copy()


class ExampleDatabase(BaseDatabase):
    """example/<scene>/<resolution|raw>: a custom scene run through COLMAP
    (``sparse/0`` or ``colmap/sparse/0``, images in ``images/``, optional
    dense depths); each view's depth range the 2nd/98th percentiles of
    the sparse points' depths widened by 0.8x/1.2x (cached to
    ``depth_range.pkl``); with a resolution, the longest side resized to
    it."""

    def __init__(self, database_name: str):
        super().__init__(database_name)
        parts = database_name.split("/")
        self.scene_name = parts[1]
        self.resolution = parts[2] if len(parts) > 2 else "raw"
        self.root_dir = f"{DATA_ROOT}/example/{self.scene_name}"
        sparse = f"{self.root_dir}/sparse/0"
        if not os.path.exists(sparse):
            sparse = f"{self.root_dir}/colmap/sparse/0"
        self._sparse_dir = sparse
        self.cameras = colmap_io.read_cameras_binary(f"{sparse}/cameras.bin")
        self.images = colmap_io.read_images_binary(f"{sparse}/images.bin")
        self.img_ids = [str(k) for k in sorted(self.images.keys())]
        if self.resolution != "raw":
            first = self.images[int(self.img_ids[0])].name
            h, w = _imread(f"{self.root_dir}/images/{first}").shape[:2]
            self.ratio = int(self.resolution) / max(h, w)
        else:
            self.ratio = 1.0
        self._depth_ranges = self._compute_depth_ranges()

    def _compute_depth_ranges(self):
        cache = f"{self.root_dir}/depth_range.pkl"
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)
        pts = colmap_io.read_points3d_binary(
            f"{self._sparse_dir}/points3D.bin")
        points = np.asarray([v.xyz for v in pts.values()], np.float32)
        ranges = {}
        for img_id in self.img_ids:
            pose = self.get_pose(img_id)
            z = (pose[:, :3] @ points.T + pose[:, 3:])[2]
            far = np.percentile(z.flatten(), 98) * 1.2
            near = np.percentile(z.flatten(), 2) * 0.8
            ranges[img_id] = np.asarray([near, far], np.float32)
        try:
            with open(cache, "wb") as f:
                pickle.dump(ranges, f)
        except OSError:
            pass                # a read-only scene: the ranges stay unsaved
        return ranges

    def _name(self, img_id):
        return self.images[int(img_id)].name

    def get_image(self, img_id):
        img = _imread(f"{self.root_dir}/images/{self._name(img_id)}")[..., :3]
        if self.resolution != "raw":
            img = resize_img(img, self.ratio)
        return img

    def get_K(self, img_id):
        K = self.cameras[
            self.images[int(img_id)].camera_id].K().astype(np.float32)
        if self.resolution != "raw":
            K = (np.diag([self.ratio, self.ratio, 1.0]) @ K).astype(
                np.float32)
        return K

    def get_pose(self, img_id):
        return self.images[int(img_id)].pose34().astype(np.float32)

    def get_img_ids(self, check_depth_exist=False):
        if check_depth_exist:
            return [i for i in self.img_ids
                    if self._depth_path(i) is not None]
        return self.img_ids

    def _depth_path(self, img_id):
        name = self._name(img_id)
        for base in ("dense", "colmap/dense"):
            fn = (f"{self.root_dir}/{base}/stereo/depth_maps/"
                  f"{name}.geometric.bin")
            if os.path.exists(fn):
                return fn
        return None

    def get_depth(self, img_id):
        fn = self._depth_path(img_id)
        if fn is None:
            return None
        depth = colmap_io.read_array(fn).astype(np.float32)
        if self.resolution != "raw":
            h, w = depth.shape
            depth = resize_nearest(
                depth, (int(w * self.ratio), int(h * self.ratio)))
        return depth

    def get_mask(self, img_id):
        img = self.get_image(img_id)
        return np.ones(img.shape[:2], dtype=bool)

    def get_depth_range(self, img_id):
        return self._depth_ranges[img_id].copy()


name2database = {
    "nerf_synthetic": NeRFSyntheticDatabase,
    "llff_colmap": LLFFColmapDatabase,
    "dtu_test": DTUTestDatabase,
    "example": ExampleDatabase,
}


def parse_database_name(database_name: str) -> BaseDatabase:
    """``<dataset>/<scene>/<setting>`` -> the database, of the families
    above or of ``data/train_databases.py``."""
    from neuray_tpu_torch.data.train_databases import name2database_train
    dataset_type = database_name.split("/")[0]
    families = {**name2database, **name2database_train}
    if dataset_type in families:
        return families[dataset_type](database_name)
    raise NotImplementedError(f"unknown dataset type {dataset_type}")


# fixed NeRF-synthetic validation views (reference asset.py:46)
nerf_syn_val_ids = ["val-r_39", "val-r_2", "val-r_94", "val-r_62",
                    "val-r_23", "val-r_36"]


def get_database_split(database: BaseDatabase, split_type: str = "val"):
    """(ref_ids, que_ids) of a split. 'val' and 'test' keep the reference
    views that have depth, the '_all' suffix ('val_all', 'test_all') every
    one; 'example_<n>' holds out n views shuffled by ``random.seed(1234)``
    (the global generator, as the JAX package draws them)."""
    name = database.database_name
    if split_type.startswith("val") or split_type.startswith("test"):
        splits = split_type.split("_")
        depth_valid = not (len(splits) > 1 and splits[1] == "all")
        if name.startswith("nerf_synthetic"):
            ref_ids = [i for i in database.get_img_ids(depth_valid)
                       if i.startswith("tr")]
            if split_type.startswith("test"):
                que_ids = [i for i in database.get_img_ids()
                           if i.startswith("te")]
            else:
                que_ids = list(nerf_syn_val_ids)
            return ref_ids, que_ids
        if name.startswith("dtu_test"):
            que_ids = database.get_img_ids()[3:-3:8]
        else:
            que_ids = database.get_img_ids()[::8]
        ref_ids = [i for i in database.get_img_ids(depth_valid)
                   if i not in set(que_ids)]
        return ref_ids, que_ids
    if split_type.startswith("example"):
        _, split_num = split_type.split("_")
        ref_ids = list(database.get_img_ids())
        random.seed(1234)
        random.shuffle(ref_ids)
        return ref_ids[int(split_num):], ref_ids[:int(split_num)]
    raise NotImplementedError(split_type)
