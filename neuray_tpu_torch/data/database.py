"""Scene databases (port of ``neuray_tpu/data/database.py``; reference
dataset/database.py): ``BaseDatabase``, the NeRF-synthetic family, the
``<dataset>/<scene>/<setting>`` names of ``parse_database_name`` and the
val/test splits of ``get_database_split``.

Images are returned [h, w, 3] uint8, masks [h, w] bool, poses [3, 4]
OpenCV world->cam, Ks [3, 3]. PNGs are read with ``utils/png.py`` (the
card's machine has no cv2). ``DATA_ROOT`` is read when a database is
built, so a caller may point it elsewhere.

Only ``nerf_synthetic`` at its native 800x800 is ported: a smaller size
needs cv2's Gaussian blur and linear resize, and the other families
(``llff_colmap``, ``dtu_test``, ``example`` and the training databases)
wait for ROADMAP item 8f.
"""
from __future__ import annotations

import abc
import json
import os

import numpy as np

from neuray_tpu_torch.data import colmap_io
from neuray_tpu_torch.utils.png import read_png

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
        if self.img_size != 800:
            raise NotImplementedError(
                f"{database_name}: NeRF-synthetic at size {size}: the resize "
                "(cv2's Gaussian blur and linear resize) is not ported yet "
                "(ROADMAP item 8f); only 800")
        self.background = background
        self.root_dir = f"{DATA_ROOT}/nerf_synthetic/{model_name}"

        self.img_ids, self.poses = [], []
        K = None
        for split in ("train", "val", "test"):
            ids, poses, K = self._parse_info(split)
            self.img_ids += ids
            self.poses += poses
        self.K = K
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
        h, w = read_png(
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
        img = read_png(f"{self.root_dir}/{self._img_path(img_id)}.png")
        alpha = img[:, :, 3:].astype(np.float32) / 255.0
        img = img[:, :, :3].astype(np.float32) / 255.0
        if self.background == "black":
            img = img * alpha
        elif self.background == "white":
            img = img * alpha + 1.0 - alpha
        else:
            raise NotImplementedError(self.background)
        return np.clip(img * 255, 0, 255).astype(np.uint8)

    def get_K(self, img_id):
        return self.K.astype(np.float32).copy()

    def get_pose(self, img_id):
        return self.poses[self.img_ids.index(img_id)].astype(np.float32).copy()

    def get_img_ids(self, check_depth_exist=False):
        return self.depth_img_ids if check_depth_exist else self.img_ids

    def get_depth(self, img_id):
        fn = self._depth_path(img_id)
        return colmap_io.read_array(fn) if os.path.exists(fn) else None

    def get_mask(self, img_id):
        img = read_png(f"{self.root_dir}/{self._img_path(img_id)}.png")
        return img[:, :, 3] > 0

    def get_depth_range(self, img_id):
        return self.range_dict[img_id].copy()


name2database = {"nerf_synthetic": NeRFSyntheticDatabase}
# the JAX package's other families, ported with the training datasets
_NOT_PORTED = ("llff_colmap", "dtu_test", "example", "gso", "dtu_train",
               "real_iconic", "real_estate", "space", "blended_mvs")


def parse_database_name(database_name: str) -> BaseDatabase:
    """``<dataset>/<scene>/<setting>`` -> the database."""
    dataset_type = database_name.split("/")[0]
    if dataset_type in name2database:
        return name2database[dataset_type](database_name)
    if dataset_type in _NOT_PORTED:
        raise NotImplementedError(f"dataset type {dataset_type} is not "
                                  "ported yet (ROADMAP item 8f)")
    raise NotImplementedError(f"unknown dataset type {dataset_type}")


# fixed NeRF-synthetic validation views (reference asset.py:46)
nerf_syn_val_ids = ["val-r_39", "val-r_2", "val-r_94", "val-r_62",
                    "val-r_23", "val-r_36"]


def get_database_split(database: BaseDatabase, split_type: str = "val"):
    """(ref_ids, que_ids) of a val or test split. 'val' and 'test' keep
    the reference views that have depth; the '_all' suffix ('val_all',
    'test_all') keeps every one. The 'example_<n>' split waits for the
    example database (ROADMAP item 8f)."""
    name = database.database_name
    if not (split_type.startswith("val") or split_type.startswith("test")):
        raise NotImplementedError(split_type)
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
    else:
        raise NotImplementedError(f"splits of {name} (ROADMAP item 8f)")
    return ref_ids, que_ids
