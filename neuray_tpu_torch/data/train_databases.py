"""The training-set databases (port of
``neuray_tpu/data/train_databases.py``; reference dataset/database.py and
asset.py): Google Scanned Objects, DTU-train, RealIconic (LLFF
captures), Spaces, RealEstate10K and BlendedMVS, and ``scan_scene_names``,
which lists each family's scenes on disk.

Every path is resolved under ``database.DATA_ROOT``, read when a database
is built. Files go through ``utils/imageio.py`` and resizes through
``data/image_ops.py`` (the JAX package calls cv2 for both).
"""
from __future__ import annotations

import glob
import os
import pickle
import re

import numpy as np

from neuray_tpu_torch.data import colmap_io
from neuray_tpu_torch.data import database as _db
from neuray_tpu_torch.data.database import BaseDatabase, _imread, idr_camera
from neuray_tpu_torch.data.image_ops import (
    resize_area, resize_img, resize_nearest)


def _root() -> str:
    return _db.DATA_ROOT


def _read_clipped_depth(fn, far):
    if not os.path.exists(fn):
        return None
    depth = colmap_io.read_array(fn)
    return np.clip(depth, a_min=1e-5, a_max=far)


class GoogleScannedObjectDatabase(BaseDatabase):
    """gso/<model>/<background>_<resolution>: 250 views of an object at
    512x512 (``rgb/``, ``mask/``, 16-bit ``depth/`` in mm, 4x4
    ``intrinsics/`` and camera-to-world ``pose/`` txts); resolution 'raw'
    or a size to resize to."""

    def __init__(self, database_name: str):
        super().__init__(database_name)
        _, model_name, background_resolution = database_name.split("/")
        background, resolution = background_resolution.split("_")
        if background not in ("black", "white"):
            raise NotImplementedError(f"{database_name}: background "
                                      f"{background}")
        self.resolution = resolution
        self.background = background
        self.prefix = f"{_root()}/google_scanned_objects/{model_name}"

        range_fn = f"{self.prefix}/depth_range.pkl"
        if os.path.exists(range_fn):
            with open(range_fn, "rb") as f:
                self.range_dict = pickle.load(f)
        else:
            # from the camera's distance to the object at the origin
            self.range_dict = {}
            for img_id in self.get_img_ids():
                origin_depth = self.get_pose(img_id)[2, 3]
                max_radius = 0.5 * np.sqrt(2) * 1.1
                near = max(origin_depth - max_radius, 0.1 * origin_depth)
                far = origin_depth + max_radius
                self.range_dict[img_id] = np.asarray([near, far],
                                                     np.float32)
            try:
                with open(range_fn, "wb") as f:
                    pickle.dump(self.range_dict, f)
            except OSError:
                pass        # a read-only scene: the ranges stay unsaved

    def _mask_raw(self, img_id):
        return _imread(f"{self.prefix}/mask/{int(img_id):06}.png") > 0

    def get_image(self, img_id):
        img = _imread(f"{self.prefix}/rgb/{int(img_id):06}.png")[:, :, :3]
        if self.background == "black":
            img = img.copy()
            img[~self._mask_raw(img_id)] = 0
        if self.resolution != "raw":
            img = resize_img(img, int(self.resolution) / 512)
        return img

    def get_K(self, img_id):
        K = np.loadtxt(
            f"{self.prefix}/intrinsics/{int(img_id):06}.txt").reshape(
            [4, 4])[:3, :3]
        if self.resolution != "raw":
            ratio = int(self.resolution) / 512
            K = np.diag([ratio, ratio, 1.0]) @ K
        return K.astype(np.float32)

    def get_pose(self, img_id):
        pose = np.loadtxt(
            f"{self.prefix}/pose/{int(img_id):06}.txt").reshape([4, 4])[:3]
        R = pose[:3, :3].T  # stored camera-to-world
        t = R @ -pose[:3, 3:]
        return np.concatenate([R, t], -1).astype(np.float32)

    def get_img_ids(self, check_depth_exist=False):
        return [str(i) for i in range(250)]

    def get_depth(self, img_id):
        depth = _imread(f"{self.prefix}/depth/{int(img_id):06}.png")
        depth = np.asarray(depth, np.float32) / 1000.0
        depth[~self._mask_raw(img_id)] = 0
        if self.resolution != "raw":
            res = int(self.resolution)
            depth = resize_nearest(depth, (res, res))
        return depth

    def get_mask(self, img_id):
        mask = self._mask_raw(img_id)
        if mask.ndim == 3:
            mask = mask.any(-1)
        if self.resolution != "raw":
            res = int(self.resolution)
            mask = resize_nearest(mask.astype(np.uint8), (res, res)) > 0
        return mask

    def get_depth_range(self, img_id):
        return self.range_dict[img_id].copy()


class RealIconicDatabase(BaseDatabase):
    """real_iconic/<model>/<factor>: an LLFF capture (``images/``,
    ``poses_bounds.npy``) reduced by factor, its poses rescaled and
    recentered and turned from OpenGL to OpenCV; dense depths from
    ``colmap_forward_cache/``."""

    def __init__(self, database_name: str):
        super().__init__(database_name)
        from neuray_tpu_torch.data.llff import load_llff_data
        _, model_name, factor = database_name.split("/")
        self.factor = int(factor)
        self.images, poses, bds, _, i_test = load_llff_data(
            f"{_root()}/real_iconic_noface/{model_name}", self.factor,
            recenter=True, bd_factor=0.75)
        h, w, focal = poses[0, :3, -1]
        self.K = np.asarray([[focal, 0, w / 2], [0, focal, h / 2],
                             [0, 0, 1]], np.float32)
        self.poses = []
        flip = np.diag(np.asarray([1, -1, -1], np.float64))
        for pose in poses[:, :3, :4]:
            R = pose[:3, :3].T
            t = R @ -pose[:3, 3:]
            self.poses.append(np.concatenate(
                [flip @ R, flip @ t], 1).astype(np.float32))
        self.img_ids = [str(k) for k in range(len(self.images))]
        self.test_img_ids = [str(i_test)]
        self.range_dict = {str(k): np.asarray(bds[k], np.float32)
                           for k in range(len(bds))}
        self.depth_img_ids = [i for i in self.img_ids
                              if os.path.exists(self._depth_fn(i))]

    def _depth_fn(self, img_id):
        ext = "png" if self.factor == 8 else "jpg"
        return (f"{_root()}/colmap_forward_cache/{self.database_name}"
                f"/dense_out/stereo/depth_maps/{img_id}.{ext}.geometric.bin")

    def get_image(self, img_id):
        return self.images[int(img_id)]

    def get_K(self, img_id):
        return self.K.copy()

    def get_pose(self, img_id):
        return self.poses[int(img_id)].copy()

    def get_img_ids(self, check_depth_exist=False):
        return self.depth_img_ids if check_depth_exist else self.img_ids

    def get_depth(self, img_id):
        return _read_clipped_depth(self._depth_fn(img_id),
                                   self.get_depth_range(img_id)[1])

    def get_mask(self, img_id):
        h, w = self.get_image(img_id).shape[:2]
        return np.ones([h, w], bool)

    def get_depth_range(self, img_id):
        return self.range_dict[img_id].copy()


class SpaceDatabase(BaseDatabase):
    """space/<model>: a Spaces scene at its 800 resolution
    (``models.json`` rigs of cameras); dense depths from
    ``colmap_forward_cache/``."""

    def __init__(self, database_name: str):
        super().__init__(database_name)
        from neuray_tpu_torch.data.space_parser import read_scene
        _, model_name = database_name.split("/")
        self.views = read_scene(
            os.path.join(_root(), "spaces_dataset", "data", "800",
                         model_name))
        self.img_ids = [f"{r}-{c}" for r in range(len(self.views))
                        for c in range(len(self.views[r]))]
        self.range_dict = {i: np.asarray((0.7, 100), np.float32)
                           for i in self.img_ids}
        # some scenes store intrinsics for another resolution than their
        # images'
        self.incorrect_intrinsics = model_name in (
            "scene_008", "scene_038", "scene_039")
        if self.incorrect_intrinsics:
            self.name2Ks = {}
            for img_id in self.img_ids:
                view = self.get_view(img_id)
                h0, w0 = _imread(view.image_path).shape[:2]
                h1, w1 = view.shape
                self.name2Ks[img_id] = (
                    np.diag([w0 / w1, h0 / h1, 1]).astype(np.float32)
                    @ np.asarray(view.camera.intrinsics, np.float32))
        self.depth_img_ids = [i for i in self.img_ids
                              if os.path.exists(self._depth_fn(i))]

    def get_view(self, img_id):
        rig_id, cam_id = img_id.split("-")
        return self.views[int(rig_id)][int(cam_id)]

    def _depth_fn(self, img_id):
        return (f"{_root()}/colmap_forward_cache/{self.database_name}"
                f"/dense_out/stereo/depth_maps/{img_id}.jpg.geometric.bin")

    def get_image(self, img_id):
        return _imread(self.get_view(img_id).image_path)

    def get_K(self, img_id):
        if self.incorrect_intrinsics:
            return self.name2Ks[img_id].copy()
        return np.asarray(self.get_view(img_id).camera.intrinsics,
                          np.float32)

    def get_pose(self, img_id):
        c2w = self.get_view(img_id).camera.w_f_c[:3]
        R, t = c2w[:, :3], c2w[:, 3:]
        return np.concatenate([R.T, -R.T @ t], 1).astype(np.float32)

    def get_img_ids(self, check_depth_exist=False):
        return self.depth_img_ids if check_depth_exist else self.img_ids

    def get_depth(self, img_id):
        return _read_clipped_depth(self._depth_fn(img_id),
                                   self.get_depth_range(img_id)[1])

    def get_mask(self, img_id):
        h, w = self.get_image(img_id).shape[:2]
        return np.ones([h, w], bool)

    def get_depth_range(self, img_id):
        return self.range_dict[img_id].copy()


class RealEstateDatabase(BaseDatabase):
    """real_estate/<model>/<h>_<w>: RealEstate10K video frames
    (``frames/<model>/<timestamp>.png``) resized (INTER_AREA) to h x w and
    the clip's camera txt (normalized intrinsics, world->cam matrices);
    dense depths from ``colmap_forward_cache/``."""

    def __init__(self, database_name: str):
        super().__init__(database_name)
        _, model_name, img_size = database_name.split("/")
        self.model_name = model_name
        self.root_dir = f"{_root()}/real_estate_dataset/train"
        h, w = img_size.split("_")
        self.target_height, self.target_width = int(h), int(w)
        fns = os.listdir(f"{self.root_dir}/frames/{model_name}")
        img_ids = np.asarray([fn.split(".")[0] for fn in fns])
        self.img_ids = img_ids[np.argsort(img_ids.astype(np.int64))].tolist()
        self.cam_params = self._parse_pose_file(
            f"{self.root_dir}/cameras/{model_name}.txt")
        self.range_dict = {i: np.asarray((1.0, 100.0), np.float32)
                           for i in self.img_ids}
        self.depth_img_ids = [i for i in self.img_ids
                              if os.path.exists(self._depth_fn(i))]

    @staticmethod
    def _parse_pose_file(path):
        """RealEstate10K camera txt: the video's URL, then one line per
        frame: timestamp, fx fy cx cy (normalized), 2 unused, a row-major
        3x4 world->cam matrix."""
        cams = {}
        with open(path) as f:
            for i, line in enumerate(f):
                if i == 0:
                    continue
                entry = [float(x) for x in line.split()]
                w2c = np.eye(4)
                w2c[:3] = np.asarray(entry[7:]).reshape(3, 4)
                cams[int(entry[0])] = {
                    "fx fy cx cy": np.asarray(entry[1:5]),
                    "w2c": w2c}
        return cams

    def _depth_fn(self, img_id):
        return (f"{_root()}/colmap_forward_cache/real_estate/"
                f"{self.model_name}/dense_out/stereo/depth_maps/"
                f"{img_id}.jpg.geometric.bin")

    def get_image(self, img_id):
        img = _imread(f"{self.root_dir}/frames/{self.model_name}/"
                      f"{img_id}.png")
        return resize_area(img, (self.target_width, self.target_height))

    def get_K(self, img_id):
        fx, fy, cx, cy = self.cam_params[int(img_id)]["fx fy cx cy"]
        w, h = self.target_width, self.target_height
        return np.asarray([[fx * w, 0, cx * w], [0, fy * h, cy * h],
                           [0, 0, 1]], np.float32)

    def get_pose(self, img_id):
        return self.cam_params[int(img_id)]["w2c"][:3, :4].astype(
            np.float32).copy()

    def get_img_ids(self, check_depth_exist=False):
        return self.depth_img_ids if check_depth_exist else \
            list(self.img_ids)

    def get_depth(self, img_id):
        return _read_clipped_depth(self._depth_fn(img_id),
                                   self.get_depth_range(img_id)[1])

    def get_mask(self, img_id):
        return np.ones([self.target_height, self.target_width], bool)

    def get_depth_range(self, img_id):
        return self.range_dict[img_id].copy()


class DTUTrainDatabase(BaseDatabase):
    """dtu_train/<scan>: IDR-style ``cameras.npz`` and ``image/`` PNGs;
    dense depths from ``colmap_dtu_cache/``."""

    def __init__(self, database_name: str):
        super().__init__(database_name)
        _, model_name = database_name.split("/")
        self.root_dir = f"{_root()}/dtu_train/{model_name}"
        flip = np.diag([1, -1, -1, 1]).astype(np.float32)

        rgb_paths = sorted(
            x for x in glob.glob(os.path.join(self.root_dir, "image", "*"))
            if x.endswith((".jpg", ".png")))
        all_cam = np.load(os.path.join(self.root_dir, "cameras.npz"))
        self.Ks, self.Rts, self.img_ids = [], [], []
        for i in range(len(rgb_paths)):
            K, pose = idr_camera(all_cam, i, flip)
            self.Ks.append(K.astype(np.float32))
            self.Rts.append(pose.astype(np.float32))
            self.img_ids.append(f"{i}")
        self.range_dict = {i: np.asarray((0.8, 4.0), np.float32)
                           for i in self.img_ids}
        self.depth_img_ids = [i for i in self.img_ids
                              if os.path.exists(self._depth_fn(i))]

    def _depth_fn(self, img_id):
        return (f"{_root()}/colmap_dtu_cache/{self.database_name}/dense/"
                f"stereo/depth_maps/{img_id}.jpg.geometric.bin")

    def get_image(self, img_id):
        return _imread(os.path.join(self.root_dir, "image",
                                    f"{int(img_id):06}.png"))

    def get_K(self, img_id):
        return self.Ks[int(img_id)].copy()

    def get_pose(self, img_id):
        return self.Rts[int(img_id)].copy()

    def get_img_ids(self, check_depth_exist=False):
        return self.depth_img_ids if check_depth_exist else self.img_ids

    def get_depth(self, img_id):
        return _read_clipped_depth(self._depth_fn(img_id),
                                   self.get_depth_range(img_id)[1])

    def get_mask(self, img_id):
        h, w = self.get_image(img_id).shape[:2]
        return np.ones([h, w], bool)

    def get_depth_range(self, img_id):
        return self.range_dict[img_id].copy()


class BlendedMVSDatabase(BaseDatabase):
    """blended_mvs/<model>/half: BlendedMVS's blended images
    (``<id:08>_masked.jpg``) at half size and MVSNet-style cam txts."""

    name2uid = {"iron_dog": "5c1af2e2bee9a723c963d019",
                "building": "5bf18642c50e6f7f8bdbd492",
                "santa": "5be47bf9b18881428d8fbc1d",
                "dragon": "5bd43b4ba6b28b1ee86b92dd",
                "mermaid": "5ba19a8a360c7c30c1c169df",
                "laid_man": "59e75a2ca9e91f2c5526005d"}

    @staticmethod
    def load_pfm(file):
        """A PFM file (an open binary file): ASCII magic 'PF' (rgb) / 'Pf'
        (gray), a dims line, a scale line whose sign gives the byte order,
        then the f32 rows bottom-up."""
        magic = file.readline().decode().strip()
        if magic not in ("PF", "Pf"):
            raise ValueError(f"bad PFM magic {magic!r}")
        dims = file.readline().decode()
        m = re.match(r"^(\d+)\s(\d+)\s$", dims)
        if m is None:
            raise ValueError(f"bad PFM dims line {dims!r}")
        w, h = int(m.group(1)), int(m.group(2))
        endian_scale = float(file.readline().decode().strip())
        px = np.frombuffer(file.read(),
                           "<f" if endian_scale < 0 else ">f")
        img = px.reshape((h, w, 3) if magic == "PF" else (h, w))
        return img[::-1].copy()  # rows are bottom-up

    @staticmethod
    def load_mvs_cams(fn):
        """An MVSNet cam txt -> (extrinsic [3, 4], intrinsic [3, 3], the
        depth range widened 0.8x / 1.2x)."""
        with open(fn) as f:
            lines = f.readlines()
        extr = np.asarray([[float(v) for v in lines[1 + k].split()]
                           for k in range(4)])[:3]
        intr = np.asarray([[float(v) for v in lines[7 + k].split()]
                           for k in range(3)])
        vals = [float(v) for v in lines[11].split()]
        depth_min, depth_max = vals[0], vals[3]
        return extr, intr, np.asarray(
            [depth_min * 0.8, depth_max * 1.2], np.float32)

    def __init__(self, database_name: str):
        super().__init__(database_name)
        _, model_name, half_or_full = database_name.split("/")
        if half_or_full != "half":
            raise NotImplementedError(f"{database_name}: only 'half'")
        self.model_name = model_name
        self.root = f"{_root()}/blended-mvs/{self.name2uid[model_name]}"
        img_num = len(os.listdir(f"{self.root}/blended_images")) // 2
        self.img_ids = [str(k) for k in range(img_num)]
        self.poses, self.Ks, self.range_dict = [], [], {}
        for img_id in self.img_ids:
            pose, K, dr = self.load_mvs_cams(
                f"{self.root}/cams/{int(img_id):08d}_cam.txt")
            self.poses.append(pose)
            self.Ks.append(K)
            self.range_dict[img_id] = dr
        self.depth_img_ids = [i for i in self.img_ids
                              if os.path.exists(self._depth_fn(i))]

    def _depth_fn(self, img_id):
        return f"{self.root}/colmap_depth/{img_id}.jpg.geometric.bin"

    def get_image(self, img_id):
        img = _imread(
            f"{self.root}/blended_images/{int(img_id):08d}_masked.jpg")
        return resize_img(img, 0.5)

    def get_K(self, img_id):
        K = self.Ks[int(img_id)].astype(np.float32).copy()
        return (np.diag([0.5, 0.5, 1]) @ K).astype(np.float32)

    def get_pose(self, img_id):
        return self.poses[int(img_id)].astype(np.float32).copy()

    def get_img_ids(self, check_depth_exist=False):
        return self.depth_img_ids if check_depth_exist else self.img_ids

    def get_depth(self, img_id):
        return colmap_io.read_array(self._depth_fn(img_id))

    def get_mask(self, img_id):
        return np.sum(self.get_image(img_id), 2) > 0

    def get_depth_range(self, img_id):
        return self.range_dict[img_id].copy()


name2database_train = {
    "gso": GoogleScannedObjectDatabase,
    "real_iconic": RealIconicDatabase,
    "space": SpaceDatabase,
    "real_estate": RealEstateDatabase,
    "dtu_train": DTUTrainDatabase,
    "blended_mvs": BlendedMVSDatabase,
}


def scan_scene_names(database_type: str,
                     resolution_type: str = "hr") -> list:
    """The database names of a family's scenes on disk ([] when its
    directory is absent). dtu_train leaves out the scans of
    ``configs/dtu_test_scans.txt`` (read from the repository root) and
    refuses to list anything without that file."""
    root = _root()
    try:
        if database_type == "gso":
            base = f"{root}/google_scanned_objects"
            setting = "black_raw" if resolution_type == "hr" else \
                "black_400"
            return sorted(f"gso/{fn}/{setting}" for fn in os.listdir(base)
                          if os.path.isdir(os.path.join(base, fn)))
        if database_type == "dtu_train":
            fns = [fn for fn in os.listdir(f"{root}/dtu_train")
                   if fn.startswith("scan")]
            # without the exclusion list the held-out dtu_test scans would
            # leak into the training mixture
            repo = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            scans_fn = os.path.join(repo, "configs", "dtu_test_scans.txt")
            if not os.path.exists(scans_fn):
                # not FileNotFoundError, which the handler below takes
                # for a missing dataset
                raise RuntimeError(
                    f"{scans_fn} missing: refusing to build the "
                    "dtu_train scene list without the test-scan "
                    "exclusion list (eval contamination)")
            test_scans = set(np.loadtxt(scans_fn, dtype=str).tolist())
            return sorted(f"dtu_train/{fn}" for fn in fns
                          if fn not in test_scans)
        if database_type == "real_iconic":
            factor = "4" if resolution_type == "hr" else "8"
            return sorted(
                f"real_iconic/{fn}/{factor}"
                for fn in os.listdir(f"{root}/real_iconic_noface"))
        if database_type == "space":
            return sorted(
                f"space/{fn}"
                for fn in os.listdir(f"{root}/spaces_dataset/data/800"))
        if database_type == "real_estate":
            return sorted(
                f"real_estate/{fn}/450_800"
                for fn in os.listdir(
                    f"{root}/real_estate_dataset/train/frames"))
        if database_type == "blended_mvs":
            return [f"blended_mvs/{name}/half"
                    for name in BlendedMVSDatabase.name2uid
                    if os.path.exists(
                        f"{root}/blended-mvs/"
                        f"{BlendedMVSDatabase.name2uid[name]}")]
    except FileNotFoundError:
        return []
    raise NotImplementedError(database_type)
