"""The port's finetuning data layer against the JAX package's: the PNG
reader and writer against ``cv2``, COLMAP's dense map format, the
NeRF-synthetic database and its splits, ``build_imgs_info``,
``get_coords_mask`` and the nearest-view selection, all exactly equal.

The scene is the port's fabricated NeRF-synthetic sphere
(``data/synthetic.write_nerf_synthetic_sphere``) at 32x32, 6 train views
(two without a depth map), the 6 named val views and one test view; the
JAX side reads the same folder through ``cv2``, its ``DATA_ROOT``
monkeypatched as ``tests/test_ft.py`` does.
"""
import os
import struct
import time
import zlib

import cv2
import numpy as np
import pytest
import torch

from neuray_tpu.data import colmap_io as jC
from neuray_tpu.data import database as jDB
from neuray_tpu.data import imgs_info as jI
from neuray_tpu.data import view_select as jV

from neuray_tpu_torch.data import colmap_io as C
from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data import imgs_info as I
from neuray_tpu_torch.data import view_select as V
from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
from neuray_tpu_torch.utils.png import read_png, write_png

torch.set_num_threads(1)

SIZE, N_TRAIN = 32, 6
NO_DEPTH = ("train-r_1", "train-r_4")


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft_data")
    write_nerf_synthetic_sphere(str(root), n_train=N_TRAIN, size=SIZE)
    for img_id in NO_DEPTH:
        os.remove(root / "nerf_synthetic" / "sphere" / "colmap_depth" /
                  f"{img_id}.png.geometric.bin")
    return str(root)


@pytest.fixture
def dbs(scene_root, monkeypatch):
    """(port database, JAX database) factories over the scene."""
    monkeypatch.setattr(DB, "DATA_ROOT", scene_root)
    monkeypatch.setattr(jDB, "DATA_ROOT", scene_root)

    def make(background="black"):
        name = f"nerf_synthetic/sphere/{background}_800"
        return DB.parse_database_name(name), jDB.parse_database_name(name)
    return make


# ---------------- PNG ----------------

def png_filters(path):
    """The row filter types of an 8-bit PNG file."""
    data = open(path, "rb").read()
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        ihdr = body if kind == b"IHDR" else ihdr
        idat += body if kind == b"IDAT" else b""
        pos += 12 + n
    w, h, _, color = struct.unpack(">IIBB", ihdr[:10])
    stride = 1 + w * {0: 1, 2: 3, 6: 4}[color]
    return set(zlib.decompress(idat)[::stride][:h])


def sample_image(kind, c, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "noise":
        img = rng.randint(0, 256, (29, 37, c))
    else:
        y, x = np.mgrid[0:29, 0:37]
        img = np.stack([(x * (3 + i) + y * (5 - i) + 40 * i) % 256
                        + rng.randint(0, 3, x.shape) for i in range(c)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


CV2_FILTERS = {"default": None, "none": cv2.IMWRITE_PNG_FILTER_NONE,
               "sub": cv2.IMWRITE_PNG_FILTER_SUB,
               "up": cv2.IMWRITE_PNG_FILTER_UP,
               "average": cv2.IMWRITE_PNG_FILTER_AVG,
               "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
               "adaptive": cv2.IMWRITE_PNG_ALL_FILTERS}


def cv2_write(path, img, filt):
    flags = ([] if CV2_FILTERS[filt] is None
             else [cv2.IMWRITE_PNG_FILTER, CV2_FILTERS[filt]])
    assert cv2.imwrite(path, img[..., 0] if img.shape[2] == 1 else img,
                       flags)


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("filt", list(CV2_FILTERS))
def test_read_png_equals_cv2(tmp_path, c, filt):
    """The port's reader is byte-equal to ``cv2.imread`` (in RGB(A)
    order) on files that cv2 writes with each row filter and with
    libpng's adaptive choice among them."""
    for kind in ("noise", "ramp"):
        img = sample_image(kind, c)
        path = str(tmp_path / f"{kind}.png")
        cv2_write(path, img, filt)
        theirs = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if c > 1:
            theirs = theirs[..., [2, 1, 0, 3][:c]]
        ours = read_png(path)
        assert ours.dtype == np.uint8 and ours.shape == theirs.shape
        np.testing.assert_array_equal(ours, theirs)


def test_cv2_files_use_every_filter(tmp_path):
    """The files above exercise each of the reader's filters, and the
    adaptive files mix several in one image."""
    seen = {}
    for filt in CV2_FILTERS:
        path = str(tmp_path / f"{filt}.png")
        cv2_write(path, sample_image("ramp", 3), filt)
        seen[filt] = png_filters(path)
    assert set().union(*seen.values()) == {0, 1, 2, 3, 4}, seen
    assert len(seen["adaptive"]) >= 2, seen


@pytest.mark.parametrize("c", [3, 4])
def test_cv2_reads_write_png(tmp_path, c):
    img = sample_image("noise", c)
    path = str(tmp_path / "img.png")
    write_png(path, img)
    assert png_filters(path) == {0}
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., [2, 1, 0, 3][:c]], img)
    np.testing.assert_array_equal(read_png(path), img)


ROW_FILTERS = ["none", "sub", "up", "average", "paeth"]     # types 0-4


@pytest.mark.parametrize("filt", ROW_FILTERS)
def test_read_png_800x800_rgba(tmp_path, filt):
    """A NeRF-synthetic-sized file (800x800 RGBA noise) that cv2 writes
    with one row filter reads back byte-equal; the read's seconds are
    printed (``pytest -s -k 800x800``): Average and Paeth loop over every
    byte in Python."""
    img = np.random.RandomState(0).randint(0, 256, (800, 800, 4)).astype(
        np.uint8)
    path = str(tmp_path / f"{filt}.png")
    cv2_write(path, img, filt)
    assert png_filters(path) == {ROW_FILTERS.index(filt)}
    t0 = time.perf_counter()
    ours = read_png(path)
    seconds = time.perf_counter() - t0
    np.testing.assert_array_equal(ours, img[..., [2, 1, 0, 3]])
    print(f"read_png 800x800 RGBA, every row {filt}: {seconds:.3f} s")


def test_read_png_refuses_other_kinds(tmp_path):
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, np.zeros((4, 5, 3), np.uint16))
    with pytest.raises(NotImplementedError, match="bit depth 16"):
        read_png(path)
    with pytest.raises(ValueError):
        write_png(path, np.zeros((4, 5, 3), np.uint16))
    with pytest.raises(ValueError):
        write_png(path, np.zeros((4, 5, 2), np.uint8))


# ---------------- COLMAP's dense maps ----------------

@pytest.mark.parametrize("shape", [(7, 5), (6, 9, 3)])
def test_read_array_equals_jax(tmp_path, shape):
    arr = np.random.RandomState(0).rand(*shape).astype(np.float32)
    path = str(tmp_path / "map.bin")
    C.write_array(path, arr)
    ours, theirs = C.read_array(path), jC.read_array(path)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, arr)


def test_read_array_is_writable(tmp_path):
    """The DTU test set's reader masks a depth map in place: at its read
    width 800 no resize copies it first (``chip_smoke.py`` phase 15's
    fern)."""
    path = str(tmp_path / "map.bin")
    C.write_array(path, np.ones((6, 8), np.float32))
    depth = C.read_array(path)
    assert depth.flags.writeable and depth.flags.c_contiguous
    depth[0, 0] = 0.0


# ---------------- the database ----------------

@pytest.mark.parametrize("background", ["black", "white"])
def test_database_equals_jax(dbs, background):
    ours, theirs = dbs(background)
    assert ours.get_img_ids() == theirs.get_img_ids()
    assert len(ours.get_img_ids()) == N_TRAIN + 7
    assert ours.get_img_ids(True) == theirs.get_img_ids(True)
    assert not set(NO_DEPTH) & set(ours.get_img_ids(True))
    for img_id in theirs.get_img_ids():
        for get in ("get_image", "get_mask", "get_pose", "get_K",
                    "get_depth_range", "get_depth"):
            a = getattr(ours, get)(img_id)
            b = getattr(theirs, get)(img_id)
            if b is None:
                assert a is None, (get, img_id)
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, (get, img_id)
            np.testing.assert_array_equal(a, b, err_msg=f"{get} {img_id}")


@pytest.mark.parametrize("split", ["val", "val_all", "test", "test_all"])
def test_database_split_equals_jax(dbs, split):
    ours, theirs = dbs()
    assert DB.get_database_split(ours, split) == jDB.get_database_split(
        theirs, split)
    assert DB.nerf_syn_val_ids == jDB.nerf_syn_val_ids


def test_database_reads_data_root_when_built(scene_root, monkeypatch):
    monkeypatch.setattr(DB, "DATA_ROOT", "/nonexistent")
    with pytest.raises(FileNotFoundError):
        DB.parse_database_name("nerf_synthetic/sphere/black_800")
    monkeypatch.setattr(DB, "DATA_ROOT", scene_root)
    assert DB.parse_database_name(
        "nerf_synthetic/sphere/black_800").root_dir.startswith(scene_root)


@pytest.mark.parametrize("name,match", [
    ("nowhere/x/y", "unknown"), ("nerf/lego/black_800", "unknown"),
    ("llff/fern/high", "unknown")])
def test_unported_databases_raise(dbs, name, match):
    """Every family of the JAX package is ported
    (tests/test_torch_port_databases.py); other names raise."""
    with pytest.raises(NotImplementedError, match=match):
        DB.parse_database_name(name)


# ---------------- imgs_info ----------------

@pytest.mark.parametrize("kw", [
    dict(pad_interval=16, replace_none_depth=True),
    dict(pad_interval=-1, has_depth=False),
    dict(pad_interval=12, replace_none_depth=True, align_depth_range=True),
    dict(is_aligned=False, pad_interval=-1)])
def test_build_imgs_info_equals_jax(dbs, kw):
    ours_db, theirs_db = dbs()
    ids = ours_db.get_img_ids()[:N_TRAIN]
    if kw.get("is_aligned") is False:
        ids = ours_db.get_img_ids(True)       # every depth map present
    ours = I.build_imgs_info(ours_db, ids, **kw)
    theirs = jI.build_imgs_info(theirs_db, ids, **kw)
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    sel = np.array([2, 0])
    sliced = I.imgs_info_slice(ours, sel)
    for k, v in jI.imgs_info_slice(theirs, sel).items():
        np.testing.assert_array_equal(sliced[k], v, err_msg=k)


def test_pad_img_end_and_color_map_equal_jax():
    img = sample_image("noise", 3)
    for mode in ("edge", "reflect", "constant"):
        np.testing.assert_array_equal(I.pad_img_end(img, 33, 40, mode),
                                      jI.pad_img_end(img, 33, 40, mode))
    np.testing.assert_array_equal(I.color_map_forward(img),
                                  jI.color_map_forward(img))


@pytest.mark.parametrize("mask_kind,n,ratio", [
    ("disc", 64, 0.5), ("disc", 37, 1.0), ("disc", 50, 0.0),
    ("tiny", 64, 0.5), ("tiny", 64, 1.0), ("full", 40, 0.5),
    ("empty", 40, 0.5)])
def test_get_coords_mask_equals_jax(mask_kind, n, ratio):
    y, x = np.mgrid[0:24, 0:30]
    mask = {"disc": (x - 15) ** 2 + (y - 12) ** 2 < 64,
            "tiny": (x == 3) & (y < 5), "full": np.ones((24, 30), bool),
            "empty": np.zeros((24, 30), bool)}[mask_kind]
    ours = I.get_coords_mask(mask, n, ratio, np.random.RandomState(5))
    theirs = jI.get_coords_mask(mask, n, ratio, np.random.RandomState(5))
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.shape == (n, 2)
    np.testing.assert_array_equal(ours, theirs)


# ---------------- view selection ----------------

def test_nearest_views_equal_jax(dbs):
    ours_db, theirs_db = dbs()
    ref_ids, que_ids = DB.get_database_split(ours_db, "val_all")
    np.testing.assert_array_equal(
        V.compute_nearest_camera_indices(ours_db, ref_ids),
        jV.compute_nearest_camera_indices(theirs_db, ref_ids))
    np.testing.assert_array_equal(
        V.compute_nearest_camera_indices(ours_db, que_ids, ref_ids),
        jV.compute_nearest_camera_indices(theirs_db, que_ids, ref_ids))
    ref_poses = np.asarray([ours_db.get_pose(i) for i in ref_ids])
    que_poses = np.asarray([ours_db.get_pose(i) for i in que_ids])
    for exclude in (False, True):
        np.testing.assert_array_equal(
            V.select_working_views(ref_poses, que_poses, 3, exclude),
            jV.select_working_views(ref_poses, que_poses, 3, exclude))


def test_fabricated_scene_reads_back_its_geometry(dbs):
    """The fabricated views are rendered with the pose and K the
    database reads back: a train view's depth unprojects onto the unit
    sphere, and its mask is where the depth is positive."""
    ours, _ = dbs()
    img_id = "train-r_0"
    depth, pose, K = (ours.get_depth(img_id), ours.get_pose(img_id),
                      ours.get_K(img_id))
    np.testing.assert_array_equal(ours.get_mask(img_id), depth > 0)
    ys, xs = np.nonzero(depth > 0)
    cam = np.linalg.inv(K) @ np.stack([xs, ys, np.ones_like(xs)]) * depth[
        ys, xs]
    world = pose[:, :3].T @ (cam - pose[:, 3:])
    np.testing.assert_allclose(np.linalg.norm(world, axis=0), 1.0,
                               atol=1e-4)
