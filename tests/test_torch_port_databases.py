"""Every dataset family of the port's data layer (``data/database.py``,
``data/train_databases.py``) against the JAX package's, on one scene of
each written in its published on-disk layout (``data/fabricate.py``; the
JAX package's own tests, ``tests/test_train_databases.py`` and
``tests/test_example_db.py``, build theirs the same way) under one
``DATA_ROOT`` for both packages.

``parse_database_name`` gives the same family, and on every view
``get_img_ids`` and ``get_depth_range`` agree exactly, ``get_K`` and
``get_pose`` within 1e-6, ``get_depth``, ``get_mask`` and ``get_image``
exactly (the port's copies of cv2's fixed-point blur and resizes are
cv2's to the bit, ``tests/test_torch_port_image_ops.py``). ``scan_scene_names`` agrees for
every family, the refusal without ``configs/dtu_test_scans.txt``
included. LLFF's JPEG cache is read by each package after the other
wrote it.
"""
import os
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest

from neuray_tpu.data import database as jDB
from neuray_tpu.data import train_databases as jT

from neuray_tpu_torch.data import colmap_io as C
from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data import fabricate as F
from neuray_tpu_torch.data import train_databases as T

# the test families' writers (the training path reads only those of
# ``data/fabricate.py``)
def write_points3d_binary(path, points):
    """``points`` as a ``points3D.bin`` that ``read_points3d_binary``
    reads back."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q3d3Bd", p.id, *p.xyz,
                                *np.asarray(p.rgb, np.uint8), p.error))
            track = np.stack([p.image_ids, p.point2d_idxs], -1).astype("<i4")
            f.write(struct.pack("<Q", len(track)))
            f.write(track.tobytes())


def write_dtu_test(root, name="scan24", n=6, h=1200, w=1600, seed=0) -> str:
    """dtu_test/<name>: IDR's layout (``image/``, ``mask/<i:03>.png``,
    ``cameras.npz``), ``depth_range.npy`` and ``colmap_depth/`` at half
    the size (800 wide for 1600)."""
    rng = np.random.RandomState(seed)
    base = Path(root) / "dtu_test" / name
    for sub in ("image", "mask", "colmap_depth"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    K = F._K(1.2 * w, w, h)
    Kd = K * [[0.5], [0.5], [1]]
    cams, jobs = {}, []
    for i, pose in enumerate(F._cluster(rng, n, 2.5)):
        cams[f"world_mat_{i}"] = np.concatenate(
            [K @ pose, [[0.0, 0, 0, 1]]], 0)
        rgb, _, hit = F._render(pose, K, h, w)
        _, depth, _ = F._render(pose, Kd, h // 2, w // 2)
        jobs += [(base / "image" / f"{i:06}.png", rgb),
                 (base / "mask" / f"{i:03}.png",
                  np.repeat(hit[..., None], 3, 2).astype(np.uint8) * 255)]
        C.write_array(str(base / "colmap_depth" / f"{i}.jpg.geometric.bin"),
                      depth)
    np.savez(base / "cameras.npz", **cams)
    np.save(base / "depth_range.npy", np.asarray([1.0, 4.0], np.float32))
    F._write_all(jobs)
    return f"dtu_test/{name}/black_{w // 2}"


BLENDED_MVS_UIDS = {"santa": "5be47bf9b18881428d8fbc1d"}


def write_blended_mvs(root, name="santa", n=6, h=576, w=768, seed=0) -> str:
    """blended-mvs/<uid>: ``blended_images/<i:08>[_masked].jpg``,
    MVSNet cam txts in ``cams/`` and ``colmap_depth/`` at half size."""
    rng = np.random.RandomState(seed)
    base = Path(root) / "blended-mvs" / BLENDED_MVS_UIDS[name]
    for sub in ("blended_images", "cams", "colmap_depth"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    K = F._K(1.2 * w, w, h)
    jobs = []
    for i, pose in enumerate(F._cluster(rng, n, 4.0)):
        rgb, _, _ = F._render(pose, K, h, w)
        _, depth, _ = F._render(pose, K * [[0.5], [0.5], [1]], h // 2, w // 2)
        jobs += [(base / "blended_images" / f"{i:08d}.jpg", rgb),
                 (base / "blended_images" / f"{i:08d}_masked.jpg", rgb)]
        extr = np.concatenate([pose, [[0.0, 0, 0, 1]]], 0)
        text = ("extrinsic\n" + "".join(" ".join(map(str, r)) + "\n"
                                         for r in extr)
                + "\nintrinsic\n" + "".join(" ".join(map(str, r)) + "\n"
                                            for r in K)
                + "\n2.5 0.01 0.01 5.5\n")
        (base / "cams" / f"{i:08d}_cam.txt").write_text(text)
        C.write_array(str(base / "colmap_depth" / f"{i}.jpg.geometric.bin"),
                      depth)
    F._write_all(jobs)
    return f"blended_mvs/{name}/half"


def write_example(root, name="desk", n=6, h=48, w=64, seed=0) -> str:
    """example/<name>: a COLMAP sparse model (``sparse/0``, points
    included), JPEG images and dense depths in ``dense/stereo/
    depth_maps/``."""
    rng = np.random.RandomState(seed)
    base = Path(root) / "example" / name
    (base / "images").mkdir(parents=True, exist_ok=True)
    K = F._K(1.2 * w, w, h)
    poses = F._cluster(rng, n, 4.0)
    names = [f"frame_{i}.jpg" for i in range(n)]
    jobs, depths = [], []
    for pose, fn in zip(poses, names):
        rgb, depth, _ = F._render(pose, K, h, w)
        jobs.append((base / "images" / fn, rgb))
        depths.append((f"{fn}.geometric.bin", depth))
    F._write_colmap_model(base / "sparse" / "0", poses, K, w, h, names)
    pts = rng.randn(40, 3)
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    write_points3d_binary(str(base / "sparse" / "0" / "points3D.bin"), {
        k + 1: C.Point3D(k + 1, p, np.array([200, 100, 50]), 0.5,
                         np.zeros(0, np.int32), np.zeros(0, np.int32))
        for k, p in enumerate(pts)})
    F._write_all(jobs)
    F._write_depths(base / "dense" / "stereo" / "depth_maps", depths)
    return f"example/{name}/raw"


def write_scenes(root):
    return {
        "gso": F.write_gso(root, size=24),
        "dtu_train": F.write_dtu_train(root, n=4, h=36, w=48),
        "real_iconic": F.write_real_iconic(root, n=4, h=64, w=96),
        "real_estate": F.write_real_estate(root, n=4, h=90, w=160,
                                           target=(45, 80)),
        "space": F.write_space(root, n=4, h=30, w=50),
        "llff_colmap": F.write_llff_colmap(root, n=9, h=756, w=1008),
        "dtu_test": write_dtu_test(root, n=4, h=36, w=48),
        "blended_mvs": write_blended_mvs(root, n=3, h=36, w=48),
        "example": write_example(root, n=4),
    }


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    names = write_scenes(root)
    from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
    write_nerf_synthetic_sphere(root, n_train=2, size=800)
    names["nerf_synthetic"] = "nerf_synthetic/sphere/black_800"
    names["nerf_synthetic_400"] = "nerf_synthetic/sphere/black_400"
    names["example_32"] = "example/desk/32"
    return root, names


@pytest.fixture
def data_root(scenes, monkeypatch):
    root, names = scenes
    monkeypatch.setattr(DB, "DATA_ROOT", root)
    monkeypatch.setattr(jDB, "DATA_ROOT", root)
    return root, names


def test_every_jax_family_is_ported():
    assert set(DB.name2database) == set(jDB.name2database)
    assert set(T.name2database_train) == set(jT.name2database_train)


FAMILIES = ["gso", "dtu_train", "real_iconic", "real_estate", "space",
            "llff_colmap", "dtu_test", "blended_mvs", "example",
            "example_32", "nerf_synthetic", "nerf_synthetic_400"]


@pytest.mark.parametrize("family", FAMILIES)
def test_database_equals_jax(data_root, family):
    _, names = data_root
    name = names[family]
    ours, theirs = DB.parse_database_name(name), jDB.parse_database_name(name)
    assert type(ours).__name__ == type(theirs).__name__
    ids = ours.get_img_ids()
    assert ids == theirs.get_img_ids()
    assert ours.get_img_ids(True) == theirs.get_img_ids(True)
    if family.startswith(("gso", "nerf")):
        ids = ids[:3] + ids[-2:]
    for i in ids:
        np.testing.assert_array_equal(ours.get_depth_range(i),
                                      theirs.get_depth_range(i))
        for getter in ("get_K", "get_pose"):
            a, b = getattr(ours, getter)(i), getattr(theirs, getter)(i)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max())
        for getter in ("get_depth", "get_mask"):
            a, b = getattr(ours, getter)(i), getattr(theirs, getter)(i)
            if b is None:
                assert a is None
                continue
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        a, b = ours.get_image(i), theirs.get_image(i)
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=str(i))


@pytest.mark.parametrize("family", FAMILIES)
def test_database_splits_equal_jax(data_root, family):
    name = data_root[1][family]
    ours, theirs = DB.parse_database_name(name), jDB.parse_database_name(name)
    splits = ["val", "test", "val_all"] + (
        ["example_2"] if family.startswith("example") else [])
    for split in splits:
        assert DB.get_database_split(ours, split) == \
            jDB.get_database_split(theirs, split)


@pytest.mark.parametrize("family", ["gso", "dtu_train", "real_iconic",
                                    "space", "real_estate", "blended_mvs"])
@pytest.mark.parametrize("resolution", ["hr", "lr"])
def test_scan_scene_names_equal_jax(data_root, family, resolution):
    ours = T.scan_scene_names(family, resolution)
    assert ours == jT.scan_scene_names(family, resolution)
    assert len(ours) == 1


def test_scan_scene_names_of_missing_families(tmp_path, monkeypatch):
    monkeypatch.setattr(DB, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(jDB, "DATA_ROOT", str(tmp_path))
    for family in ("gso", "dtu_train", "real_iconic", "space",
                   "real_estate", "blended_mvs"):
        assert T.scan_scene_names(family) == jT.scan_scene_names(family) == []
    with pytest.raises(NotImplementedError):
        T.scan_scene_names("nowhere")


def test_dtu_train_missing_exclusion_list_is_loud(tmp_path, monkeypatch):
    """Without configs/dtu_test_scans.txt both packages refuse to list
    dtu_train (the held-out dtu_test scans would leak into training)."""
    (tmp_path / "dtu_train" / "scan1").mkdir(parents=True)
    monkeypatch.setattr(DB, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(jDB, "DATA_ROOT", str(tmp_path))
    real_exists = os.path.exists

    def exists(p):
        return False if str(p).endswith("dtu_test_scans.txt") else \
            real_exists(p)

    for module in (T, jT):
        monkeypatch.setattr(module.os.path, "exists", exists)
        with pytest.raises(RuntimeError, match="dtu_test_scans"):
            module.scan_scene_names("dtu_train")


def test_dtu_train_leaves_out_the_test_scans(tmp_path, monkeypatch):
    for scan in ("scan1", "scan24", "scan2"):
        (tmp_path / "dtu_train" / scan).mkdir(parents=True)
    monkeypatch.setattr(DB, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(jDB, "DATA_ROOT", str(tmp_path))
    assert T.scan_scene_names("dtu_train") == \
        jT.scan_scene_names("dtu_train") == ["dtu_train/scan1",
                                             "dtu_train/scan2"]


def test_llff_cache_both_ways(tmp_path, monkeypatch):
    """Each package builds fern's cache/high in a data root of its own; each
    then reads, in a third and a fourth root holding the same scene, the
    cache the other wrote, and gets the writer's own images bit for bit
    (both decoders are libjpeg-turbo's to the bit). The two caches are
    the same files byte for byte: the blur, the INTER_AREA reduction and
    the JPEG encoder are cv2's to the bit."""
    roots = {k: str(tmp_path / k) for k in ("jax", "port", "jax_reads",
                                            "port_reads")}
    F.write_llff_colmap(roots["jax"], n=4, h=756, w=1008)
    for k in ("port", "jax_reads", "port_reads"):
        shutil.copytree(roots["jax"], roots[k])
    name = "llff_colmap/fern/high"

    def build(module, root):
        monkeypatch.setattr(module, "DATA_ROOT", root)
        return module.parse_database_name(name)

    jax_db, port_db = build(jDB, roots["jax"]), build(DB, roots["port"])
    cache = os.path.join("llff_colmap", "fern", "cache")
    shutil.copytree(os.path.join(roots["jax"], cache),
                    os.path.join(roots["port_reads"], cache))
    shutil.copytree(os.path.join(roots["port"], cache),
                    os.path.join(roots["jax_reads"], cache))
    port_on_jax = build(DB, roots["port_reads"])
    jax_on_port = build(jDB, roots["jax_reads"])
    for i in jax_db.get_img_ids():
        np.testing.assert_array_equal(port_on_jax.get_image(i),
                                      jax_db.get_image(i))
        np.testing.assert_array_equal(jax_on_port.get_image(i),
                                      port_db.get_image(i))
        np.testing.assert_array_equal(port_db.get_image(i),
                                      jax_db.get_image(i))
    files = sorted(os.listdir(os.path.join(roots["jax"], cache, "high")))
    assert files == sorted(os.listdir(os.path.join(roots["port"], cache,
                                                   "high")))
    for fn in files:
        with open(os.path.join(roots["jax"], cache, "high", fn), "rb") as f:
            theirs = f.read()
        with open(os.path.join(roots["port"], cache, "high", fn), "rb") as f:
            assert f.read() == theirs, fn


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_llff_minify_reads_exif_orientation_as_cv2(tmp_path, orientation):
    """real_iconic's originals are read as cv2.imread's default reads
    them: a JPEG turned upright by its EXIF orientation; both packages
    minify the same file to the same PNG."""
    import struct
    import cv2
    from neuray_tpu.data import llff as jL
    from neuray_tpu_torch.data import llff as L
    y, x = np.mgrid[:24, :40]
    img = np.stack([x * 6, y * 10, x + y], -1).astype(np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    tiff = (b"II*\x00" + struct.pack("<IH", 8, 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    body = b"Exif\x00\x00" + tiff
    data = buf.tobytes()
    data = (data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
            + data[2:])
    for name in ("ours", "theirs"):
        (tmp_path / name / "images").mkdir(parents=True)
        (tmp_path / name / "images" / "a.jpg").write_bytes(data)
    ours = L._minify(str(tmp_path / "ours"), 4)[0]
    theirs = jL._minify(str(tmp_path / "theirs"), 4)[0]
    a, b = cv2.imread(ours), cv2.imread(theirs)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)
