"""The port's camera trajectories (``data/render_poses.py``) and
``select_working_views_db`` against the JAX package's, exactly, on
scenes fabricated on disk and read by both packages from one root:
BlendedMVS with the keyframes of every
``configs/inter_trajectory/blended_mvs/*.txt`` (cameras only: 333 views,
the images empty files, which only their count is read of), ``circle``
on fern, and ``inter`` / ``inter_<n>`` on a NeRF-synthetic sphere.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from neuray_tpu.data import database as jDB
from neuray_tpu.data import render_poses as jP
from neuray_tpu.data import view_select as jV

from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data import fabricate as F
from neuray_tpu_torch.data import render_poses as P
from neuray_tpu_torch.data import view_select as V
from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
from neuray_tpu_torch.data.train_databases import BlendedMVSDatabase

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TRAJECTORIES = sorted((ROOT / "configs" / "inter_trajectory" /
                       "blended_mvs").glob("*.txt"))


def both(monkeypatch, root, name):
    for module in (jDB, DB):
        monkeypatch.setattr(module, "DATA_ROOT", str(root))
    return jDB.parse_database_name(name), DB.parse_database_name(name)


def write_blended_mvs_cams(root, name, n):
    """n MVSNet cam txts of cameras around the origin, and the image
    files the database counts (empty)."""
    base = Path(root) / "blended-mvs" / BlendedMVSDatabase.name2uid[name]
    for sub in ("blended_images", "cams"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    K = F._K(600.0, 768, 576)
    rng = np.random.RandomState(len(name))
    def rows(m):
        return "".join(" ".join(repr(float(v)) for v in r) + "\n" for r in m)

    for i, pose in enumerate(F._cluster(rng, n, 4.0, spread=1.0)):
        extr = np.concatenate([pose, [[0.0, 0, 0, 1]]], 0)
        (base / "cams" / f"{i:08d}_cam.txt").write_text(
            "extrinsic\n" + rows(extr) + "\nintrinsic\n" + rows(K)
            + "\n2.5 0.01 0.01 5.5\n")
        for suffix in ("", "_masked"):
            (base / "blended_images" / f"{i:08d}{suffix}.jpg").touch()


@pytest.mark.parametrize("fn", TRAJECTORIES, ids=lambda p: p.stem)
def test_blended_mvs_trajectories_equal_jax(tmp_path, monkeypatch, fn):
    n = int(np.loadtxt(fn, dtype=np.int64).max()) + 1
    write_blended_mvs_cams(tmp_path, fn.stem, n)
    jdb, db = both(monkeypatch, tmp_path, f"blended_mvs/{fn.stem}/half")
    for pose_type in ("inter", "inter_17"):
        ours = P.get_render_poses(db, pose_type, str(fn))
        theirs = jP.get_render_poses(jdb, pose_type, str(fn))
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
    ids = list(db.get_img_ids())
    np.testing.assert_array_equal(
        V.select_working_views_db(db, ids, ours, 8),
        jV.select_working_views_db(jdb, ids, theirs, 8))


def test_circle_on_fern_equals_jax(tmp_path, monkeypatch):
    F.write_llff_colmap(str(tmp_path), n=4, h=756, w=1008)
    jdb, db = both(monkeypatch, tmp_path, "llff_colmap/fern/high")
    ours = P.get_render_poses(db, "circle")
    theirs = jP.get_render_poses(jdb, "circle")
    assert ours.shape == (60, 3, 4)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(P.forward_circle_poses(db, 7),
                                  jP.forward_circle_poses(jdb, 7))
    np.testing.assert_array_equal(P.pose_inverse(ours[3]),
                                  jP.pose_inverse(theirs[3]))


def test_inter_on_nerf_synthetic_equals_jax(tmp_path, monkeypatch):
    write_nerf_synthetic_sphere(str(tmp_path), 10, 16, "toy", 2)
    jdb, db = both(monkeypatch, tmp_path, "nerf_synthetic/toy/black_800")
    keys = tmp_path / "keys.txt"
    keys.write_text("3\n0\n7\n12\n")
    for pose_type, pose_fn in (("inter", None), ("inter_5", None),
                               ("inter_9", str(keys))):
        ours = P.get_render_poses(db, pose_type, pose_fn)
        np.testing.assert_array_equal(
            ours, jP.get_render_poses(jdb, pose_type, pose_fn))
    ids = db.get_img_ids(check_depth_exist=True)
    np.testing.assert_array_equal(
        V.select_working_views_db(db, ids, ours, 8, True),
        jV.select_working_views_db(jdb, ids, ours, 8, True))
    np.testing.assert_array_equal(
        P.interpolate_render_poses(db, ids[:4], 6, False),
        jP.interpolate_render_poses(jdb, ids[:4], 6, False))
    with pytest.raises(NotImplementedError):
        P.get_render_poses(db, "spiral")
