"""The port's ``GeneralRendererDataset`` (``data/train_dataset.py``)
against the JAX package's, train and eval, on each dataset family
fabricated on disk (``data/fabricate.py``), with ``use_src_imgs`` on and
off: the same index and seed give the same sample key for key (depth
ranges, coords, ``nn_ids`` and ``depth_loss_coords`` exactly; poses and
Ks exactly but for DTU's, which come from a projection matrix's RQ
decomposition, within 1e-6 as ``tests/test_torch_port_databases.py``
holds them; images exactly, resized ones too). The training seed reads ``time.time()``, which both modules see
frozen at one value. Also ``select_train_ids_for_real_estate``,
``add_depth_offset`` and ``FinetuningRendererDataset``.
"""
import types

import numpy as np
import pytest

from neuray_tpu.data import database as jDB
from neuray_tpu.data import train_dataset as jD

from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data import fabricate as F
from neuray_tpu_torch.data import train_dataset as D
from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere

TRAIN = ["gso", "dtu_train", "real_iconic", "real_estate", "space"]
SMALL = {"train_ray_num": 64, "depth_loss_coords_num": 32,
         "aug_forward_crop_size": (24, 40)}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    names = {
        "gso": F.write_gso(root, size=24),
        "dtu_train": F.write_dtu_train(root, n=10, h=36, w=48),
        "real_iconic": F.write_real_iconic(root, n=10, h=64, w=96),
        "real_estate": F.write_real_estate(root, n=10, h=450, w=800),
        "space": F.write_space(root, n=10, h=30, w=50),
        "llff_colmap": F.write_llff_colmap(root, n=9, h=756, w=1008),
    }
    write_nerf_synthetic_sphere(root, n_train=8, size=800)
    names["nerf_synthetic"] = "nerf_synthetic/sphere/black_400"
    return root, names


@pytest.fixture
def data_root(scenes, monkeypatch):
    root, names = scenes
    monkeypatch.setattr(DB, "DATA_ROOT", root)
    monkeypatch.setattr(jDB, "DATA_ROOT", root)
    clock = types.SimpleNamespace(time=lambda: 1_700_000_123.0)
    monkeypatch.setattr(D, "time", clock)
    monkeypatch.setattr(jD, "time", clock)
    return names


def assert_same(ours, theirs, path="sample", scene=None):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), (path, set(ours) ^ set(theirs))
        scene = theirs.get("scene_name", scene)
        for k in theirs:
            assert_same(ours[k], theirs[k], f"{path}/{k}", scene)
        return
    if isinstance(theirs, str):
        assert ours == theirs, path
        return
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, path
    if path.endswith(("poses", "Ks")) and "dtu" in scene:
        np.testing.assert_allclose(ours, theirs, rtol=1e-6,
                                   atol=1e-6 * np.abs(theirs).max(),
                                   err_msg=path)
    else:
        np.testing.assert_array_equal(ours, theirs, err_msg=path)


@pytest.mark.parametrize("family", TRAIN)
@pytest.mark.parametrize("use_src_imgs", [False, True])
def test_train_samples_equal_jax(data_root, family, use_src_imgs):
    cfg = {**SMALL, "train_database_types": [family],
           "use_src_imgs": use_src_imgs}
    ours, theirs = D.GeneralRendererDataset(cfg, True), \
        jD.GeneralRendererDataset(cfg, True)
    assert len(ours) == len(theirs)
    for index in (0, 5):
        sample = ours[index]
        assert_same(sample, theirs[index])
        assert sample["scene_name"] == data_root[family]
        assert ("src" in sample) == use_src_imgs
        assert "depth_loss_coords" in sample or family != "gso"


@pytest.mark.parametrize("family", TRAIN + ["llff_colmap", "nerf_synthetic"])
@pytest.mark.parametrize("use_src_imgs", [False, True])
def test_eval_samples_equal_jax(data_root, family, use_src_imgs):
    cfg = {"val_database_name": data_root[family],
           "use_src_imgs": use_src_imgs}
    ours, theirs = D.GeneralRendererDataset(cfg, False), \
        jD.GeneralRendererDataset(cfg, False)
    assert len(ours) == len(theirs) > 0
    assert_same(ours[0], theirs[0])


def test_the_mixture_draws_alike(data_root):
    """The weighted family draw over all five families at once."""
    cfg = {**SMALL, "train_database_types": TRAIN,
           "type2sample_weights": {"gso": 80, "dtu_train": 20,
                                   "real_iconic": 10, "space": 20,
                                   "real_estate": 40}}
    ours, theirs = D.GeneralRendererDataset(cfg, True), \
        jD.GeneralRendererDataset(cfg, True)
    np.testing.assert_array_equal(ours.database_weights,
                                  theirs.database_weights)
    seen = set()
    for index in range(6):
        a, b = ours[index], theirs[index]
        assert_same(a, b)
        seen.add(a["scene_name"])
    assert len(seen) >= 2


@pytest.mark.parametrize("seed", range(4))
def test_real_estate_selection_equals_jax(seed):
    ids = [str(1000 * (i + 1)) for i in range(80)]
    a = D.select_train_ids_for_real_estate(ids, np.random.RandomState(seed))
    b = jD.select_train_ids_for_real_estate(ids, np.random.RandomState(seed))
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("seed", range(3))
def test_add_depth_offset_equals_jax(seed):
    rng = np.random.RandomState(seed)
    depth = rng.rand(20, 30).astype(np.float32) + 2
    mask = rng.rand(20, 30) > 0.3
    ours, theirs = depth.copy(), depth.copy()
    D.add_depth_offset(ours, mask, 0.05, 0.1, 0.5, 1.0, 0.1, 3.0,
                       np.random.RandomState(seed))
    jD.add_depth_offset(theirs, mask, 0.05, 0.1, 0.5, 1.0, 0.1, 3.0,
                        np.random.RandomState(seed))
    np.testing.assert_array_equal(ours, theirs)


def test_finetuning_dataset_equals_jax(data_root):
    cfg = {"database_name": data_root["nerf_synthetic"],
           "database_split": "val_all"}
    for is_train in (True, False):
        ours = D.FinetuningRendererDataset(cfg, is_train)
        theirs = jD.FinetuningRendererDataset(cfg, is_train)
        assert len(ours) == len(theirs)
        assert (ours.train_ids, ours.val_ids) == (theirs.train_ids,
                                                  theirs.val_ids)
        assert ours[3] == theirs[3]
    assert D.name2dataset.keys() == jD.name2dataset.keys()


def test_build_render_imgs_info_equals_jax():
    from neuray_tpu.data import imgs_info as jI
    from neuray_tpu_torch.data import imgs_info as I
    rng = np.random.RandomState(0)
    pose, K = rng.randn(3, 4), rng.randn(3, 3)
    ours = I.build_render_imgs_info(pose, K, (5, 7), (2.0, 6.0))
    theirs = jI.build_render_imgs_info(pose, K, (5, 7), (2.0, 6.0))
    assert ours.keys() == theirs.keys() and ours["shape"] == theirs["shape"]
    for k in ("poses", "Ks", "coords", "depth_range"):
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])
