"""The cost-volume path around the model: the source-view selection
``build_src_imgs_info_select`` and finetuning's ray features from a
cost-volume gen model, against the JAX package's; the init from a
cost-volume gen checkpoint; and phases 10-11 of ``chip_smoke.py``
against the shipped configs and ``tools/bench_cost_volume.py``'s scene.

Scene: the port's fabricated NeRF-synthetic sphere
(``data/synthetic.write_nerf_synthetic_sphere``), 8 train views at
64x64, read by both packages (JAX through cv2). The gen model's weights
are ``tools/bench_weights_cv.npz`` with MVSNet's last conv sharpened
(``tests/test_torch_port_cost_volume.py: SHARP``: the shipped MVSNet is
at its initialization, and its flat volume makes G' a function of f32
rounding). The JAX side runs at "highest" matmul precision. Tolerances:
the data layer bit for bit, ray features 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from neuray_tpu.data import database as jDB
from neuray_tpu.data import synthetic as jSyn
from neuray_tpu.data import train_dataset as jD
from neuray_tpu.models import ft as jF
from neuray_tpu.models import renderer as jR
from neuray_tpu.utils.config import load_cfg

from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data import train_dataset as D
from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
from neuray_tpu_torch.models import cost_volume as CV
from neuray_tpu_torch.models import ft as F
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.utils.params import load_flax_params
from tests.test_torch_port_cost_volume import SHARP, WEIGHTS, nearest_others
from tests.test_torch_port_ft import CFG
from tests.test_torch_port_train import ROOT

torch.set_num_threads(1)

SIZE, N_TRAIN = 64, 8
DB_NAME = "nerf_synthetic/sphere/black_800"
GEN_CFG = dict(name="gen_cv", init_net_type="cost_volume",
               use_hierarchical_sampling=True, depth_sample_num=8,
               fine_depth_sample_num=8, dist_decoder_cfg={"use_vis": False})


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The scene folder with both packages' DATA_ROOT on it."""
    root = str(tmp_path_factory.mktemp("cv_ft"))
    write_nerf_synthetic_sphere(root, n_train=N_TRAIN, size=SIZE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DB, "DATA_ROOT", root)
        mp.setattr(jDB, "DATA_ROOT", root)
        yield root


@pytest.fixture(scope="module")
def sharp():
    """``bench_weights_cv.npz`` with MVSNet's last conv kernel times
    ``SHARP``."""
    from neuray_tpu_torch.utils.params import load_params_npz
    tree = load_params_npz(str(WEIGHTS))
    cr = tree["params"]["init_net"]["mvsnet"]["cost_regularization"]
    cr["prob"]["kernel"] = cr["prob"]["kernel"] * np.float32(SHARP)
    return tree


# ---------------- source-view selection ----------------

@pytest.mark.parametrize("pad_interval,nn", [(-1, 3), (32, 2)])
def test_build_src_imgs_info_select_equals_jax(scene, pad_interval, nn):
    """The union of 3 ref views and their nn nearest train views, its
    index arrays and every array of its imgs_info, bit for bit."""
    jdb, db = (m.parse_database_name(DB_NAME) for m in (jDB, DB))
    ids_all, _ = DB.get_database_split(db, "val_all")
    ref_ids = [ids_all[i] for i in (5, 0, 3)]
    theirs = jD.build_src_imgs_info_select(jdb, ref_ids, ids_all, nn,
                                           pad_interval)
    ours = D.build_src_imgs_info_select(db, ref_ids, ids_all, nn,
                                        pad_interval)
    np.testing.assert_array_equal(ours[1], theirs[1])
    np.testing.assert_array_equal(ours[2], theirs[2])
    assert ours[1].shape == (3, nn)
    assert set(ours[0]) == set(theirs[0])
    for k, v in theirs[0].items():
        assert ours[0][k].dtype == v.dtype, k
        np.testing.assert_array_equal(ours[0][k], v, err_msg=k)
    # each ref is itself in the union, and never its own source view
    assert (ours[1] != ours[2][:, None]).all()
    n_union = ours[0]["imgs"].shape[0]
    assert n_union == len(set(ours[2]) | set(ours[1].ravel()))


# ---------------- finetuning from a cost-volume gen model ----------------

@pytest.fixture(scope="module")
def init_feats(scene, sharp):
    """Each package's ray_feats from the cost-volume gen model's init net
    (each view alone as the ref, its 3 nearest views as the src)."""
    cfg = {**CFG, "gen_cfg": GEN_CFG}
    gen_j = jR.NeurayRenderer(jR.RenderConfig.from_cfg(GEN_CFG))
    with jax.default_matmul_precision("highest"):
        theirs = np.asarray(jF.FtRenderer(dict(cfg)).init_ray_feats_from_gen(
            gen_j, sharp))
    gen = R.NeurayRenderer(R.RenderConfig.from_cfg(GEN_CFG))
    load_flax_params(gen, sharp)
    ft = F.FtRenderer(dict(cfg), device="cpu")
    return ft.init_ray_feats_from_gen(gen.eval()).numpy(), theirs


def test_init_ray_feats_from_cost_volume_gen_matches_jax(init_feats):
    ours, theirs = init_feats
    assert ours.shape == theirs.shape == (N_TRAIN, SIZE // 4, SIZE // 4, 32)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)


def test_cost_volume_init_params_from_a_checkpoint(scene, sharp, tmp_path,
                                                   monkeypatch):
    """``init_params`` with a cost-volume ``gen_cfg`` reads the checkpoint
    that ``chip_smoke.write_gen_checkpoint`` writes: the FT net takes every
    module but the init net, and ray_feats are the gen init net's, each
    view at eval size (``is_train`` False) with nn_ids arange(3) into its
    3 nearest other views."""
    chip_smoke.write_gen_checkpoint(sharp, tmp_path, GEN_CFG)
    ft = F.FtRenderer({**CFG, "gen_cfg": GEN_CFG,
                       "output_root": str(tmp_path)}, device="cpu")
    calls, build = [], CV.CostVolumeInitNet.build_cost_volume

    def spy(self, ref, src, is_train=False):
        calls.append((ref["nn_ids"].tolist(), src["poses"].clone(), is_train,
                      ref["poses"].clone()))
        return build(self, ref, src, is_train)

    monkeypatch.setattr(CV.CostVolumeInitNet, "build_cost_volume", spy)
    ft.init_params()
    assert len(calls) == N_TRAIN
    for i, (nn_ids, src_poses, is_train, ref_poses) in enumerate(calls):
        assert nn_ids == [[0, 1, 2]] and not is_train
        near = ft.ref_dist_idx[i][1:4]
        assert torch.equal(src_poses, ft.ref_store["poses"][near])
        assert torch.equal(ref_poses, ft.ref_store["poses"][i:i + 1])
    gen = R.NeurayRenderer(R.RenderConfig.from_cfg(GEN_CFG))
    load_flax_params(gen, sharp)
    monkeypatch.setattr(CV.CostVolumeInitNet, "build_cost_volume", build)
    torch.testing.assert_close(ft.ray_feats.detach(),
                               ft.init_ray_feats_from_gen(gen.eval()),
                               rtol=0, atol=0)
    state = gen.state_dict()
    for k, v in ft.net.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)
    assert not any(k.startswith("init_net") for k in ft.net.state_dict())


# ---------------- phases 10 and 11 of chip_smoke.py ----------------

def test_chip_smoke_cv_profile_is_the_shipped_config():
    """Phase 10 renders configs/gen/neuray_gen_cost_volume.yaml, cut only
    to CHUNK-ray chunks; its bench route adds bench.py's bf16 + u8 and
    focus fields."""
    cfg = load_cfg(str(ROOT / "configs" / "gen" /
                       "neuray_gen_cost_volume.yaml"))
    assert chip_smoke.GEN_CV_PROFILE == cfg
    rc = R.RenderConfig(**chip_smoke.CV_PROFILE)
    assert rc == dataclasses.replace(R.RenderConfig.from_cfg(cfg),
                                     ray_batch_num=chip_smoke.CHUNK)
    assert (rc.init_net_type, rc.cost_volume_sn, rc.depth_sample_num,
            rc.fine_depth_sample_num) == ("cost_volume", 64, 64, 64)
    bench = R.RenderConfig(**chip_smoke.CV_BENCH_PROFILE)
    for f in ("use_bf16", "gather_quant", "probe_sample_num",
              "focus_sample_num", "focus_fine_sample_num"):
        assert getattr(bench, f) == chip_smoke.BENCH_PROFILE[f], f
    assert dataclasses.replace(
        bench, use_bf16=False, gather_quant="none", probe_sample_num=16,
        focus_sample_num=16, focus_fine_sample_num=32) == rc
    assert R.u8_map_supported(chip_smoke.CV_H, chip_smoke.CV_W,
                              chip_smoke.CV_H // 4, chip_smoke.CV_W // 4)


def test_chip_smoke_ft_cv_profile_is_the_shipped_config():
    """Phase 11 finetunes the fields of configs/train/ft/neuray_ft_cv_lego
    .yaml, cut only where ``FT_CUTS`` says, from the parsed
    configs/gen/neuray_gen_cost_volume.yaml."""
    cfg = load_cfg(str(ROOT / "configs" / "train" / "ft" /
                       "neuray_ft_cv_lego.yaml"))
    profile = chip_smoke.FT_CV_PROFILE
    assert set(profile) == set(cfg) - set(chip_smoke.FT_CUTS)
    cfg_gen = dict(cfg, gen_cfg=load_cfg(str(ROOT / cfg["gen_cfg"])))
    for k, v in profile.items():
        assert v == cfg_gen[k], k
    assert profile["gen_cfg"] is chip_smoke.GEN_CV_PROFILE
    rc = R.RenderConfig.from_cfg({**profile, **chip_smoke.FT_CUTS})
    assert rc == R.RenderConfig.from_cfg(cfg)
    gen = R.RenderConfig.from_cfg(profile["gen_cfg"])
    assert (gen.init_net_type, gen.cost_volume_sn) == ("cost_volume", 64)


def test_chip_smoke_cv_scene_is_the_bench_tools_scene(monkeypatch):
    """``chip_smoke.cv_scene`` builds ``tools/bench_cost_volume.py``'s
    scene (there inline in ``main``) from the same seed: the views, their
    nn_ids (the 3 nearest other refs by camera centre), the query and its
    ground truth; at a small size here."""
    monkeypatch.setattr(chip_smoke, "CV_H", 48)
    monkeypatch.setattr(chip_smoke, "CV_W", 64)
    monkeypatch.setattr(chip_smoke, "CV_QH", 45)
    monkeypatch.setattr(chip_smoke, "CV_QW", 60)
    ref, src, que, gt = chip_smoke.cv_scene()
    rng = np.random.RandomState(0)
    views = [jSyn.look_at_camera(rng, 48, 64) for _ in range(chip_smoke.RFN)]
    imgs = np.stack([jSyn.render_sphere_view(p, K, 48, 64)[0]
                     for p, K in views])
    np.testing.assert_array_equal(ref["imgs"], imgs)
    np.testing.assert_array_equal(ref["poses"], np.stack([p for p, _ in
                                                          views]))
    np.testing.assert_array_equal(ref["nn_ids"], nearest_others(
        ref["poses"], chip_smoke.CV_NN))
    assert ref["nn_ids"].shape == (chip_smoke.RFN, 3)
    for k, v in src.items():
        assert v is ref[k]
    pose, K = jSyn.look_at_camera(rng, 45, 60)
    np.testing.assert_array_equal(que["poses"][0], pose)
    np.testing.assert_array_equal(gt, jSyn.render_sphere_view(pose, K, 45,
                                                              60)[0])
    assert que["coords"].shape == (1, 45 * 60, 2)
    np.testing.assert_array_equal(que["depth_range"][0],
                                  np.asarray(jSyn.DEPTH_RANGE, np.float32))


def test_warp_bound_counts_each_volume_once():
    """homo_warp's bytes bound: 24 source maps read and 24 volumes written
    once, f32, over the HBM rate."""
    c, dn, h, w = chip_smoke.CV_WARP_SHAPE
    assert (c, dn, h, w) == (32, 64, 768 * 3 // 4 // 4, 1024 * 3 // 4 // 4)
    nbytes = 24 * 4 * (c * h * w + c * dn * h * w)
    assert chip_smoke.warp_bound_ms(24) == pytest.approx(
        1e3 * nbytes / chip_smoke.HBM_BYTES_PER_S)
    assert chip_smoke.warp_bound_ms(24) == pytest.approx(1.6480, abs=1e-4)
