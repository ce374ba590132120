"""The port's finetuning trainer (``neuray_tpu_torch/train/ft_trainer.py``)
on the CPU, mirroring ``tests/test_ft_trainer.py``, ``tests/test_ft.py``
and ``tests/test_ft_from_gen.py``: a run from scratch that validates,
checkpoints and resumes strictly and moves exactly the ray_feats of the
views its steps selected; the init from a generalization checkpoint;
the options that are not ported; and phase 9's configuration in
``chip_smoke.py`` against the shipped YAML files.

Scene: the fabricated NeRF-synthetic sphere at 32x32, 6 train views; 3
reference views a step, 16 rays, 8 + 8 samples.
"""
import os

import pytest
import torch

import chip_smoke
from neuray_tpu.utils.config import load_cfg

from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
from neuray_tpu_torch.models import ft as F
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.train.ft_trainer import FtTrainer
from neuray_tpu_torch.utils.params import load_flax_params, load_params_npz
from tests.test_torch_port_train import ROOT

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ft_trainer"))
    write_nerf_synthetic_sphere(root, n_train=6, size=32)
    return root


@pytest.fixture(autouse=True)
def _data_root(scene_root, monkeypatch):
    monkeypatch.setattr(DB, "DATA_ROOT", scene_root)


def make_cfg(out, total_step=3, **over):
    return {
        "name": "ft_smoke", "database_name": "nerf_synthetic/sphere/black_800",
        "database_split": "val_all", "gen_cfg": None, "use_validation": True,
        "validate_initialization": False, "neighbor_view_num": 3,
        "train_ray_num": 16, "ray_feats_res": [8, 8], "ray_feats_dim": 32,
        "use_self_hit_prob": True, "use_hierarchical_sampling": True,
        "depth_sample_num": 8, "fine_depth_sample_num": 8,
        "ray_batch_num": 512, "ray_mask_point_num": 4,
        "dist_decoder_cfg": {"use_vis": False}, "loss": ["render", "consist"],
        "use_nr_fine_loss": True, "val_metric": ["psnr_ssim"],
        "key_metric_name": "psnr_nr_fine", "total_step": total_step,
        "train_log_step": 2, "val_interval": 3, "save_interval": 3,
        "output_root": str(out), **over}


def test_ft_trainer_runs_validates_and_resumes(tmp_path):
    """3 steps from scratch, validation and both checkpoints at step 3,
    then a strict resume to 5 that continues the update count; only the
    views the steps selected (references and queries) move their
    ray_feats."""
    trainer = FtTrainer(make_cfg(tmp_path), device="cpu")
    selected, sample = [], trainer.ft.sample_train_indices

    def spy(rng):
        que_i, ref_idx = sample(rng)
        selected.append({int(que_i), *map(int, ref_idx)})
        return que_i, ref_idx

    trainer.ft.sample_train_indices = spy
    trainer.ft.init_params()
    before = trainer.ft.ray_feats.detach().clone()
    trainer.ft.init_params = lambda: None       # keep the state just read
    ft = trainer.run()
    for f in ("ckpt.pt", "ckpt_best.pt", "train.txt", "val.txt"):
        assert os.path.exists(f"{trainer.model_dir}/{f}"), f
    with open(f"{trainer.model_dir}/val.txt") as f:
        assert "step 3" in f.read()
    moved = (ft.ray_feats.detach() != before).flatten(1).any(1)
    assert set(torch.nonzero(moved).flatten().tolist()) == set().union(
        *selected)

    trainer2 = FtTrainer(make_cfg(tmp_path, 5), device="cpu")
    ft2 = trainer2.run()
    state = torch.load(f"{trainer2.model_dir}/ckpt.pt", weights_only=True)
    assert state["step"] == 5 and state["opt_count"] == 5
    assert set(state["params"]) == set(ft2.state_dict())
    assert all(torch.isfinite(p).all() for p in ft2.parameters())
    with open(f"{trainer2.model_dir}/train.txt") as f:
        log = f.read()
    assert "step 2" in log and "step 4" in log


def test_ft_resume_refuses_a_mismatched_optimizer_state(tmp_path):
    trainer = FtTrainer(make_cfg(tmp_path, 2, val_interval=10),
                        device="cpu")
    trainer.run()
    path = f"{trainer.model_dir}/ckpt.pt"
    state = torch.load(path, weights_only=True)
    first = next(iter(state["opt_state"]["state"].values()))
    first["exp_avg"] = first["exp_avg"][..., :1]
    torch.save(state, path)
    with pytest.raises(ValueError, match="resume_reset_opt"):
        FtTrainer(make_cfg(tmp_path, 3, val_interval=10), device="cpu").run()
    trainer2 = FtTrainer(make_cfg(tmp_path, 3, val_interval=10,
                                  resume_reset_opt=True), device="cpu")
    trainer2.run()
    after = torch.load(path, weights_only=True)
    assert after["step"] == 3 and after["opt_count"] == 1


GEN_CFG = dict(name="toy_gen", init_net_type="depth",
               use_hierarchical_sampling=True, depth_sample_num=8,
               fine_depth_sample_num=8, dist_decoder_cfg={"use_vis": False})


def save_gen(out, weights, fn="ckpt.pt", scale=1.0):
    """The gen model of ``GEN_CFG`` with the trained weights (times
    ``scale``), saved as the port's ``Trainer._save`` saves it."""
    gen = R.NeurayRenderer(R.RenderConfig.from_cfg(GEN_CFG))
    load_flax_params(gen, weights)
    with torch.no_grad():
        for p in gen.parameters():
            p.mul_(scale)
    os.makedirs(f"{out}/{GEN_CFG['name']}", exist_ok=True)
    torch.save({"step": 0, "best_metric": 0.0, "params": gen.state_dict(),
                "opt_state": torch.optim.Adam(gen.parameters()).state_dict(),
                "opt_count": 0}, f"{out}/{GEN_CFG['name']}/{fn}")
    return gen


def test_ft_init_from_gen_checkpoint(tmp_path):
    """ray_feats from the checkpoint's init net, the other modules copied
    verbatim, no init net; ``ckpt_best.pt`` before ``ckpt.pt``."""
    weights = load_params_npz(str(ROOT / "tools" / "bench_weights.npz"))
    save_gen(tmp_path, weights, scale=0.5)
    gen = save_gen(tmp_path, weights, "ckpt_best.pt")
    ft = F.FtRenderer(make_cfg(tmp_path, gen_cfg=GEN_CFG, init_view_num=4),
                      device="cpu")
    ft.init_params()
    n = len(ft.ref_ids)
    assert ft.ray_feats.shape == (n, 8, 8, 32)
    torch.testing.assert_close(ft.ray_feats.detach(),
                               ft.init_ray_feats_from_gen(gen), rtol=0,
                               atol=0)
    assert not hasattr(ft.net, "init_net")
    gen_state = gen.state_dict()
    for k, v in ft.net.state_dict().items():
        torch.testing.assert_close(v, gen_state[k], rtol=0, atol=0)
    assert {k for k in gen_state if not k.startswith("init_net.")} == set(
        ft.net.state_dict())


@pytest.mark.parametrize("over,error,match", [
    ({"val_metric": ["psnr_ssim", "no_such_metric"]}, NotImplementedError,
     "no_such_metric"),
    ({"n_devices": 2}, ValueError, "torchrun --nproc_per_node 2"),
    ({"use_bf16": True}, NotImplementedError, "f32 only")])
def test_unported_options_raise(tmp_path, over, error, match):
    with pytest.raises(error, match=match):
        FtTrainer(make_cfg(tmp_path, **over), device="cpu")


@pytest.mark.parametrize("gen_cfg,error", [
    ("configs/gen/no_such_config.yaml", FileNotFoundError)])
def test_unported_gen_inits_raise(tmp_path, gen_cfg, error):
    """A gen_cfg path is read with the port's YAML reader; one that names
    no file raises."""
    ft = F.FtRenderer(make_cfg(tmp_path, gen_cfg=gen_cfg), device="cpu")
    with pytest.raises(error):
        ft.init_params()


def test_ft_needs_a_device(tmp_path, monkeypatch):
    """Finetuning runs on the card unless the caller asks for the CPU;
    without one it raises rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FtTrainer(make_cfg(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        F.FtRenderer(make_cfg(tmp_path))
    assert FtTrainer(make_cfg(tmp_path), device="cpu").device.type == "cpu"


def test_ft_renderer_has_no_init_net(tmp_path):
    ft = F.FtRenderer(make_cfg(tmp_path), device="cpu")
    assert ft.render_cfg.init_net_type == ""
    with pytest.raises(ValueError, match="no init net"):
        ft.net.initialize_ray_feats({})


# ---------------- phase 9's configuration ----------------

def test_chip_smoke_ft_profile_is_the_shipped_config():
    """chip_smoke.py phase 9 finetunes the fields of
    configs/train/ft/neuray_ft_depth_lego.yaml, cut only where
    ``FT_CUTS`` says, from the parsed configs/gen/neuray_gen_depth.yaml
    (the card's machine has no yaml)."""
    cfg = load_cfg(str(ROOT / "configs" / "train" / "ft" /
                       "neuray_ft_depth_lego.yaml"))
    profile = chip_smoke.FT_PROFILE
    assert set(profile) == set(cfg) - set(chip_smoke.FT_CUTS)
    cfg_gen = dict(cfg, gen_cfg=load_cfg(str(ROOT / cfg["gen_cfg"])))
    for k, v in profile.items():
        assert v == cfg_gen[k], k
    assert profile["gen_cfg"] is chip_smoke.GEN_PROFILE
    assert chip_smoke.GEN_PROFILE == load_cfg(
        str(ROOT / "configs" / "gen" / "neuray_gen_depth.yaml"))
    rc = R.RenderConfig.from_cfg({**profile, **chip_smoke.FT_CUTS})
    assert rc == R.RenderConfig.from_cfg(cfg)
    assert (rc.use_self_hit_prob, rc.depth_sample_num,
            rc.fine_depth_sample_num, rc.use_vis, rc.fine_use_vis,
            rc.use_hierarchical_sampling) == (True, 64, 64, False, False, True)
    cut = {**F.FT_DEFAULT_CFG, **profile, **chip_smoke.FT_CUTS}
    assert (cut["train_ray_num"], cut["neighbor_view_num"],
            cut["neighbor_pool_ratio"], cut["ray_feats_dim"]) == (
        512, 8, 2, 32)
