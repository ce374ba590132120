"""The port's training CLI, ``python -m neuray_tpu_torch.run_training``, on
the CPU (``--device cpu``): tiny copies of a shipped gen config
(``configs/train/gen/neuray_gen_depth_train.yaml``: the five-family
mixture, here the fabricated families on disk, and ``vis_img``) and of a
shipped FT config (``configs/train/ft/neuray_ft_depth_lego.yaml``) whose
``gen_cfg`` is the path of the gen run's config, each a few steps; both
write checkpoints and ``vis_val`` images. Also ``vis_img`` against the
JAX package's dump.
"""
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml

from neuray_tpu.train import metrics as jM
from neuray_tpu_torch.data import fabricate as F
from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
from neuray_tpu_torch.train import metrics as M
from neuray_tpu_torch.utils.imageio import imread

ROOT = Path(__file__).resolve().parents[1]
TINY_RENDER = {"depth_sample_num": 8, "fine_depth_sample_num": 8,
               "ray_batch_num": 2048, "ray_mask_point_num": 4}


def run_cli(cfg_path, data_root):
    env = {**os.environ, "NEURAY_DATA_ROOT": str(data_root),
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "neuray_tpu_torch.run_training", "--cfg",
         str(cfg_path), "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The gen CLI run: 2 steps on the fabricated families, a validation
    on two dtu scans (36x48: PNG dumps; 72x96: JPEG dumps)."""
    tmp = tmp_path_factory.mktemp("cli")
    data = tmp / "data"
    F.write_gso(str(data), size=24)
    F.write_dtu_train(str(data), n=10, h=36, w=48)
    F.write_dtu_train(str(data), name="scan2", n=10, h=72, w=96)
    F.write_real_iconic(str(data), n=10, h=128, w=192)
    F.write_space(str(data), n=10, h=36, w=60)
    write_nerf_synthetic_sphere(str(data), n_train=6, size=32)
    with open(ROOT / "configs/train/gen/neuray_gen_depth_train.yaml") as f:
        cfg = yaml.load(f, Loader=yaml.FullLoader)
    cfg.update(TINY_RENDER, name="tiny_gen", total_step=2, val_interval=2,
               save_interval=2, train_log_step=1, worker_num=0,
               output_root=str(tmp / "model"))
    cfg["train_dataset_cfg"].update(
        train_ray_num=32, depth_loss_coords_num=16, min_wn=3, max_wn=4,
        aug_forward_crop_size=[32, 40])
    cfg["val_set_list"] = [
        {"name": "small", "type": "gen",
         "cfg": {"val_database_name": "dtu_train/scan1", "min_wn": 3}},
        {"name": "large", "type": "gen",
         "cfg": {"val_database_name": "dtu_train/scan2", "min_wn": 3}}]
    path = tmp / "gen.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = run_cli(path, data)
    return tmp, path, out


def test_gen_cli_trains_validates_and_dumps(trained):
    tmp, _, out = trained
    model = tmp / "model" / "tiny_gen"
    assert (model / "ckpt.pt").exists() and (model / "ckpt_best.pt").exists()
    assert "train step 2" in out and "val-small step 2" in out
    for name, ext, shape in (("small", "png", (36, 48 * 3)),
                             ("large", "jpg", (72, 96 * 3))):
        dumps = sorted((model / "vis_val" / f"tiny_gen-{name}").iterdir())
        assert [p.name for p in dumps] == [f"step-2-index-{i}.{ext}"
                                           for i in range(2)]
        assert imread(dumps[0]).shape == (*shape, 3)


def test_ft_cli_from_a_gen_cfg_path(trained):
    """Finetuning whose gen_cfg is a YAML path (the gen run's config,
    read by the port's reader) starts from that run's checkpoint."""
    tmp, gen_path, _ = trained
    with open(ROOT / "configs/train/ft/neuray_ft_depth_lego.yaml") as f:
        cfg = yaml.load(f, Loader=yaml.FullLoader)
    assert isinstance(cfg["gen_cfg"], str)
    cfg.update(TINY_RENDER, gen_cfg=str(gen_path),
               database_name="nerf_synthetic/sphere/black_800",
               neighbor_view_num=3, init_view_num=4, train_ray_num=16,
               total_step=2, val_interval=2, save_interval=2,
               train_log_step=1, output_root=str(tmp / "model"))
    path = tmp / "ft.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = run_cli(path, tmp / "data")
    model = tmp / "model" / cfg["name"]
    assert (model / "ckpt.pt").exists()
    assert "val step 0" in out and "val step 2" in out
    dumps = sorted((model / "vis_val" / cfg["name"]).iterdir())
    assert {p.name for p in dumps} >= {"step-2-index-0.png"}


def test_cli_needs_a_device_or_the_cpu(tmp_path):
    """Without a card and without --device the CLI raises; it never falls
    back to the CPU on its own."""
    cfg = tmp_path / "c.yaml"
    cfg.write_text("name: x\ntrain_dataset_type: synthetic\n"
                   f"output_root: {tmp_path}\n")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "neuray_tpu_torch.run_training", "--cfg",
         str(cfg)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr


@pytest.mark.parametrize("size", [(32, 40), (65, 70)])
def test_vis_img_equals_jax(tmp_path, size):
    """The same side-by-side dump as the JAX package's: a PNG (equal to
    the pixel) at 64x64 and below, a JPEG above, the same file byte for
    byte (the port's encoder is libjpeg-turbo's path, as cv2's is)."""
    h, w = size
    rng = np.random.RandomState(0)
    y, x = np.mgrid[:h, :w]
    smooth = np.stack([0.5 + 0.4 * np.sin(x / 9 + k) * np.cos(y / 13)
                       for k in range(3)], -1).reshape(1, -1, 3)
    data_pr = {"pixel_colors_gt": smooth,
               "pixel_colors_nr": np.clip(smooth + 0.01 * rng.randn(
                   *smooth.shape), 0, 1),
               "pixel_colors_nr_fine": smooth}
    kw = dict(data_index=3, model_name="m")
    M.VisualizeImage({})(data_pr, {"que_shape": (h, w)}, 7,
                         output_root=str(tmp_path / "ours"), **kw)
    jM.VisualizeImage({})(data_pr, {"que_shape": (h, w)}, 7,
                          output_root=str(tmp_path / "theirs"), **kw)
    ext = "png" if max(h, w) <= 64 else "jpg"
    ours = imread(tmp_path / "ours" / "m" / f"step-7-index-3.{ext}")
    theirs = cv2.imread(str(tmp_path / "theirs" / "m" /
                            f"step-7-index-3.{ext}"))[..., ::-1]
    assert ours.shape == theirs.shape == (h, 3 * w, 3)
    np.testing.assert_array_equal(ours, theirs)
    if ext == "jpg":
        assert (tmp_path / "ours" / "m" / "step-7-index-3.jpg").read_bytes() \
            == (tmp_path / "theirs" / "m" / "step-7-index-3.jpg").read_bytes()


@pytest.mark.parametrize("cfg", ["neuray_gen_depth_train.yaml",
                                 "neuray_gen_cost_volume_train.yaml",
                                 "neuray_gen_depth_train_fast.yaml"])
def test_chip_smoke_cuts_only_what_it_names(tmp_path, cfg):
    """chip_smoke.py phases 12, 13 and 15a run the shipped gen configs
    with only their named cuts: the cut copy reads as the file with those
    keys set."""
    import chip_smoke
    from neuray_tpu_torch.utils.config import load_cfg
    src = ROOT / "configs" / "train" / "gen" / cfg
    assert ("fast" in cfg) == (f"configs/train/gen/{cfg}"
                               == chip_smoke.FAST_CLI_CFG)
    cuts = {**(chip_smoke.FAST_CLI_CUTS if "fast" in cfg
               else chip_smoke.GEN_CLI_CUTS), "output_root": str(tmp_path)}
    chip_smoke.cut_config(src, tmp_path / cfg, cuts)
    assert load_cfg(str(tmp_path / cfg)) == {**load_cfg(str(src)), **cuts}
