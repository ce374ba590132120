"""Every entry point of the port runs its f32 paths in full f32: each
CLI's ``main`` (render, training, eval, the reference converter) turns
TF32 off in cuBLAS and cuDNN (``utils/device.py: full_f32``) before it
builds a model, whatever the process had set, and importing the port
changes neither flag (a library caller's process is theirs).

Each test starts with both flags on (``monkeypatch``, undone after).
The render, eval and converter mains run for real on the CPU on a
fabricated 32x32 NeRF-synthetic scene (one eval view, 8 + 8 samples, the
trained ``tools/bench_weights.npz``); the training main's trainer is
replaced by a stand-in that reads the flags where the real one would
build its model.
"""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from neuray_tpu_torch import convert_reference_ckpt as pconvert
from neuray_tpu_torch import eval as peval
from neuray_tpu_torch import render as prender
from neuray_tpu_torch import run_training as ptrain
from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
from neuray_tpu_torch.selfcheck import write_cfg, write_gen_checkpoint
from neuray_tpu_torch.utils.params import load_params_npz

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DATABASE = "nerf_synthetic/toy/black_800"
CFG = {"name": "f32_gen", "init_net_type": "depth",
       "use_hierarchical_sampling": True, "depth_sample_num": 8,
       "fine_depth_sample_num": 8, "dist_decoder_cfg": {"use_vis": False},
       "fine_dist_decoder_cfg": {"use_vis": False}}


def flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_on(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert flags() == (True, True)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A scene and the gen model's checkpoint under one working
    directory."""
    work = tmp_path_factory.mktemp("f32")
    write_nerf_synthetic_sphere(str(work / "data"), 10, 32, "toy", 1)
    write_gen_checkpoint(work / "data" / "model", CFG, load_params_npz(
        str(ROOT / "tools" / "bench_weights.npz")))
    write_cfg(work / "gen.yaml", CFG)
    return work


def test_importing_the_port_sets_no_flag():
    """Every module of the port imported in a fresh process whose flags
    are on (a fresh process: re-importing modules here would redefine
    the classes other tests hold)."""
    names = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                   for p in (ROOT / "neuray_tpu_torch").rglob("*.py"))
    code = ("import importlib, torch\n"
            "torch.backends.cuda.matmul.allow_tf32 = True\n"
            "torch.backends.cudnn.allow_tf32 = True\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "print(torch.backends.cuda.matmul.allow_tf32,"
            " torch.backends.cudnn.allow_tf32)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["True", "True"]
    assert len(names) > 50


def test_render_and_eval_mains_run_in_full_f32(tf32_on, work, monkeypatch):
    monkeypatch.chdir(work)
    monkeypatch.setattr(DB, "DATA_ROOT", str(work / "data"))
    prender.main(["--database_name", DATABASE, "--cfg", "gen.yaml",
                  "--ray_num", "256", "--device", "cpu"])
    assert flags() == (False, False)
    out = work / "data" / "render" / DATABASE.replace("/", "_")
    assert (out / "f32_gen-eval" / "0-nr_fine.jpg").exists()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    peval.main(["--dir_pr", str(out / "f32_gen-eval"), "--dir_gt",
                str(out / "gt"), "--device", "cpu"])
    assert flags() == (False, False)


@pytest.mark.parametrize("cfg", [{"train_dataset_type": "gen"},
                                 {"network": "neuray_ft"}])
def test_training_main_turns_tf32_off_before_the_model(tf32_on, work,
                                                       monkeypatch, cfg):
    seen = []

    class StandIn:
        def __init__(self, cfg, device):
            seen.append(flags())

        def run(self):
            return None

    from neuray_tpu_torch.train import ft_trainer, trainer
    monkeypatch.setattr(trainer, "Trainer", StandIn)
    monkeypatch.setattr(ft_trainer, "FtTrainer", StandIn)
    ptrain.main(["--cfg", write_cfg(work / "train.yaml", {**CFG, **cfg}),
                 "--device", "cpu"])
    assert seen == [(False, False)] and flags() == (False, False)


def test_converter_main_turns_tf32_off(tf32_on, work, tmp_path):
    """On a reference file of random weights with the config's modules
    (``tests/test_torch_port_reference_ckpt.py``'s reference-named
    modules)."""
    from neuray_tpu_torch.utils.reference_ckpt import gen_flags
    from tests.test_torch_port_reference_ckpt import reference_sd
    torch.save({"network_state_dict": reference_sd(gen_flags(CFG)),
                "step": 0}, tmp_path / "model_best.pth")
    pconvert.main(["--torch_ckpt", str(tmp_path / "model_best.pth"),
                   "--cfg", str(work / "gen.yaml"), "--out",
                   str(tmp_path / "out")])
    assert flags() == (False, False)
    assert (tmp_path / "out" / "ckpt_best.pt").exists()
