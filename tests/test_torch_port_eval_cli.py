"""The port's eval CLI (``python -m neuray_tpu_torch.eval``) against the
root ``eval.py``, as ``tests/test_eval_cli.py`` holds the latter: on the
same files both print the same lines (per image, then the means), with
the LPIPS weights absent (the same refusal text) and with fabricated
weight files of the real state-dict keys (LPIPS within 1e-6 of
``eval.LpipsVgg``); a gray JPEG is read as ``cv2.imread``'s IMREAD_COLOR
reads it (3 channels).
"""
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import torch.nn as nn

from neuray_tpu_torch import eval as E

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def write_pairs(tmp, n=3, size=24, gray_pr=()):
    """n GT / prediction JPEG pairs written by cv2 (the predictions
    listed in gray_pr as gray JPEGs); one GT without a prediction."""
    pr_dir, gt_dir = tmp / "pr", tmp / "gt"
    pr_dir.mkdir()
    gt_dir.mkdir()
    rng = np.random.RandomState(0)
    for k in range(n + 1):
        gt = (rng.rand(size, size, 3) * 255).astype(np.uint8)
        pr = np.clip(gt.astype(np.int16) + rng.randint(-12, 12, gt.shape),
                     0, 255).astype(np.uint8)
        cv2.imwrite(str(gt_dir / f"{k}.jpg"), gt[:, :, ::-1])
        if k == n:
            continue
        cv2.imwrite(str(pr_dir / f"{k}-nr_fine.jpg"),
                    pr[..., 1] if k in gray_pr else pr[:, :, ::-1])
    return pr_dir, gt_dir


def run(tmp, script, pr_dir, gt_dir, env):
    cmd = ([sys.executable, str(ROOT / "eval.py")] if script == "jax" else
           [sys.executable, "-m", "neuray_tpu_torch.eval", "--device",
            "cpu"])
    proc = subprocess.run(
        cmd + ["--dir_pr", str(pr_dir), "--dir_gt", str(gt_dir)],
        capture_output=True, text=True, cwd=str(tmp), timeout=300,
        env={**env, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def no_weights_env(tmp):
    env = {k: v for k, v in os.environ.items()
           if k not in ("NEURAY_VGG16_WEIGHTS", "NEURAY_LPIPS_WEIGHTS")}
    env["TORCH_HOME"] = str(tmp / "nothing")
    return env


def test_eval_cli_prints_eval_py_lines(tmp_path):
    pr_dir, gt_dir = write_pairs(tmp_path, gray_pr=(1,))
    env = no_weights_env(tmp_path)
    ours = run(tmp_path, "port", pr_dir, gt_dir, env)
    theirs = run(tmp_path, "jax", pr_dir, gt_dir, env)
    assert ours == theirs
    lines = ours.splitlines()
    assert lines[0].startswith("LPIPS unavailable: missing local weight "
                               "files: VGG16 backbone (set "
                               "NEURAY_VGG16_WEIGHTS)")
    assert [ln.split()[0] for ln in lines[1:]] == ["0", "1", "2", "psnr",
                                                    "ssim", "lpips"]
    assert lines[-1] == "lpips unavailable (see reason above)"
    assert "nan" not in ours


def test_gray_jpeg_reads_as_imread_color(tmp_path):
    from neuray_tpu_torch.utils.imageio import imread_color
    img = (np.random.RandomState(1).rand(17, 23) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "g.jpg"), img)
    ours = imread_color(tmp_path / "g.jpg")
    np.testing.assert_array_equal(
        ours, cv2.imread(str(tmp_path / "g.jpg"))[:, :, ::-1])
    assert ours.shape == (17, 23, 3)


@pytest.fixture()
def fake_weights(tmp_path, monkeypatch):
    """Random VGG16 and lin weight files with the real state-dict keys,
    named by the environment keys both CLIs read."""
    torch.manual_seed(0)
    layers, in_ch = [], 3
    for out_ch, n_convs in E._VGG_BLOCKS:
        for _ in range(n_convs):
            layers += [nn.Conv2d(in_ch, out_ch, 3, padding=1), nn.ReLU()]
            in_ch = out_ch
        layers.append(nn.MaxPool2d(2, 2))
    vgg_fn, lin_fn = tmp_path / "vgg16.pth", tmp_path / "lpips_vgg.pth"
    torch.save({f"features.{k}": v for k, v in
                nn.Sequential(*layers).state_dict().items()}, vgg_fn)
    torch.save({f"lin{i}.model.1.weight": torch.rand(1, ch, 1, 1)
                for i, (ch, _) in enumerate(E._VGG_BLOCKS)}, lin_fn)
    monkeypatch.setenv("NEURAY_VGG16_WEIGHTS", str(vgg_fn))
    monkeypatch.setenv("NEURAY_LPIPS_WEIGHTS", str(lin_fn))
    return dict(os.environ)


def test_lpips_equals_eval_py(tmp_path, fake_weights):
    from tests.test_eval_cli import _repo_eval
    ours, theirs = E.LpipsVgg("cpu"), _repo_eval().LpipsVgg()
    assert ours.ok and theirs.ok
    rng = np.random.RandomState(3)
    a = (rng.rand(64, 48, 3) * 255).astype(np.uint8)
    b = np.clip(a.astype(np.int16) + rng.randint(-30, 30, a.shape), 0,
                255).astype(np.uint8)
    assert ours(a, b) == pytest.approx(theirs(a, b), abs=1e-6)
    assert ours(a, a) == pytest.approx(0.0, abs=1e-9)
    pr_dir, gt_dir = write_pairs(tmp_path, n=2, size=32)
    assert run(tmp_path, "port", pr_dir, gt_dir, fake_weights) == \
        run(tmp_path, "jax", pr_dir, gt_dir, fake_weights)
