"""The port's input-pipeline bench (``python -m
neuray_tpu_torch.bench_input_pipeline``) against
``tools/bench_input_pipeline.py`` on the CPU: the fabricated GSO scene's
files hold the JAX tool's pixels (both read back by cv2) and its pose
and intrinsics text; two training samples of the port's
``GeneralRendererDataset`` on the port's scene equal the JAX package's on
the same scene, key for key (``tests/test_torch_port_gen_dataset.py:
assert_same``, the training seed's clock frozen in both); the bench's
rows and their keys, at one sample a row.
"""
import importlib.util
import os
import types
from pathlib import Path

import cv2
import numpy as np
import pytest

from neuray_tpu.data import database as jDB
from neuray_tpu.data import train_dataset as jD

from neuray_tpu_torch import bench_input_pipeline as B
from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data import train_dataset as D
from tests.test_torch_port_gen_dataset import assert_same

ROOT = Path(__file__).resolve().parents[1]


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_input_pipeline", ROOT / "tools" / "bench_input_pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fabricated_scene_equals_jax(tmp_path):
    views = 3
    B.fabricate_gso_scene(str(tmp_path / "port"), "obj0", views,
                          np.random.RandomState(0))
    jax_tool().fabricate_gso_scene(str(tmp_path / "jax"), "obj0", views,
                                   np.random.RandomState(0))
    ours = tmp_path / "port" / "google_scanned_objects" / "obj0"
    theirs = tmp_path / "jax" / "google_scanned_objects" / "obj0"
    for i in range(views):
        for sub in ("rgb", "mask", "depth"):
            a = cv2.imread(str(ours / sub / f"{i:06}.png"),
                           cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(theirs / sub / f"{i:06}.png"),
                           cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype and a.shape == b.shape, (sub, i)
            np.testing.assert_array_equal(a, b, err_msg=f"{sub} {i}")
        for sub in ("pose", "intrinsics"):
            name = f"{i:06}.txt"
            assert (ours / sub / name).read_text() == \
                (theirs / sub / name).read_text()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    B.fabricate_gso_scene(root, "obj0", 250, np.random.RandomState(0))
    return root


@pytest.mark.parametrize("index", [1, 2])
def test_samples_equal_jax(scene, monkeypatch, index):
    monkeypatch.setattr(DB, "DATA_ROOT", scene)
    monkeypatch.setattr(jDB, "DATA_ROOT", scene)
    clock = types.SimpleNamespace(time=lambda: 1_700_000_123.0)
    monkeypatch.setattr(D, "time", clock)
    monkeypatch.setattr(jD, "time", clock)
    cfg = {"train_database_types": ["gso"],
           "type2sample_weights": {"gso": 1}, "resolution_type": "hr"}
    theirs = jD.GeneralRendererDataset(cfg, is_train=True)[index]
    ours = B.gso_dataset()[index]
    assert_same(ours, theirs)


def test_rows(monkeypatch):
    monkeypatch.delenv("NEURAY_DATA_ROOT", raising=False)
    before = DB.DATA_ROOT
    rows = B.main(["--samples", "1", "--gil"])
    assert [r["mode"] for r in rows] == [
        "single_thread", "dataloader_w1", "dataloader_w2", "dataloader_w4",
        "gil_profile"]
    for r in rows[:4]:
        assert list(r) == ["mode", "sample_s", "samples_per_s"] + [
            "first_sample_s"] * (r["mode"] != "single_thread")
        assert r["samples_per_s"] > 0
    assert list(rows[4]) == ["mode", "spinner_idle_per_s",
                             "spinner_busy_per_s", "est_gil_released_frac",
                             "sample_s"]
    assert 0 <= rows[4]["est_gil_released_frac"] <= 1
    assert DB.DATA_ROOT == before and "NEURAY_DATA_ROOT" not in os.environ
