"""The port's render CLI in the auto skip modes, as
``tests/test_auto_reaudit.py`` holds the JAX package's: every frame is
audited, a later frame whose audit fails re-escalates the probe size, the
accepted size is sticky upward (no ladder re-climb on later frames), a
frame whose audit rejects every size switches the rest of the run to the
exact gate, and ``auto_audit.jsonl`` starts empty on every run. The
audit's outcome is scripted (``estimate_false_skip`` replaced), so the
test is of the control logic, on the fabricated 32x32 NeRF-synthetic
sphere with random weights (flax's initializers).
"""
import json

import pytest
import torch

from neuray_tpu_torch import render as prender
from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.selfcheck import write_cfg, write_gen_checkpoint

torch.set_num_threads(1)

DATABASE = "nerf_synthetic/toy/black_800"
OUT = "data/render/nerf_synthetic_toy_black_800/reaudit_gen-inter_4"
CFG = {
    "name": "reaudit_gen",
    "network": "neuray_gen",
    "init_net_type": "depth",
    "use_hierarchical_sampling": True,
    "depth_sample_num": 16,
    "fine_depth_sample_num": 16,
    "ray_batch_num": 1024,
    "dist_decoder_cfg": {"use_vis": False},
    "fine_dist_decoder_cfg": {"use_vis": False},
    "skip_empty_rays": True,
    "skip_empty_threshold": 0.05,
    "skip_mode": "auto",
    "probe_sample_num": 8,
}


@pytest.fixture()
def cli(tmp_path, monkeypatch):
    """The scene, a random-init checkpoint, cwd = tmp; returns a function
    that runs the CLI on frames [rb, re) of an inter_4 trajectory and
    returns the audit log's lines."""
    write_nerf_synthetic_sphere(str(tmp_path / "data"), 12, 32, "toy", 1)
    monkeypatch.setattr(DB, "DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.chdir(tmp_path)
    write_gen_checkpoint("data/model", CFG)
    cfg_path = write_cfg(tmp_path / "reaudit_gen.yaml", CFG)

    def run(rb=0, re=3):
        prender.main(["--database_name", DATABASE, "--cfg", cfg_path,
                      "--pose_type", "inter_4", "--ray_num", "1024",
                      "--rb", str(rb), "--re", str(re), "--device", "cpu"])
        try:
            with open(f"{OUT}/auto_audit.jsonl") as f:
                return [json.loads(line) for line in f]
        except FileNotFoundError:
            return []

    return run


def script_audit(monkeypatch, verdict):
    """Replace the audit: verdict(psn, calls so far) -> the false-skip
    rate; returns the list of (psn, rate) calls."""
    calls = []

    def fake(renderer, ref_c, que, skip_idx, threshold, sample_rays=2048,
             seed=0, mesh=None):
        psn = renderer.cfg.probe_sample_num
        calls.append((psn, verdict(psn, calls)))
        return calls[-1][1]

    monkeypatch.setattr(R, "estimate_false_skip", fake)
    return calls


def test_auto_mode_reescalates_mid_trajectory(cli, monkeypatch):
    # the first psn-8 audit (frame 0) passes, every later psn-8 audit
    # fails ("new geometry appeared"), psn >= 16 always passes
    calls = script_audit(monkeypatch, lambda psn, calls: 0.5 if (
        psn == 8 and any(p == 8 for p, _ in calls)) else 0.0)
    by_frame = {e["frame"]: e for e in cli()}
    assert by_frame[0]["probe_sample_num"] == 8
    assert by_frame[0]["fallback"] is None
    assert by_frame[1]["probe_sample_num"] == 16     # re-escalated
    assert by_frame[1]["fallback"] is None
    assert by_frame[2]["probe_sample_num"] == 16     # started from 16
    assert sum(1 for p, _ in calls if p == 8) == 2   # no ladder re-climb
    assert [p for p, _ in calls] == [8, 8, 16, 16]
    assert sorted(by_frame) == [0, 1, 2]
    assert all(e["audit_trail"] for e in by_frame.values())


def test_auto_mode_fallback_is_sticky(cli, monkeypatch):
    """Every size fails on frame 0: 8, 16, 32, then the exact gate for
    frame 0 and, with no more audits, for frames 1 and 2."""
    calls = script_audit(monkeypatch, lambda psn, calls: 0.5)
    skip_empty, frames = R.render_frame_skip_empty, []

    def counted(*args, **kw):
        frames.append(1)
        return skip_empty(*args, **kw)

    monkeypatch.setattr(R, "render_frame_skip_empty", counted)
    log = cli()
    assert [p for p, _ in calls] == [8, 16, 32]
    assert [(e["frame"], e["fallback"]) for e in log] == [(0, "two_phase")]
    assert len(frames) == 3


def test_audit_log_starts_empty_on_every_run(cli, monkeypatch):
    script_audit(monkeypatch, lambda psn, calls: 0.0)
    assert [e["frame"] for e in cli(0, 2)] == [0, 1]
    # a rerun: frames 0 and 1 exist (resumed), frame 2 is new
    assert [e["frame"] for e in cli(0, 3)] == [2]
    assert cli(0, 3) == []
