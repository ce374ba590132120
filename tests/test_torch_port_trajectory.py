"""The port's pan-trajectory tool (``python -m neuray_tpu_torch.
check_trajectory_escalation --device cpu``) against the JAX package's
(``tools/check_trajectory_escalation.py --cpu``), and its sticky policy.

The JAX tool runs in a subprocess (it compiles next to torch otherwise;
ROADMAP hazard f) at its CPU shapes (64 px, 16 + 16 samples, 64-ray
chunks, f32), and its first 3 frames' rows are read as it prints them;
the port's tool runs the same 7-frame trajectory's first 3 frames at the
same shapes. Row for row: whether a rod is in the frustum, the starting
and accepted probe size, the fallback, the kept fraction, the false-skip
rate and each audit rung's probe size equal; the windows' predicted cost
within 1e-3 dB and the GT-PSNR within 0.01 dB (each package encodes the
scene itself: its f32 colours differ by ~1e-5).

The policy check scripts the audit's outcomes: the tool's frames go
through ``render.py: SkipRenderer`` (the render CLI's own object), so a
size the audit accepts is where the next frame starts, and after a
fallback every frame is the exact two-phase render.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neuray_tpu_torch import check_trajectory_escalation as TE
from neuray_tpu_torch import render as RC

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
FRAMES = 3


def jax_rows(n):
    """The JAX tool's first n frame rows, read as it prints them; the
    process is stopped after the n-th."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tools" /
                             "check_trajectory_escalation.py"), "--cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    rows = []
    try:
        for line in proc.stdout:
            if line.startswith("{") and '"frame"' in line:
                rows.append(json.loads(line))
                if len(rows) == n:
                    break
    finally:
        proc.kill()
        proc.wait()
    assert len(rows) == n, rows
    return rows


@pytest.fixture(scope="module")
def rows():
    ours, _ = TE.run(TE.parse_args(["--device", "cpu"]), CPU,
                     log=lambda *a, **k: None, max_frames=FRAMES)
    return ours, jax_rows(FRAMES)


def test_rows_match_jax(rows):
    ours, theirs = rows
    assert len(ours) == len(theirs) == FRAMES
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in ("frame", "thin_in_frustum", "start_psn", "accepted_psn",
                  "fallback", "kept_fraction", "false_skip_rate"):
            assert a[k] == b[k], (a["frame"], k, a[k], b[k])
        assert [r["probe_sample_num"] for r in a["audit_trail"]] == [
            r["probe_sample_num"] for r in b["audit_trail"]]
        for x, y in zip(a["audit_trail"], b["audit_trail"]):
            assert x["false_skip_rate"] == y["false_skip_rate"]
            assert x["kept_fraction"] == y["kept_fraction"]
        if b["window_clip_db"] is not None:
            assert abs(a["window_clip_db"] - b["window_clip_db"]) <= 1e-3
        assert abs(a["psnr_vs_gt"] - b["psnr_vs_gt"]) <= 0.01
        print(f"frame {a['frame']}: accepted {a['accepted_psn']}, kept "
              f"{a['kept_fraction']}, GT-PSNR {a['psnr_vs_gt']} (JAX "
              f"{b['psnr_vs_gt']})")


def test_the_policy_is_the_render_clis(monkeypatch):
    """Scripted audits (accept 8, escalate to 16, reject every size):
    each frame starts from the size accepted last, through the render
    CLI's ``SkipRenderer``; after the fallback the rest are two-phase."""
    outcomes = iter([(8, None), (16, None), (32, "two_phase")])
    seen = {"auto": [], "two_phase": 0, "skip": []}
    own = RC.SkipRenderer.__call__

    def spy(self, *args, **kw):
        seen["skip"].append(self)
        return own(self, *args, **kw)

    def frame(n, **extra):
        return {"pixel_colors_nr": np.zeros((1, n, 3), np.float32),
                "pixel_colors_nr_fine": np.zeros((1, n, 3), np.float32),
                "keep_mask": np.zeros(n, bool), "kept_rays": 0, **extra}

    def auto(renderer, ref_c, que, **kw):
        seen["auto"].append(renderer.cfg.probe_sample_num)
        psn, fallback = next(outcomes)
        return frame(que["coords"].shape[1], probe_sample_num=psn,
                     false_skip_rate=0.0, fallback=fallback,
                     audit_trail=[{"probe_sample_num": psn}])

    def two_phase(renderer, ref_c, que, **kw):
        seen["two_phase"] += 1
        assert kw["threshold"] == 0.01
        return frame(que["coords"].shape[1])

    monkeypatch.setattr(RC.SkipRenderer, "__call__", spy)
    monkeypatch.setattr(RC.R, "render_frame_probe_auto", auto)
    monkeypatch.setattr(RC.R, "render_frame_skip_empty", two_phase)
    rows, verdict = TE.run(TE.parse_args(["--device", "cpu", "--frames",
                                          "5"]), CPU,
                           log=lambda *a, **k: None)
    assert len({id(s) for s in seen["skip"]}) == 1      # one policy object
    assert seen["auto"] == [8, 8, 16]
    assert seen["two_phase"] == 2
    assert [r["start_psn"] for r in rows] == [8, 8, 16, None, None]
    assert [r["fallback"] for r in rows] == [
        None, None, "two_phase", "two_phase(sticky)", "two_phase(sticky)"]
    assert verdict["escalated"] and verdict["accepted_sequence"] == [
        8, 16, 32, None, None]
