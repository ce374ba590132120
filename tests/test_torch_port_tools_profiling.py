"""The port's stage clock and trace (``neuray_tpu_torch/utils/
profiling.py``) against the JAX package's (``neuray_tpu/utils/
profiling.py``) on the CPU: on one fake clock, the same stages give the
same totals, counts, ``summary()`` and ``report()`` lines, the port's
report closing with the line that says its stages had host time only;
a stage that raises is counted by both. ``device_trace`` writes a
Chrome trace into its directory, and with ``None`` writes nothing.
"""
import json
import os
import time

import pytest
import torch

from neuray_tpu.utils import profiling as jP

from neuray_tpu_torch.utils import profiling as P


def fake_clock(monkeypatch):
    """time.perf_counter stepping 0.25 s, then 0.5 s, ... a call."""
    state = {"t": 0.0, "step": 0.25}

    def tick():
        state["t"] += state["step"]
        state["step"] += 0.25
        return state["t"]

    monkeypatch.setattr(time, "perf_counter", tick)


def run_stages(timer, sync):
    for name in ("encode", "render", "encode", "merge"):
        with timer.stage(name, sync):
            pass
    with pytest.raises(ValueError):
        with timer.stage("render", sync):
            raise ValueError("a stage that fails")
    return timer


@pytest.mark.parametrize("sync", [None, "cpu tensor", "cpu device"])
def test_stage_timer_equals_jax(monkeypatch, sync):
    fake_clock(monkeypatch)
    theirs = run_stages(jP.StageTimer(), None)
    fake_clock(monkeypatch)
    arg = {None: None, "cpu tensor": torch.zeros(2),
           "cpu device": torch.device("cpu")}[sync]
    ours = run_stages(P.StageTimer(), arg)
    assert dict(ours.totals) == dict(theirs.totals)
    assert dict(ours.counts) == dict(theirs.counts) == {
        "encode": 2, "render": 2, "merge": 1}
    assert ours.summary() == theirs.summary()
    assert not ours.device_totals and not ours.busy_totals
    lines = ours.report().split("\n")
    assert lines[:-1] == theirs.report().split("\n")
    assert lines[-1] == ("host clock only (no device time): encode, merge, "
                         "render")


def test_busy_timer_on_the_cpu_records_host_time_only(monkeypatch):
    fake_clock(monkeypatch)
    theirs = run_stages(jP.StageTimer(), None)
    fake_clock(monkeypatch)
    ours = run_stages(P.StageTimer(busy=True), torch.zeros(1))
    assert ours.summary() == theirs.summary()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with P.device_trace(str(logdir)) as prof:
        assert prof is not None
        torch.ones(8).add_(1)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.loads((logdir / files[0]).read_text())
    assert trace["traceEvents"]


def test_device_trace_none_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with P.device_trace(None) as prof:
        assert prof is None
        torch.ones(8).add_(1)
    assert os.listdir(tmp_path) == []
