"""The port's stage clock (``neuray_tpu_torch/utils/
profiling.py``) against the JAX package's (``neuray_tpu/utils/
profiling.py``) on the CPU: on one fake clock, the same stages give the
same totals, counts, ``summary()`` and ``report()`` lines, the port's
report closing with the line that says its stages had host time only;
a stage that raises is counted by both. A busy stage whose profiler
session gave no device rows reads busy "not measured", never 0.
"""
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


@pytest.fixture
def fake_card(monkeypatch):
    """A stage that ends "on the card" without one: its stream and events
    stubbed (each event pair 2 ms apart), its busy session a CPU
    profile, which gives no device rows."""
    from torch import profiler

    class Stream:
        def synchronize(self):
            pass

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 2.0

    cpu_profile = profiler.profile
    monkeypatch.setattr(P, "_cuda", lambda sync: True)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(profiler, "profile", lambda activities: cpu_profile(
        activities=[profiler.ProfilerActivity.CPU]))


def test_busy_ms_of_a_session_without_device_rows_is_none():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).add_(1)
    assert P._busy_ms(prof) is None


def test_empty_session_reads_busy_not_measured(fake_card):
    timer = P.StageTimer(busy=True)
    for _ in range(2):
        with timer.stage("render", "cuda"):
            torch.ones(8).add_(1)
    s = timer.summary()
    assert s["render_device_ms"] == 2.0 and s["render_busy_ms"] is None
    assert timer.report().endswith(
        "device span 2.0 ms/call, kernels busy not measured")
