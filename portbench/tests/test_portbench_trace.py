"""The trace reader: it refuses a profile without device rows, and
reads the busy time, the idle share, kernel sums and idle gaps of a
made-up event list."""
import pytest
import torch

from pb import trace
from pb.readers import idle_pct, roofline_pct


def made_up():
    ms = 1_000_000
    kernels = [("gather_lanes<float>", 1 * ms, 3 * ms),
               ("addmm", 2 * ms, 4 * ms),          # overlaps the first
               ("bin_points", 6 * ms, 7 * ms),
               ("Memset (Device)", 9 * ms, 12 * ms)]  # runs past the end
    spans = [("encode", 0, 5 * ms), ("render", 5 * ms, 8 * ms)]
    return trace.Trace(kernels, spans, (0, 10 * ms))


def test_busy_idle_and_sums():
    tr = made_up()
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_intervals() == [(1_000_000, 4_000_000),
                                   (6_000_000, 7_000_000),
                                   (9_000_000, 10_000_000)]
    assert tr.busy_s() == pytest.approx(0.005)
    assert tr.kernel_s("gather_lanes") == pytest.approx(0.002)
    assert tr.kernel_s("bin_points", "Memset") == pytest.approx(0.002)

    class Readout:
        trace = tr
        counters = {"gather_bytes": 3.35e12 * 0.001}
    assert idle_pct(Readout) == pytest.approx(50.0)
    assert roofline_pct(Readout, "gather_bytes",
                        ("gather_lanes",)) == pytest.approx(50.0)
    assert roofline_pct(Readout, "other", ("x",)) is None


def test_idle_gaps_by_host_span_and_top_ops():
    tr = made_up()
    gaps = dict(tr.idle_gaps())
    # a gap goes to the span open where it begins: 0-1 and 4-6 ms begin
    # in encode, 7-9 in render
    assert gaps == pytest.approx({"encode": 0.003, "render": 0.002})
    late = trace.Trace(tr.kernels, tr.spans[:1], (0, 10_000_000))
    assert dict(late.idle_gaps())["host"] == pytest.approx(0.002)
    ops = tr.device_ops()
    assert ops[0][0] == "gather_lanes<float>" and len(ops) == 4


def test_no_device_rows_is_refused():
    with pytest.raises(trace.NoDeviceRows):
        trace.Trace([], [], (0, 1))


def test_empty_profile_is_refused():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    with pytest.raises(trace.NoDeviceRows):
        trace.read_trace(prof, (0, 1), [])


def test_rows_off_the_window_clock_are_refused():
    ms = 1_000_000
    with pytest.raises(trace.NoDeviceRows):
        trace.Trace([("k", 5000 * ms, 5001 * ms)], [], (0, 10 * ms))
