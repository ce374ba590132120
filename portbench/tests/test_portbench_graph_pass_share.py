"""``metrics/graph_pass_share.render.py``: the share of render passes the
program replayed from CUDA graphs, from its counters
``render.graph_passes`` and ``render.eager_passes``."""
import types

import pytest

from pb import core, program_spans as PS, trace

MS = 1_000_000


def read_with(monkeypatch, rec):
    monkeypatch.setattr(PS, "recorded", lambda: rec)
    tr = trace.Trace([("k", 1 * MS, 2 * MS)], [], (0, 3 * MS))
    readout = types.SimpleNamespace(trace=tr, counters={"frames": 1})
    reader = core.load_module(core.HERE / "metrics"
                              / "graph_pass_share.render.py", "m")
    return reader.read(readout)


def recorded(counters):
    from neuray_tpu_torch.utils.profiling import Recorded
    return Recorded([], counters)


@pytest.mark.parametrize("counters", [None, {}, {"gather.bytes": 10}])
def test_none_without_its_counters(monkeypatch, counters):
    rec = None if counters is None else recorded(counters)
    assert read_with(monkeypatch, rec) is None


@pytest.mark.parametrize("counters,share", [
    ({"render.graph_passes": 746}, 100.0),
    ({"render.graph_passes": 6, "render.eager_passes": 2}, 75.0),
    ({"render.eager_passes": 4}, 0.0)])
def test_share_of_replayed_passes(monkeypatch, counters, share):
    assert read_with(monkeypatch, recorded(counters)) == pytest.approx(share)
