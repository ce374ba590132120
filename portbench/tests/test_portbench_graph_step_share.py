"""``metrics/graph_step_share.train.py``: the share of training steps the
program replayed from CUDA graphs, from its counters
``train.graph_steps`` and ``train.eager_steps``."""
import types

import pytest

from pb import core, program_spans as PS, trace

MS = 1_000_000


def read_with(monkeypatch, rec):
    monkeypatch.setattr(PS, "recorded", lambda: rec)
    tr = trace.Trace([("k", 1 * MS, 2 * MS)], [], (0, 3 * MS))
    readout = types.SimpleNamespace(trace=tr, counters={"steps": 1})
    reader = core.load_module(core.HERE / "metrics"
                              / "graph_step_share.train.py", "m")
    return reader.read(readout)


def recorded(counters):
    from neuray_tpu_torch.utils.profiling import Recorded
    return Recorded([], counters)


@pytest.mark.parametrize("counters", [None, {}, {"gather.bwd_bytes": 10}])
def test_none_without_its_counters(monkeypatch, counters):
    rec = None if counters is None else recorded(counters)
    assert read_with(monkeypatch, rec) is None


@pytest.mark.parametrize("counters,share", [
    ({"train.graph_steps": 280}, 100.0),
    ({"train.graph_steps": 3, "train.eager_steps": 1}, 75.0),
    ({"train.eager_steps": 150}, 0.0)])
def test_share_of_replayed_steps(monkeypatch, counters, share):
    assert read_with(monkeypatch, recorded(counters)) == pytest.approx(share)
