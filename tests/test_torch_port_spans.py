"""The port's recorder of spans and counters (``neuray_tpu_torch/utils/
profiling.py: span, count, recorded``), the spans and counters on its
main path, and the benchmark's reading of them
(``portbench/pb/program_spans.py`` and its metric files).

On the CPU: with no profiler session the recorder keeps nothing; under
one, spans nest by their thread's open stack, counters add up and a new
session drops the last one's; the renderer's passes, the trainer's step
and the gather's launches record what the benchmark reads; the busy and
idle arithmetic on a hand-built trace; every new reader gives None where
the window recorded nothing of its name; the gather's byte rule is the
benchmark's. On a card (``cuda``, run with ``python -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_port_spans.py``;
this file imports no JAX): the anchored device clock puts each of two
long matmuls' time inside its own span.
"""
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neuray_tpu_torch.ops import gather as G
from neuray_tpu_torch.utils import profiling as P

BENCH = Path(__file__).resolve().parents[1] / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from pb import core, counts, program_spans as PS, trace  # noqa: E402

MS = 1_000_000
NEW_METRICS = ("agg_net_busy_ms", "dist_decoder_busy_ms",
               "pass_idle_ms.render", "gather_counted_roofline.render",
               "forward_idle_ms.train", "backward_idle_ms.train",
               "update_idle_ms.train", "gather_bwd_counted_roofline.train")


def cpu_session():
    return profile(activities=[ProfilerActivity.CPU])


def tree(rec):
    """[(name, parent's name)] of the recorded spans, in order."""
    return [(s.name, None if s.parent is None else rec.spans[s.parent].name)
            for s in rec.spans]


# ---------------- the recorder ----------------

def test_off_records_nothing():
    with cpu_session():
        with P.span("kept"):
            P.count("n", 1)
    before = P.recorded()
    assert P.span("a") is P.span("b")
    with P.span("a"):
        P.count("n", 5)
    assert P.recorded() == before
    assert tree(before) == [("kept", None)] and before.counters == {"n": 1}


def test_spans_nest_and_counters_add():
    with cpu_session():
        with P.span("a"):
            with P.span("b"):
                P.count("bytes", 3)
            with P.span("c"):
                with P.span("d"):
                    P.count("bytes", 4.5)
        with P.span("e"):
            P.count("launches", 1)
    rec = P.recorded()
    assert tree(rec) == [("a", None), ("b", "a"), ("c", "a"), ("d", "c"),
                         ("e", None)]
    assert rec.counters == {"bytes": 7.5, "launches": 1}
    a, b, c, d, e = rec.spans
    assert a.host[0] <= b.host[0] <= b.host[1] <= c.host[0] <= d.host[0]
    assert d.host[1] <= c.host[1] <= a.host[1] <= e.host[0] <= e.host[1]
    assert all(s.device is None for s in rec.spans)   # no CUDA here


def test_a_new_session_drops_the_last():
    with cpu_session():
        with P.span("first"):
            P.count("n", 1)
    assert tree(P.recorded()) == [("first", None)]
    with cpu_session():
        P.count("m", 2)
        with P.span("second"):
            pass
    rec = P.recorded()
    assert tree(rec) == [("second", None)] and rec.counters == {"m": 2}


def test_a_thread_outside_the_session_neither_records_nor_ends_it():
    """The profiler's state is the entering thread's: a plain thread's
    span finds no session, and leaves the session running."""
    done = threading.Event()

    def other():
        with P.span("worker"):
            P.count("n", 1)
        done.set()

    with cpu_session():
        with P.span("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
        with P.span("after"):
            P.count("m", 1)
    assert done.is_set() and not t.is_alive()
    rec = P.recorded()
    assert tree(rec) == [("main", None), ("after", None)]
    assert rec.counters == {"m": 1}


# ---------------- the spans and counters of the main path ----------------

def test_render_passes_record_their_spans():
    from neuray_tpu_torch.data.synthetic import make_query, make_sphere_scene
    from neuray_tpu_torch.models import renderer as R
    from neuray_tpu_torch.utils.params import (load_flax_params,
                                               load_params_npz)
    rng = np.random.RandomState(7)
    ref = {k: torch.from_numpy(v)
           for k, v in make_sphere_scene(rng, 3, 32, 32).items()}
    que = {k: torch.from_numpy(v)
           for k, v in make_query(rng, 32, 32, 12).items() if k != "imgs"}
    r = R.NeurayRenderer(R.RenderConfig(
        use_hierarchical_sampling=True, depth_sample_num=4,
        fine_depth_sample_num=4, ray_batch_num=8, use_vis=False,
        fine_use_vis=False))
    load_flax_params(r, load_params_npz(str(core.ROOT / "tools"
                                            / "bench_weights.npz")))
    with torch.inference_mode():
        ec = R.encode_ref(r.eval(), ref)
        with cpu_session():
            R.render_rays(r, ec, que, ("pixel_colors_nr_fine",))
    # two chunks (the last padded), a coarse and a fine pass each
    assert tree(P.recorded()) == [("pass", None), ("dist_decoder", "pass"),
                                  ("agg_net", "pass")] * 4


def test_train_step_records_its_spans(tmp_path):
    from neuray_tpu_torch.train import trainer as T
    cfg = {
        "name": "spans", "total_step": 1, "train_log_step": 1,
        "val_interval": 10 ** 6, "save_interval": 10 ** 6,
        "lr_type": "exp_decay",
        "lr_cfg": {"lr_init": 1e-3, "decay_step": 1000, "decay_rate": 0.5},
        "loss": ["render", "depth"], "use_nr_fine_loss": True,
        "val_metric": ["psnr_ssim"], "key_metric_name": "psnr_nr_fine",
        "train_dataset_type": "synthetic",
        "train_dataset_cfg": {"rfn": 3, "h": 32, "w": 32,
                              "train_ray_num": 16,
                              "depth_loss_coords_num": 8},
        "val_set_list": [], "output_root": str(tmp_path), "worker_num": 0,
        "use_hierarchical_sampling": True, "depth_sample_num": 4,
        "fine_depth_sample_num": 4, "ray_batch_num": 16,
        "use_depth_loss": True,
        "dist_decoder_cfg": {"use_vis": False},
        "fine_dist_decoder_cfg": {"use_vis": False}}
    trainer = T.Trainer(cfg, device="cpu")
    batch = next(iter(trainer._batches(0)))
    with cpu_session():
        trainer.train_step(batch)
    rec = P.recorded()
    passes = [("pass", "step.forward"), ("dist_decoder", "pass"),
              ("agg_net", "pass")] * 2
    assert tree(rec) == ([("step.forward", None)] + passes
                         + [("step.backward", None), ("step.update", None)])


@pytest.fixture
def launch_on_cpu(monkeypatch):
    """The gather's launch sites on CPU tensors, the library call and the
    stream stubbed: what they count, not what they compute."""
    monkeypatch.setattr(G, "_call", lambda name, index, args: None)
    monkeypatch.setattr(G, "_backward_scratch", lambda *shape: 1)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)


def test_launches_count_their_bytes(launch_on_cpu):
    v, p, fh, fw = 3, 50, 6, 7
    coords = torch.zeros(v, p, 2)
    mask = torch.ones(v, p)
    launches, backward = G.LAUNCHES, G.BACKWARD_LAUNCHES
    with cpu_session():
        G._launch(torch.zeros(v, fh, fw, 64), coords, mask, None,
                  G._HALF_PIXEL, 24, 28)
        G._launch(torch.zeros(v, fh, fw, 3), coords, None, None,
                  G._MAP_PIXELS, 0, 0)
        G._launch(torch.zeros(v, fh, fw, 64, dtype=torch.uint8), coords,
                  mask, (torch.ones(64), torch.zeros(64)), G._HALF_PIXEL,
                  24, 28)
        G._launch_backward(torch.zeros(v, p, 32), coords, mask, fh, fw,
                           G._HALF_PIXEL, 24, 28)
    assert G.LAUNCHES == launches + 3
    assert G.BACKWARD_LAUNCHES == backward + 1
    assert P.recorded().counters == {
        "gather.bytes": (counts.gather_bytes(v * p, 64, 4)
                         + counts.gather_bytes(v * p, 3, 4, masked=False)
                         + counts.gather_bytes(v * p, 64, 2)),
        "gather.bwd_bytes": counts.gather_backward_bytes(v, p, 32, fh, fw)}


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("v,p,c,fh,fw,elem", [
    (8, 8192 * 64, 64, 200, 200, 4), (8, 32768, 3, 800, 800, 4),
    (8, 8192 * 64, 64, 100, 100, 2), (1, 512, 32, 200, 200, 4)])
def test_gather_byte_rule_is_the_benchmarks(v, p, c, fh, fw, elem, masked):
    assert (G.launch_bytes(v, p, c, elem, masked)
            == counts.gather_bytes(v * p, c, elem, masked))
    assert (G.backward_launch_bytes(v, p, c, fh, fw, masked)
            == counts.gather_backward_bytes(v, p, c, fh, fw, masked))


# ---------------- the benchmark's reading ----------------

def hand_built():
    """A 20 ms window: device rows at 1-4, 6-7 and 9-12 (overlapping) and
    15-19 ms; a frame of two passes, the first holding a dist decoder and
    an agg net, and a step span outside them."""
    kernels = [("gather_lanes<float>", 1 * MS, 3 * MS),
               ("addmm", 2 * MS, 4 * MS), ("elu", 6 * MS, 7 * MS),
               ("addmm", 9 * MS, 11 * MS), ("cat", 10 * MS, 12 * MS),
               ("bin_points", 15 * MS, 19 * MS)]
    tr = trace.Trace(kernels, [], (0, 20 * MS))

    def s(name, parent, host, device):
        return P.Span(name, parent, host, device)

    spans = [s("pass", None, (0, 8 * MS), (1 * MS, 8 * MS)),
             s("dist_decoder", 0, (0, 3 * MS), (1 * MS, 3 * MS)),
             s("agg_net", 0, (3 * MS, 5 * MS), (3 * MS, 7 * MS)),
             s("pass", None, (8 * MS, 11.5 * MS), (8 * MS, 13 * MS)),
             s("step.update", None, (14 * MS, 16 * MS), (14 * MS, 19 * MS)),
             s("pass", None, (30 * MS, 31 * MS), (30 * MS, 31 * MS))]
    rec = P.Recorded(spans, {"gather.bytes": 3.35e12 * 0.002,
                             "gather.bwd_bytes": 3.35e12 * 0.001})
    return rec, tr


def readout_of(monkeypatch, rec, tr, counters=None):
    monkeypatch.setattr(PS, "recorded", lambda: rec)
    return types.SimpleNamespace(
        trace=tr, counters=counters or {"frames": 2, "steps": 4})


def test_busy_and_idle_arithmetic(monkeypatch):
    rec, tr = hand_built()
    ps = PS.read(readout_of(monkeypatch, rec, tr))
    assert ps.busy == [(1 * MS, 4 * MS), (6 * MS, 7 * MS),
                       (9 * MS, 12 * MS), (15 * MS, 19 * MS)]
    assert ps.busy_ns("dist_decoder") == 2 * MS
    assert ps.busy_ns("agg_net") == 2 * MS           # 3-4 and 6-7
    assert ps.busy_ns("pass") == 7 * MS     # the third is off the window
    assert ps.busy_ns("step.update") == 4 * MS
    assert ps.busy_ns("none") is None
    # gaps 0-1 (dist_decoder), 4-6 (agg_net), 7-9 (the first pass),
    # 12-15 (outside: the host left the second pass at 11.5, the step
    # began at 14), 19-20 (outside)
    assert ps.innermost == {"dist_decoder": 1 * MS, "agg_net": 2 * MS,
                            "pass": 2 * MS}
    assert ps.within == {"dist_decoder": 1 * MS, "agg_net": 2 * MS,
                         "pass": 5 * MS}
    assert ps.outside == 4 * MS
    assert (sum(ps.innermost.values()) + ps.outside
            == pytest.approx((1 - tr.busy_s() / tr.window_s) * 20 * MS))
    assert ps.idle_ns("step.update") == 0 and ps.idle_ns("none") is None


def test_idle_goes_to_the_innermost_span():
    tr = trace.Trace([("k", 10 * MS, 11 * MS)], [], (0, 12 * MS))
    spans = [P.Span("outer", None, (0, 12 * MS), None),
             P.Span("inner", 0, (0, 5 * MS), None),
             P.Span("inner", 0, (11.5 * MS, 12 * MS), None)]
    ps = PS.ProgramSpans(P.Recorded(spans, {}), tr)
    # the gap at 0-10 ms begins in an inner span, the one at 11-12 between
    # two: in the outer alone
    assert ps.innermost == {"inner": 10 * MS, "outer": 1 * MS}
    assert ps.within == {"inner": 10 * MS, "outer": 11 * MS}
    assert ps.outside == 0
    assert ps.busy_ns("outer") is None      # no device interval


@pytest.mark.parametrize("name,value", [
    ("agg_net_busy_ms", 1.0), ("dist_decoder_busy_ms", 1.0),
    ("pass_idle_ms.render", 2.5),
    ("gather_counted_roofline.render", 100.0),
    ("backward_idle_ms.train", None), ("update_idle_ms.train", 0.0),
    ("gather_bwd_counted_roofline.train", 25.0)])
def test_readers_read_the_hand_built_window(monkeypatch, name, value):
    rec, tr = hand_built()
    reader = core.load_module(BENCH / "metrics" / f"{name}.py", "m")
    got = reader.read(readout_of(monkeypatch, rec, tr))
    assert got == (None if value is None else pytest.approx(value))


@pytest.mark.parametrize("name", NEW_METRICS)
@pytest.mark.parametrize("what", ["no recorder", "other names",
                                  "nothing kept"])
def test_readers_give_none_where_nothing_was_recorded(monkeypatch, name,
                                                      what):
    rec, tr = hand_built()
    rec = {"no recorder": None,
           "other names": P.Recorded([P.Span("x", None, (0, MS),
                                             (0, MS))], {"y": 1}),
           "nothing kept": P.Recorded([], {})}[what]
    reader = core.load_module(BENCH / "metrics" / f"{name}.py", "m")
    assert reader.read(readout_of(monkeypatch, rec, tr)) is None


def test_every_new_metric_is_declared():
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW_METRICS:
        m = entries[name]
        assert m["source"] in ("program_span", "program_counter")
        cells = (["gen_depth.train"] if name.endswith(".train")
                 else ["gen_depth.exact", "gen_cv.exact"])
        assert m["workloads"] == cells
        assert (BENCH / "metrics" / f"{name}.py").exists()


# ---------------- on the card ----------------

@pytest.mark.cuda
def test_two_matmuls_land_in_their_own_spans():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.randn(4096, 4096, device="cuda")
    (a @ a).sum().item()                      # cuBLAS's set-up
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with P.span("A"):
            x = a @ a
        with P.span("B"):
            y = x @ a
        torch.cuda.synchronize()
        t1 = __import__("time").time_ns()
    rec = P.recorded()
    assert [s.name for s in rec.spans] == ["A", "B"]
    t0 = rec.spans[0].host[0] - MS
    tr = trace.read_trace(prof, (t0, t1), [])
    gemms = [k for k in tr.kernels if k[2] - k[1] > 1e5]   # > 0.1 ms
    assert len(gemms) == 2, tr.kernels
    edges = []
    for (name, ks, ke), sp, other in zip(gemms, rec.spans, rec.spans[::-1]):
        (a0, a1), (b0, b1) = sp.device, other.device
        mine = max(0, min(ke, a1) - max(ks, a0))
        theirs = max(0, min(ke, b1) - max(ks, b0))
        assert mine >= 0.99 * (ke - ks) and theirs <= 0.01 * (ke - ks)
        edges.append((ks - a0, a1 - ke))
    print("clock check: kernel start - span start, span end - kernel end "
          "(us):", [(s / 1e3, e / 1e3) for s, e in edges])
    del y
