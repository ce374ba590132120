"""The exact render chunk replayed from CUDA graphs (``models/renderer.py:
render_rays``, ``_ExactStep``; ``utils/graphs.py: SegmentedGraph``).

On the CPU: which chunks may come from graphs (``_graphable``: CUDA,
inference mode, grad off, every value a tensor on the coords' device);
the training forward never records; what keys a recording
(``_graph_key``); a recording's tallies of counters and launches made at
each replay and none at the capture (``torch.cuda.CUDAGraph`` stubbed);
and the render loop's staging and recapture rehearsed with a stand-in
recording that reruns the eager chunk at each replay (``RerunGraph``).

On a card (``cuda``, run with ``python -m pytest --noconftest -p
no:cacheprovider -m cuda -s tests/test_torch_port_render_graphs.py``;
this file imports no JAX), at both benchmark configurations' chunks
(8,192 and 2,048 rays, the last chunk padded) and the depth one with the
direct rendering branch: one gather launch captured
and replayed; ``render_rays`` against a loop of eager ``render_chunk``
calls on two scenes in a row; a replaced weight recaptures; the gather's
launch and byte counts over a frame equal the eager loop's; the spans
``pass``, ``dist_decoder`` and ``agg_net`` once per segment replay, each
with a device interval.
"""
import copy
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile

from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.ops import gather as G
from neuray_tpu_torch.utils import graphs
from neuray_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
PASS = [("pass", None), ("dist_decoder", "pass"), ("agg_net", "pass")]


def tree(rec):
    return [(s.name, None if s.parent is None else rec.spans[s.parent].name)
            for s in rec.spans]


def eager_frame(r, ref_c, que, keep):
    """The chunk loop of ``render_rays`` made here: eager
    ``render_chunk`` on each padded chunk."""
    chunks, rn = R.chunk_coords(que["coords"], r.cfg.ray_batch_num)
    parts = [R._keep(r.render_chunk(ref_c, dict(que, coords=c)), keep)
             for c in chunks]
    return {k: torch.cat([p[k] for p in parts], 1)[:, :rn] for k in keep}


# ---------------- on the CPU ----------------

class OnCuda(torch.Tensor):
    """A CPU tensor that says it is on the card: ``_graphable`` reads
    devices only."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def on_cuda(t):
    return torch.Tensor._make_subclass(OnCuda, t)


def small_dicts(cuda=True):
    wrap = on_cuda if cuda else (lambda t: t)
    ref = {k: wrap(torch.zeros(2, 4, 4, 3)) for k in ("imgs", "feats")}
    que = {"coords": wrap(torch.zeros(1, 8, 2)), "imgs": None}
    return ref, que


@pytest.mark.parametrize("case,want", [
    ("cuda, inference mode", True), ("cpu", False),
    ("grad mode", False), ("grad enabled in inference mode", False),
    ("a scene tensor on the cpu", False), ("a value not a tensor", False)])
def test_which_chunks_may_come_from_graphs(case, want):
    ref, que = small_dicts(case != "cpu")
    if case == "a scene tensor on the cpu":
        ref["poses"] = torch.zeros(2, 3, 4)
    if case == "a value not a tensor":
        que["h"] = 4
    if case == "grad mode":
        assert R._graphable(ref, que) is want
        return
    with torch.inference_mode():
        if case == "grad enabled in inference mode":
            with torch.enable_grad():
                assert R._graphable(ref, que) is want
        else:
            assert R._graphable(ref, que) is want


class Refuse:
    def __init__(self, *a, **k):
        raise AssertionError("a chunk was recorded")


def tiny_scene(seed=7, views=3, hw=32, rays=12):
    from neuray_tpu_torch.data.synthetic import make_query, make_sphere_scene
    rng = np.random.RandomState(seed)
    ref = {k: torch.from_numpy(v)
           for k, v in make_sphere_scene(rng, views, hw, hw).items()}
    que = {k: torch.from_numpy(v)
           for k, v in make_query(rng, hw, hw, rays).items()}
    return ref, que


def tiny_renderer(**kw):
    from neuray_tpu_torch.utils.params import (load_flax_params,
                                               load_params_npz)
    r = R.NeurayRenderer(R.RenderConfig(
        use_hierarchical_sampling=True, depth_sample_num=4,
        fine_depth_sample_num=4, ray_batch_num=8, use_vis=False,
        fine_use_vis=False, **kw))
    load_flax_params(r, load_params_npz(str(ROOT / "tools"
                                            / "bench_weights.npz")))
    return r.eval()


def test_cpu_chunks_run_eagerly_and_count_their_passes(monkeypatch):
    monkeypatch.setattr(graphs, "SegmentedGraph", Refuse)
    r = tiny_renderer()
    ref, que = tiny_scene()
    que.pop("imgs")
    with torch.inference_mode():
        ec = R.encode_ref(r, ref)
        with profile(activities=[ProfilerActivity.CPU]):
            out = R.render_rays(r, ec, que, ("pixel_colors_nr_fine",))
        want = eager_frame(r, ec, que, ("pixel_colors_nr_fine",))
    assert torch.equal(out["pixel_colors_nr_fine"],
                       want["pixel_colors_nr_fine"])
    # two chunks (the last padded), a coarse and a fine pass each
    assert P.recorded().counters["render.eager_passes"] == 4
    assert "render.graph_passes" not in P.recorded().counters
    assert r not in R._GRAPHS


def test_the_training_forward_never_records(monkeypatch):
    monkeypatch.setattr(graphs, "SegmentedGraph", Refuse)
    monkeypatch.setattr(R, "_graphable", lambda *a: True)
    r = tiny_renderer()
    ref, que = tiny_scene()
    out = r.forward(ref, que, is_train=True,
                    generator=torch.Generator().manual_seed(0))
    assert out["pixel_colors_nr_fine"].requires_grad


def first_linear(r):
    return next(m for m in r.agg_net.modules() if isinstance(m, nn.Linear))


def key_inputs():
    r = tiny_renderer()
    ref = {"imgs": torch.zeros(3, 32, 32, 3), "feats": torch.zeros(3, 8, 8, 64),
           "poses": torch.zeros(3, 3, 4)}
    ref["rgb_map"] = ref["imgs"]
    que = {"coords": torch.zeros(1, 8, 2), "poses": torch.zeros(1, 3, 4)}
    return r, ref, que


@pytest.mark.parametrize("change", [
    "chunk shape", "scene shape", "scene dtype", "optional key",
    "optional key None", "aliasing", "replaced weight",
    "weight written in place"])
def test_each_part_of_the_key_gives_a_new_entry(change):
    r, ref, que = key_inputs()
    base = R._graph_key(r, ref, que)
    # the same signature in new tensors is the same key
    ref2 = {k: v.clone() for k, v in ref.items()}
    ref2["rgb_map"] = ref2["imgs"]
    assert R._graph_key(r, ref2, dict(que, coords=que["coords"] + 1)) == base
    if change == "chunk shape":
        que = dict(que, coords=torch.zeros(1, 16, 2))
    elif change == "scene shape":
        ref = dict(ref, feats=torch.zeros(3, 9, 8, 64))
    elif change == "scene dtype":
        ref = dict(ref, feats=torch.zeros(3, 8, 8, 64, dtype=torch.bfloat16))
    elif change == "optional key":
        ref = dict(ref, feats_scale=torch.ones(64))
    elif change == "optional key None":
        que = dict(que, imgs=None)
    elif change == "aliasing":
        ref = dict(ref, rgb_map=ref["imgs"].clone())
    elif change == "replaced weight":
        lin = first_linear(r)
        lin.weight = nn.Parameter(lin.weight.detach().clone())
    else:
        with torch.no_grad():
            next(r.parameters()).mul_(1.0)
    assert R._graph_key(r, ref, que) != base


class FakeGraph:
    """``torch.cuda.CUDAGraph`` without a card: each capture and replay
    is logged."""
    log = []

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.n = len(FakeGraph.log)
        FakeGraph.log.append(("begin", self.n))

    def capture_end(self):
        FakeGraph.log.append(("end", self.n))

    def replay(self):
        FakeGraph.log.append(("replay", self.n))


def test_tallies_are_made_at_each_replay_not_at_the_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(G, "_call", lambda name, index, args: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    FakeGraph.log = []
    v, p, fh, fw = 3, 50, 6, 7
    feats, coords = torch.zeros(v, fh, fw, 64), torch.zeros(v, p, 2)
    mask = torch.ones(v, p)

    def chunk():
        P.count("before", 1)
        with P.span("pass"):
            G._launch(feats, coords, mask, None, G._HALF_PIXEL, 24, 28)
            with P.span("agg_net"):
                P.count("inside", 2)
        return {}

    seg = graphs.SegmentedGraph()
    launches, by_dtype = G.LAUNCHES, G.LAUNCHES_BY_DTYPE["f32"]
    with profile(activities=[ProfilerActivity.CPU]):
        P.count("session", 1)           # begins the recorder's session
        seg.capture(chunk)
    assert P.recorded().spans == []
    assert P.recorded().counters == {"session": 1}
    assert G.LAUNCHES == launches
    # five stretches between the span's edges, each its own graph
    assert [s if not isinstance(s, tuple) else "graph"
            for s in seg.steps] == ["graph", "pass", "graph", "agg_net",
                                    "graph", None, "graph", None, "graph"]
    assert P._capture is None
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            seg.replay()
    rec = P.recorded()
    assert tree(rec) == [("pass", None), ("agg_net", "pass")] * 3
    assert rec.counters == {"before": 3, "inside": 6,
                            "gather.bytes": 3 * G.launch_bytes(v, p, 64, 4,
                                                               True)}
    assert G.LAUNCHES == launches + 3
    assert G.LAUNCHES_BY_DTYPE["f32"] == by_dtype + 3
    assert [e for e, _ in FakeGraph.log].count("replay") == 15


def test_a_capture_that_raises_leaves_no_capture_behind(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))

    def fails():
        with P.span("pass"):
            raise ValueError("inside")

    with pytest.raises(ValueError):
        graphs.SegmentedGraph().capture(fails)
    assert P._capture is None
    assert P.span("a") is P.span("b")


class RerunGraph:
    """A recording without a card: ``record`` runs the chunk twice (the
    eager run and the capture), ``replay`` reruns it from the static
    inputs into the captured outputs, as a graph's replay would."""
    made = 0

    def __init__(self):
        RerunGraph.made += 1

    def record(self, fn):
        self.fn = fn
        self.static = fn()
        return fn(), self.static

    def replay(self):
        for k, v in self.fn().items():
            self.static[k].copy_(v)


@pytest.fixture
def rerun(monkeypatch):
    monkeypatch.setattr(graphs, "SegmentedGraph", RerunGraph)
    monkeypatch.setattr(R, "_graphable", lambda *a: True)
    RerunGraph.made = 0


def test_frames_in_a_row_from_recordings_equal_the_eager_loop(rerun):
    keep = ("pixel_colors_nr", "pixel_colors_nr_fine")
    r = tiny_renderer()
    scenes = [tiny_scene(seed) for seed in (7, 8, 7)]
    with torch.inference_mode():
        for i, (ref, que) in enumerate(scenes):
            que.pop("imgs")
            ec = R.encode_ref(r, ref)
            with profile(activities=[ProfilerActivity.CPU]):
                got = R.render_rays(r, ec, que, keep)
            want = eager_frame(r, ec, que, keep)
            for k in keep:
                assert torch.equal(got[k], want[k]), (i, k)
            counters = P.recorded().counters
            # the first chunk of the first frame ran eagerly, then was
            # recorded; every other chunk is a replay
            assert counters.get("render.eager_passes", 0) == (2 if i == 0
                                                               else 0)
            assert counters["render.graph_passes"] == (2 if i == 0 else 4)
    assert RerunGraph.made == 1


def test_a_new_key_records_anew(rerun):
    keep = ("pixel_colors_nr_fine",)
    r = tiny_renderer()
    ref, que = tiny_scene()
    que.pop("imgs")
    with torch.inference_mode():
        ec = R.encode_ref(r, ref)
        R.render_rays(r, ec, que, keep)
        first = R._GRAPHS[r]
        # other kept keys replay the same recording
        other = ("pixel_colors_nr", "ray_mask")
        got = R.render_rays(r, ec, que, other)
        want = eager_frame(r, ec, que, other)
        assert all(torch.equal(got[k], want[k]) for k in other)
    assert R._GRAPHS[r] is first and RerunGraph.made == 1
    # a weight replaced, not written in place
    lin = first_linear(r)
    lin.weight = nn.Parameter(lin.weight.detach() * 1.5)
    with torch.inference_mode():
        got = R.render_rays(r, ec, que, keep)
        assert RerunGraph.made == 2 and R._GRAPHS[r] is not first
        assert torch.equal(got[keep[0]],
                           eager_frame(r, ec, que, keep)[keep[0]])
        # another number of views
        ref2, que2 = tiny_scene(9, views=4)
        que2.pop("imgs")
        R.render_rays(r, R.encode_ref(r, ref2), que2, keep)
    assert RerunGraph.made == 3
    # a copy of the renderer records its own
    held = R._GRAPHS[r]
    twin = copy.deepcopy(r)
    assert twin not in R._GRAPHS and R._GRAPHS[r] is held


# ---------------- on the card ----------------

# each benchmark configuration, and the depth one with the direct
# rendering branch (its SH fit inverts a batch of 16x16 matrices)
CELLS = {"neuray_gen_depth": {}, "neuray_gen_cost_volume": {},
         "neuray_gen_depth+dr": {"use_dr_prediction": True}}
KEEP = ("pixel_colors_nr", "pixel_colors_nr_fine")
DR_KEEP = ("pixel_colors_dr", "pixel_colors_dr_fine")


@pytest.fixture(scope="module", params=list(CELLS))
def cell(request):
    """The configuration's renderer on the card, and two frames of a
    16-view scene, each 96x96 rays (the depth chunks: 2, the cost-volume
    chunks: 5; the last padded)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from pb import core, program, scene
    route = CELLS[request.param]
    config = core.load_json(BENCH / "configs"
                            / f"{request.param.split('+')[0]}.json")
    dev = torch.device("cuda")
    program.set_precision()
    r = program.renderer(config, route, ROOT / config["weights"], dev,
                         config.get("weights_scale", {}))
    rng = np.random.default_rng(2 ** 33 + 17)
    hw = [96, 128] if config["render"]["init_net_type"] == "cost_volume" \
        else [96, 96]
    views = scene.make_views(rng, 16, *hw, dev)
    poses, Ks, coords = scene.make_queries(rng, 2, 96, 96, dev)
    nn_ = 3 if config["render"]["init_net_type"] == "cost_volume" else 0
    frames = []
    with torch.inference_mode():
        for i in range(2):
            ref, src, que = scene.frame_inputs(views, poses[i], Ks[i],
                                               coords, 8, nn_)
            frames.append((R.encode_ref(r, ref, src), que))
    R._GRAPHS.pop(r, None)
    return types.SimpleNamespace(r=r, frames=frames, name=request.param,
                                 keep=KEEP + (DR_KEEP if route else ()))


def max_gap(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


@pytest.mark.cuda
def test_one_gather_launch_replays_equal_to_eager():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    gen = torch.Generator(device="cuda").manual_seed(0)
    feats = torch.rand(8, 200, 200, 64, device="cuda", generator=gen)
    pts = torch.rand(8, 4096, 2, device="cuda", generator=gen) * 800
    mask = (torch.rand(8, 4096, device="cuda", generator=gen) > 0.2).float()
    static = pts.clone()
    seg = graphs.SegmentedGraph()
    with torch.inference_mode():
        first, out = seg.record(lambda: {"g": G.gather_feature_map(
            feats, static, mask, 800, 800)})
        seg.replay()
        assert torch.equal(first["g"], out["g"])
        for _ in range(2):
            pts = torch.rand(8, 4096, 2, device="cuda", generator=gen) * 800
            static.copy_(pts)
            seg.replay()
            assert torch.equal(out["g"],
                               G.gather_feature_map(feats, pts, mask, 800,
                                                    800))
    assert sum(isinstance(s, tuple) for s in seg.steps) == 1


@pytest.mark.cuda
def test_frames_equal_the_eager_chunk_loop(cell):
    r = cell.r
    with torch.inference_mode():
        for i in (0, 0, 1, 0):
            ec, que = cell.frames[i]
            got = R.render_rays(r, ec, que, cell.keep)
            want = eager_frame(r, ec, que, cell.keep)
            gap = max_gap(got, want)
            print(f"{cell.name} frame {i}: largest gap to eager {gap:.3g}"
                  f" (bit-equal: {gap == 0})")
            assert gap <= 1e-6
    assert copy.deepcopy(r) not in R._GRAPHS
    entry = R._GRAPHS[r]
    # the coarse depths, five stretches a pass, the fine depths
    assert sum(isinstance(s, tuple) for s in entry.graph.steps) == 12


@pytest.mark.cuda
def test_a_replaced_weight_records_anew(cell):
    r = cell.r
    ec, que = cell.frames[0]
    with torch.inference_mode():
        R.render_rays(r, ec, que, cell.keep)
        before = eager_frame(r, ec, que, cell.keep)
    first = R._GRAPHS[r]
    lin = first_linear(r)
    old = lin.weight
    lin.weight = nn.Parameter(old.detach() * 1.01)
    try:
        with torch.inference_mode():
            got = R.render_rays(r, ec, que, cell.keep)
            assert R._GRAPHS[r] is not first
            assert max_gap(got, eager_frame(r, ec, que, cell.keep)) <= 1e-6
            assert max_gap(got, before) > 1e-4
    finally:
        lin.weight = old


@pytest.mark.cuda
def test_launches_and_bytes_over_a_frame_equal_eager(cell):
    r = cell.r
    ec, que = cell.frames[1]

    def counted(fn):
        G.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]):
            fn()
            torch.cuda.synchronize()
        return (G.LAUNCHES, dict(G.LAUNCHES_BY_DTYPE),
                P.recorded().counters.get("gather.bytes"))

    with torch.inference_mode():
        R.render_rays(r, ec, que, cell.keep)          # recorded already
        graphed = counted(lambda: R.render_rays(r, ec, que, cell.keep))
        eager = counted(lambda: eager_frame(r, ec, que, cell.keep))
    assert graphed == eager and graphed[0] > 0


@pytest.mark.cuda
def test_spans_of_each_segment_replay(cell):
    r = cell.r
    ec, que = cell.frames[0]
    chunks = -(-que["coords"].shape[1] // r.cfg.ray_batch_num)
    with torch.inference_mode():
        R.render_rays(r, ec, que, cell.keep)
        with profile(activities=[ProfilerActivity.CUDA]):
            R.render_rays(r, ec, que, cell.keep)
            torch.cuda.synchronize()
    rec = P.recorded()
    assert tree(rec) == PASS * 2 * chunks
    assert rec.counters["render.graph_passes"] == 2 * chunks
    assert "render.eager_passes" not in rec.counters
    for s in rec.spans:
        assert s.device is not None and s.device[1] > s.device[0]
