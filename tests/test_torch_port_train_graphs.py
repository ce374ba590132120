"""The generalization training step replayed from CUDA graphs
(``train/trainer.py: BaseTrainer.train_step``, ``_StepGraphs``,
``_StepGraph``; ``utils/graphs.py: SegmentedGraph``).

On the CPU: which steps may come from graphs (``_graphable``: CUDA, one
rank, autograd, every leaf of a dict batch a tensor on the device); what
keys a recording (``_batch_key``, the optimizer and the parameter
list); a key recorded at its second step, a bound on the recordings
made, none dropped, and the card's room; the Adam made capturable at the
first recording; a capture that makes no count while each replay makes
its tallies (``torch.cuda.CUDAGraph`` stubbed); the staged fine draws
against the generator's own sequence;
the trainer's flow through a stand-in recording that reruns the step at
each replay (``RerunStep``); the eager step against the update as it was
written before the step was split (``old_adam_update``); and the
compositing's cumprod, whose backward may not read the device back.

On a card (``cuda``; run with ``python -m pytest --noconftest -p
no:cacheprovider -m cuda -s tests/test_torch_port_train_graphs.py``; this
file imports no JAX), at gen_depth.train's shapes (8 views at 400x608,
512 rays, 8,192 depth pixels a view): 5 steps replayed against the same
5 steps eager, whose Adam is never made capturable; the gather's launches
and backward bytes a step; the spans of a replay; an eager trainer's
checkpoint resumed into a graphed one; and the default training
mixture's three keys (8 views at 400x608, at 512x512 with the depth
loss, at 1200x1600), each recorded, with their pools.
"""
import contextlib
import gc
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile

from neuray_tpu_torch.ops import gather as G
from neuray_tpu_torch.train import trainer as T
from neuray_tpu_torch.utils import graphs
from neuray_tpu_torch.utils import profiling as P
from test_torch_port_trainer import make_cfg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"


# ---------------- on the CPU ----------------

class OnCuda(torch.Tensor):
    """A CPU tensor that says it is on the card: ``_graphable`` reads
    devices only."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def on_cuda(t):
    return torch.Tensor._make_subclass(OnCuda, t)


def gen_batch(wrap=on_cuda):
    ref = {"imgs": wrap(torch.zeros(3, 8, 8, 3)),
           "depth": wrap(torch.zeros(3, 8, 8, 1))}
    ref["true_depth"] = ref["depth"]
    return {"ref": ref, "que": {"coords": wrap(torch.zeros(1, 16, 2))},
            "is_gso": wrap(torch.zeros(()))}


def fake_trainer(device="cuda:0", ranks=1):
    model = nn.Linear(4, 4)
    t = types.SimpleNamespace(
        device=torch.device(device), mesh=types.SimpleNamespace(size=ranks),
        model=model, params=list(model.parameters()),
        generator=torch.Generator().manual_seed(3),
        _draw_shape=lambda batch: None)
    t.optimizer = torch.optim.Adam(t.params)
    return t


@pytest.mark.parametrize("case,want", [
    ("gen batch on cuda", True), ("cpu batch", False), ("ft tuple", False),
    ("several ranks", False), ("grad off", False),
    ("a leaf not a tensor", False), ("a leaf on the cpu", False)])
def test_which_steps_may_replay(case, want):
    trainer, batch = fake_trainer(), gen_batch()
    if case == "cpu batch":
        trainer, batch = fake_trainer("cpu"), gen_batch(lambda t: t)
    elif case == "ft tuple":
        batch = (np.arange(8), {"coords": on_cuda(torch.zeros(1, 4, 2))}, 3)
    elif case == "several ranks":
        trainer = fake_trainer(ranks=2)
    elif case == "a leaf not a tensor":
        batch["que"]["h"] = 8
    elif case == "a leaf on the cpu":
        batch["que"]["poses"] = torch.zeros(1, 3, 4)
    with torch.set_grad_enabled(case != "grad off"):
        assert T._graphable(trainer, batch) is want


@pytest.fixture
def anywhere(monkeypatch):
    """Any dict batch may replay, here on the CPU."""
    monkeypatch.setattr(T, "_graphable",
                        lambda trainer, batch: isinstance(batch, dict))


def twice(graphs_, trainer, batch):
    """A key's first and second step: eager, then a recording."""
    return graphs_.entry(trainer, batch), graphs_.entry(trainer, batch)


@pytest.mark.parametrize("change", [
    "shape", "dtype", "aliasing", "replaced parameter", "new optimizer"])
def test_each_part_of_the_key_gives_a_new_entry(anywhere, change):
    trainer, batch = fake_trainer("cpu"), gen_batch(lambda t: t)
    steps = T._StepGraphs()
    first, recorded = twice(steps, trainer, batch)
    assert first is None and recorded is not None
    # the same signature in new tensors is the same entry
    again = {k: dict(v) if isinstance(v, dict) else v.clone()
             for k, v in batch.items()}
    again["ref"] = {k: v.clone() for k, v in batch["ref"].items()}
    again["ref"]["true_depth"] = again["ref"]["depth"]
    assert steps.entry(trainer, again) is recorded
    if change == "shape":
        batch["que"] = {"coords": torch.zeros(1, 32, 2)}
    elif change == "dtype":
        batch["is_gso"] = torch.zeros((), dtype=torch.float64)
    elif change == "aliasing":
        batch["ref"]["true_depth"] = batch["ref"]["depth"].clone()
    elif change == "replaced parameter":
        # as build_optimizer takes them
        trainer.model.weight = nn.Parameter(trainer.model.weight.detach()
                                            .clone())
        trainer.params = list(trainer.model.parameters())
    else:
        trainer.optimizer = torch.optim.Adam(trainer.params)
    first, second = twice(steps, trainer, batch)
    assert first is None and second is not None and second is not recorded
    if change in ("replaced parameter", "new optimizer"):
        # the state every recording held changed: they are all dropped
        assert list(steps.kept.values()) == [second]


def test_a_write_to_a_parameter_keeps_the_recordings(anywhere):
    # a replay reads the parameters by address: a write outside the
    # steps is read by the next replay, and nothing is recorded anew
    trainer, batch = fake_trainer("cpu"), gen_batch(lambda t: t)
    steps = T._StepGraphs()
    _, recorded = twice(steps, trainer, batch)
    with torch.no_grad():
        trainer.model.bias.mul_(2.0)
    assert steps.entry(trainer, batch) is recorded


def test_a_key_records_at_its_second_step_and_few_are_kept(anywhere):
    trainer = fake_trainer("cpu")
    steps = T._StepGraphs()

    def batch(n):
        return {"que": {"coords": torch.zeros(1, n, 2)}}

    # shapes that never repeat never record
    for n in range(1, 11):
        assert steps.entry(trainer, batch(n)) is None
    assert not steps.kept
    for n in range(11, 11 + T.KEPT_STEPS):
        first, second = twice(steps, trainer, batch(n))
        assert first is None and second is not None
        assert steps.entry(trainer, batch(n)) is second
    kept = list(steps.kept.values())
    assert len(kept) == T.KEPT_STEPS
    # a key met once the recordings are made runs eagerly, and none of
    # them is dropped for it
    for _ in range(3):
        assert steps.entry(trainer, batch(99)) is None
    assert list(steps.kept.values()) == kept
    assert steps.entry(trainer, batch(11)) is kept[0]


def test_no_key_records_without_room_for_twice_the_largest_pool(
        anywhere, monkeypatch):
    trainer = fake_trainer("cpu")
    steps = T._StepGraphs()
    room = [10]
    monkeypatch.setattr(T, "_room", lambda device: room[0])

    def batch(n):
        return {"que": {"coords": torch.zeros(1, n, 2)}}

    _, first = twice(steps, trainer, batch(1))
    first.pool = 6             # the first recording is made unasked
    assert twice(steps, trainer, batch(2)) == (None, None)
    room[0] = 12
    assert steps.entry(trainer, batch(2)) is not None
    assert len(steps.kept) == 2


def test_the_adam_turns_capturable_and_keeps_its_state():
    model = nn.Linear(4, 4)
    opt = torch.optim.Adam(model.parameters(), lr=0.25)
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    moments = {k: v.clone() for k, v in opt.state[model.weight].items()}
    T._capturable(opt, torch.device("cpu"))
    group = opt.param_groups[0]
    assert group["capturable"] and isinstance(group["lr"], torch.Tensor)
    assert float(group["lr"]) == 0.25
    for k, v in opt.state[model.weight].items():
        assert torch.equal(v, moments[k])
    T.set_lr(opt, 0.5)
    assert float(group["lr"]) == 0.5 and isinstance(group["lr"],
                                                    torch.Tensor)


def test_staged_draws_are_the_generators_eager_sequence():
    shape = (1, 16, 8)
    entry = T._StepGraph(gen_batch(lambda t: t), shape, torch.device("cpu"))
    gen = torch.Generator().manual_seed(2 ** 40 + 9)
    want = torch.Generator().manual_seed(2 ** 40 + 9)
    for _ in range(3):
        entry.stage(gen_batch(lambda t: t), gen)
        eager = T.NeurayRenderer.draw_fine_u(shape, torch.device("cpu"),
                                             want)
        assert torch.equal(entry.draws, eager)


def test_staging_copies_the_batch_into_the_static_copies():
    entry = T._StepGraph(gen_batch(lambda t: t), None, torch.device("cpu"))
    batch = gen_batch(lambda t: t)
    batch["ref"]["depth"].fill_(2.0)
    batch["que"]["coords"].fill_(5.0)
    entry.stage(batch, torch.Generator())
    assert entry.draws is None
    assert (entry.batch["ref"]["true_depth"] == 2.0).all()
    assert entry.batch["ref"]["true_depth"] is entry.batch["ref"]["depth"]
    assert (entry.batch["que"]["coords"] == 5.0).all()


def tiny_trainer(tmp_path):
    """The trainer tests' trainer on the CPU and two samples of different
    shapes (the second with 24 of its 32 rays)."""
    trainer = T.Trainer(make_cfg(tmp_path, 8), device="cpu")
    batches = [trainer.to_device(trainer.train_dataset[i]) for i in (0, 1)]
    que = batches[1]["que"]
    batches[1]["que"] = dict(que, coords=que["coords"][:, :24])
    return trainer, batches


class RerunStep:
    """A recording without a card: ``record`` runs the step once (its
    eager run; the capture runs nothing), ``replay`` reruns it from the
    static inputs into the captured outputs, as a replay would."""
    made = 0

    def __init__(self):
        RerunStep.made += 1

    def record(self, fn):
        self.fn = fn
        out = fn()
        self.static = {k: v.clone() for k, v in out.items()}
        return out, self.static

    def replay(self):
        for k, v in self.fn().items():
            self.static[k].copy_(v)


def test_replayed_steps_equal_the_eager_steps(tmp_path, monkeypatch):
    eager, batches = tiny_trainer(tmp_path / "a")
    graphed, _ = tiny_trainer(tmp_path / "b")
    seed = 2 ** 35 + 1
    eager.generator.manual_seed(seed)
    graphed.generator.manual_seed(seed)
    order = [0, 0, 1, 0, 1, 1, 0]
    want = [eager.train_step(batches[i]) for i in order]
    monkeypatch.setattr(graphs, "SegmentedGraph", RerunStep)
    monkeypatch.setattr(T, "_graphable",
                        lambda trainer, batch: isinstance(batch, dict))
    RerunStep.made = 0
    with profile(activities=[ProfilerActivity.CPU]):
        got = [graphed.train_step(batches[i]) for i in order]
    assert got == want
    for p, q in zip(graphed.params, eager.params):
        assert torch.equal(p, q)
    counters = P.recorded().counters
    # each sample's first step eager, its second recorded (eager), then
    # replays
    assert counters["train.eager_steps"] == 4
    assert counters["train.graph_steps"] == 3
    assert RerunStep.made == 2 and graphed.opt_count == len(order)


def old_adam_update(optimizer, params, lr, losses):
    """The update as it was written before the step was split in two (one
    rank): backward, zero gradients, the values read back, Adam."""
    means = {k: v.mean() for k, v in losses.items()}
    total = sum(v for k, v in means.items() if k.startswith("loss"))
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    values = {k: v.detach() for k, v in {**means, "loss_total": total}.items()}
    values = dict(zip(values, torch.stack(list(values.values())).tolist()))
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return values


def test_the_eager_step_is_the_update_as_before(tmp_path):
    trainer, batches = tiny_trainer(tmp_path / "a")
    before, _ = tiny_trainer(tmp_path / "b")
    for t in (trainer, before):
        t.generator.manual_seed(5)
    for i in (0, 1, 0):
        got = trainer.train_step(batches[i])
        want = old_adam_update(before.optimizer, before.params,
                               before.schedule(before.opt_count),
                               before._losses(batches[i]))
        before.opt_count += 1
        assert got == want
    for p, q in zip(trainer.params, before.params):
        assert torch.equal(p, q)
    assert not trainer.step_graphs.seen and trainer.step_graphs.state is None


class FakeGraph:
    """``torch.cuda.CUDAGraph`` without a card: captures and replays do
    nothing."""

    def capture_begin(self, pool=None, capture_error_mode="global"):
        # a DataLoader's pin-memory thread runs beside the capture
        assert capture_error_mode == "thread_local"

    def capture_end(self):
        pass

    def replay(self):
        pass


def test_a_capture_counts_nothing_and_each_replay_tallies(tmp_path,
                                                          monkeypatch):
    trainer, batches = tiny_trainer(tmp_path)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, stream: None)
    monkeypatch.setattr(graphs, "_side_stream", contextlib.nullcontext)
    monkeypatch.setattr(T, "_graphable",
                        lambda trainer, batch: isinstance(batch, dict))
    adam = T.ADAM_BYTES * sum(p.numel() for p in trainer.params)
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_step(batches[0])              # eager
        trainer.train_step(batches[0])              # recorded
    assert P.recorded().counters == {"train.eager_steps": 2,
                                     "adam.bytes": 2 * adam}
    assert trainer.opt_count == 2
    entry = trainer.step_graphs.kept[T._batch_key(batches[0])]
    tallied = [args for step in entry.graph.steps if isinstance(step, tuple)
               for _, args in step[1]]
    assert ("adam.bytes", adam) in tallied
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            trainer.train_step(batches[0])          # replayed
    assert P.recorded().counters == {"train.graph_steps": 3,
                                     "adam.bytes": 3 * adam}
    assert trainer.opt_count == 5


def test_the_gather_backward_counts_at_each_replay(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(G, "_call", lambda name, index, args: None)
    monkeypatch.setattr(G, "_backward_scratch", lambda *a: 4)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    v, p, c, fh, fw = 2, 30, 64, 5, 6
    grad, coords = torch.zeros(v, p, c), torch.zeros(v, p, 2)
    seg = graphs.SegmentedGraph()
    launches = G.BACKWARD_LAUNCHES
    with profile(activities=[ProfilerActivity.CPU]):
        P.count("session", 1)
        seg.capture(lambda: G._launch_backward(grad, coords, None, fh, fw,
                                               G._HALF_PIXEL, 20, 24))
    assert G.BACKWARD_LAUNCHES == launches
    assert P.recorded().counters == {"session": 1}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            seg.replay()
    assert G.BACKWARD_LAUNCHES == launches + 2
    assert P.recorded().counters == {
        "gather.bwd_bytes": 2 * G.backward_launch_bytes(v, p, c, fh, fw,
                                                        False)}


def test_a_cpu_state_resumes_with_the_optimizers_own_settings(tmp_path):
    trainer, batches = tiny_trainer(tmp_path)
    trainer.train_step(batches[0])
    saved = trainer.optimizer.state_dict()
    saved["param_groups"][0].update(capturable=True, lr=torch.tensor(0.5))
    trainer.build_optimizer()
    assert T._restore_opt_state(trainer.optimizer, saved)
    group = trainer.optimizer.param_groups[0]
    assert group["capturable"] is False and group["lr"] == trainer.schedule(0)
    step = trainer.optimizer.state[trainer.params[0]]["step"]
    assert step.device.type == "cpu" and float(step) == 1.0


@pytest.mark.parametrize("shape", [(2, 5, 64), (1, 64, 128), (3, 7, 1)])
def test_the_cumprod_backward_is_pytorchs_without_its_read_back(shape):
    from neuray_tpu_torch.ops.compositing import _Cumprod
    gen = torch.Generator().manual_seed(11)
    x = torch.rand(shape, generator=gen) * 0.999 + 1e-10
    grad = torch.randn(shape, generator=gen)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    out = _Cumprod.apply(a)
    assert torch.equal(out, torch.cumprod(b, -1))
    assert torch.equal(torch.autograd.grad(out, a, grad)[0],
                       torch.autograd.grad(torch.cumprod(b, -1), b, grad)[0])


# ---------------- on the card ----------------

CHECK_STEPS = 5


@pytest.fixture(autouse=True)
def release_recordings():
    """A test's recordings freed before the next test: a trainer's
    reference cycles hold its pools until the collector runs."""
    yield
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@pytest.fixture(scope="module")
def card():
    """gen_depth.train's configuration, weights and a pool of 3 samples
    at its traffic's shapes, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from pb import core, program
    from traffic import train_steps
    program.set_precision()
    wl = core.load_json(BENCH / "workloads" / "gen_depth.train.json")
    config = core.load_json(BENCH / "configs" / f"{wl['config']}.json")
    dev = torch.device("cuda")
    tr = dict(wl["traffic"], pool=3)
    pool = train_steps.make_pool(np.random.default_rng(2 ** 33 + 5), tr,
                                 dev)
    return types.SimpleNamespace(config=config, tr=tr, pool=pool, dev=dev)


def card_trainer(card, out):
    """gen_depth.train's trainer with the configuration's weights, its
    fine draws seeded."""
    from neuray_tpu_torch.utils.params import load_flax_params, \
        load_params_npz
    h, w = card.tr["view_hw"]
    cfg = dict(card.config["train"], train_dataset_type="synthetic",
               train_dataset_cfg={"rfn": card.tr["views"], "h": h, "w": w},
               val_metric=["psnr_ssim"], worker_num=0,
               output_root=str(out))
    trainer = T.Trainer(cfg, device=card.dev)
    load_flax_params(trainer.renderer,
                     load_params_npz(str(ROOT / card.config["weights"])))
    trainer.generator.manual_seed(2 ** 41 + 3)
    return trainer


def counted_step(trainer, batch):
    """One step with its gather launches and counters."""
    fwd, bwd = G.LAUNCHES, G.BACKWARD_LAUNCHES
    with profile(activities=[ProfilerActivity.CUDA]):
        out = trainer.train_step(batch)
        torch.cuda.synchronize()
    rec = P.recorded()
    return out, (G.LAUNCHES - fwd, G.BACKWARD_LAUNCHES - bwd,
                 rec.counters.get("gather.bwd_bytes")), rec


def rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm().clamp_min(1e-30))


@pytest.mark.cuda
def test_replayed_steps_match_eager_steps_with_plain_adam(card, tmp_path,
                                                          monkeypatch):
    # the eager trainer never records, so its Adam stays as it was built:
    # not capturable, a float learning rate
    graphed = card_trainer(card, tmp_path / "g")
    theta0 = [p.detach().clone() for p in graphed.params]
    got, got_counts = [], []
    for i in range(CHECK_STEPS):
        if i == 1:      # the recorded step, outside a profiler session
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            fwd, bwd = G.LAUNCHES, G.BACKWARD_LAUNCHES
            got.append(graphed.train_step(card.pool[i % 3]))
            got_counts.append((G.LAUNCHES - fwd, G.BACKWARD_LAUNCHES - bwd,
                               None))
            torch.cuda.empty_cache()
            print(f"the recording's pool and static copies: "
                  f"{torch.cuda.memory_reserved() - reserved} bytes")
            continue
        out, counts, rec = counted_step(graphed, card.pool[i % 3])
        got.append(out)
        got_counts.append(counts)
    assert rec.counters.get("train.graph_steps") == 1
    spans = [(s.name, None if s.parent is None else rec.spans[s.parent].name)
             for s in rec.spans]
    pass_ = [("pass", "step.forward"), ("dist_decoder", "pass"),
             ("agg_net", "pass")]
    assert spans == [("step.forward", None), *pass_, *pass_,
                     ("step.backward", None), ("step.update", None)]
    for s in rec.spans:
        assert s.device is not None and s.device[1] > s.device[0]

    monkeypatch.setattr(T, "_graphable", lambda trainer, batch: False)
    eager = card_trainer(card, tmp_path / "e")
    want, want_counts = [], []
    for i in range(CHECK_STEPS):
        out, counts, _ = counted_step(eager, card.pool[i % 3])
        want.append(out)
        want_counts.append(counts)
    want_counts[1] = (*want_counts[1][:2], None)
    assert got_counts == want_counts and got_counts[0][0] > 0
    loss = max(abs(a["loss_total"] - b["loss_total"]) / abs(b["loss_total"])
               for a, b in zip(got, want))
    names = [n for n, _ in graphed.renderer.named_parameters()]
    state = [(graphed.optimizer.state[p], eager.optimizer.state[q])
             for p, q in zip(graphed.params, eager.params)]
    # leaves whose gradient is nought to rounding (a conv bias under an
    # instance norm) move under Adam by round-off alone: left out, as the
    # benchmark's check leaves them out
    norms = [float(e["exp_avg"].norm()) for _, e in state]
    keep = [i for i, n in enumerate(norms) if n >= 1e-3 * np.median(norms)]
    gaps = {"change": [rel(graphed.params[i] - theta0[i],
                           eager.params[i].detach() - theta0[i])
                       for i in keep]}
    for k in ("exp_avg", "exp_avg_sq"):
        gaps[k] = [rel(state[i][0][k], state[i][1][k]) for i in keep]
    print(f"5 steps, replayed vs eager: loss {loss:.3g}; {len(keep)} of "
          f"{len(names)} leaves")
    for k, v in gaps.items():
        worst = int(np.argmax(v))
        print(f"  {k}: median {np.median(v):.3g}, p90 "
              f"{np.quantile(v, 0.9):.3g}, max {v[worst]:.3g} "
              f"({names[keep[worst]]})")
    for p in graphed.params:
        assert float(graphed.optimizer.state[p]["step"]) == CHECK_STEPS
    assert graphed.optimizer.param_groups[0]["capturable"]
    assert not eager.optimizer.param_groups[0]["capturable"]
    # the gather backward sums with atomics, so no two runs are bit-equal;
    # these bars are its rounding's reach over 5 steps
    assert loss <= 1e-4
    for v in gaps.values():
        assert np.median(v) <= 1e-3


@pytest.mark.cuda
def test_an_eager_checkpoint_resumes_into_the_graphed_trainer(card,
                                                              tmp_path):
    eager = card_trainer(card, tmp_path)
    eager.step_graphs = types.SimpleNamespace(
        entry=lambda trainer, batch: None, clear=lambda: None)
    for i in range(2):
        eager.train_step(card.pool[i])
    eager._save(2, 0.0)
    graphed = card_trainer(card, tmp_path)
    assert graphed._start() == (2, 0.0)
    for p, q in zip(graphed.params, eager.params):
        assert torch.equal(p, q)
        assert torch.equal(graphed.optimizer.state[p]["exp_avg"],
                           eager.optimizer.state[q]["exp_avg"])
    for i in range(2, 6):
        graphed.train_step(card.pool[i % 3])
    assert len(graphed.step_graphs.kept) == 1
    group = graphed.optimizer.param_groups[0]
    assert group["capturable"] and isinstance(group["lr"], torch.Tensor)
    for p in graphed.params:
        assert float(graphed.optimizer.state[p]["step"]) == 6
    assert graphed.opt_count == 6


@pytest.mark.cuda
def test_the_default_mixtures_three_keys_record(card, tmp_path):
    """The default training mixture's batch keys (``KEPT_STEPS``): the
    400x600 crop padded to 400x608 (real_estate, real_iconic, space),
    GSO's 512x512 with its own true depth and the depth-loss coords, and
    DTU's 1200x1600, 8 views and 512 rays each. Each records at its
    second step and replays at its third, and the card holds the three
    pools together."""
    from traffic import train_steps
    rng = np.random.default_rng(2 ** 34 + 7)
    batches = {}
    for name, hw, depth_loss in (("crop", (400, 608), False),
                                 ("gso", (512, 512), True),
                                 ("dtu", (1200, 1600), False)):
        b = train_steps.make_pool(rng, dict(card.tr, view_hw=hw, pool=1),
                                  card.dev)[0]
        if depth_loss:
            b["ref"]["true_depth"] = b["ref"]["depth"].clone()
        else:
            del b["ref"]["true_depth"], b["depth_loss_coords"]
        batches[name] = b
    trainer = card_trainer(card, tmp_path)
    for name, b in batches.items():
        for _ in range(3):
            trainer.train_step(b)
        torch.cuda.synchronize()
    kept = trainer.step_graphs.kept
    assert [T._batch_key(b) for b in batches.values()] == list(kept)
    free, total = torch.cuda.mem_get_info()
    print("the pools: " + ", ".join(
        f"{n} {e.pool}" for n, e in zip(batches, kept.values()))
        + f" bytes; card {total}, free {free}, peak allocated "
        f"{torch.cuda.max_memory_allocated()}")
    with profile(activities=[ProfilerActivity.CPU]):
        for b in batches.values():
            trainer.train_step(b)
    assert P.recorded().counters["train.graph_steps"] == 3
