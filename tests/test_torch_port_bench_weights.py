"""The port's bench-weights trainer (``neuray_tpu_torch/make_bench_weights
.py``) against ``tools/make_bench_weights.py``: its first two steps on
the blobs and on the room (and, in
``test_torch_port_bench_weights_cv.py``, one step under ``--init
cost_volume``), against the JAX tool's ``step`` (its loss, optax's Adam
over ``exponential_decay``, its scene and coordinates), rebuilt here on
the JAX package's modules because the tool defines it inside ``main``.

Both start from the JAX tool's initial parameters, carried across by
``utils/params.py: load_flax_params``, at 64 px (the tool's CPU size; at
32 px the image encoder's InstanceNorms normalize 2x2 maps and the f32
forward alone parts by ~2e-4, as ``tests/test_torch_port_train.py``
found), 16 + 16 samples, 64 rays a step. What the two f32 programs round
apart is handed across, as in the other training tests: the fine depths
JAX sampled (fault 3: on nearly empty rays a rounding of the coarse hit
mass moves them), and the depth init net's cross-view diff features
(``test_init_net_gradients_amplify_the_diff_feature_rounding``). Losses
are held to 1e-4, gradients to 2e-3 of each leaf's norm
(``tests/test_backward_parity.py``'s bars); JAX runs at "highest" matmul
precision (hazard a).

The leaves of the two ResNets (the image encoder and the init net's
``res_net``) are held as ``tests/test_torch_port_ft_databases.py`` holds
the image encoder's (hazard j): in every f32 forward a few of their ReLU
inputs round across zero, differently in the two packages, and on these
flax-init weights such a flip moves a leaf by up to 1.3e-2 of its norm
at 64 px. The same happens outside them: on the room's first step two
inputs of the vis encoder's last ReLU (|x| ~4.5e-6) and one of the fine
aggregation net's probability embedding (1.3e-5) flip, which moved the
vis encoder's and the init net's leaves by up to 2.5e-3 and the others
by 1.1e-3 while only the ResNets' masks were replayed. So the port's step
is held to JAX's under JAX's own masks of every ReLU of the step
(``TAPPED``, read out of JAX's jitted step by ``relu_taps``; the
renderer's density ReLU is not replayed: it saw no flip in these steps)
at 2e-3 on every leaf (1.6e-4 the worst measured, on the cost-volume
step), and the port's own step's ResNet leaves to an f64 replay of
its own masks and to JAX within 2e-3 beyond what the flips alone move in
f64. Step 2's gradients are taken at JAX's parameters after step 1:
after one Adam update every coordinate has moved by about the learning
rate whatever its gradient's size, so rounding-level gradients of
opposite sign (the conv biases before an InstanceNorm) set the two
trajectories apart by more than the step's own error
(``.claude/skills/verify/SKILL.md``, gotchas): the tool's own trajectory
is held at step 2 within a tenth of the first update's effect on the
step-2 loss (its loss at the initial parameters against JAX's after the
update), as ``chip_smoke.py: check_cli_losses`` holds two training runs.

The cost-volume step runs from the tool's init with MVSNet's probability
conv sharpened (x1000, ``tests/test_torch_port_cost_volume.py: SHARP``):
MVSNet takes no gradient and stays at flax's init, whose flat volume
turns the InstanceNorms' f32 rounding into ~1e-2 (hazard i).

Also: the learning rate against optax's at every step, the written
npz read by the JAX package's ``load_params_npz`` as ``renderer.init``'s
tree leaf for leaf, and the default output outside ``tools/``.
"""
import argparse
import contextlib
import copy
import functools
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuray_tpu.data import synthetic as jsyn
from neuray_tpu.models import init_net as jN
from neuray_tpu.models import renderer as jR
from neuray_tpu.ops import sampling as jS
from neuray_tpu.train.losses import render_loss as j_render_loss
from neuray_tpu.utils.params_io import load_params_npz as j_load_npz

import chip_smoke
from neuray_tpu_torch import make_bench_weights as M
from neuray_tpu_torch.models import init_net as N
from neuray_tpu_torch.ops import sampling as S
from neuray_tpu_torch.train.losses import render_loss
from neuray_tpu_torch.utils.params import (
    flax_to_torch, load_flax_params, torch_to_flax)
from tests.test_torch_port_ft_databases import encoder_grads

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SIZE, RAYS, DN, LR, STEPS, N_QUE = 64, 64, 16, 5e-4, 40, 4
GRAD_TOL, WITNESS_TOL, FLOOR = 2e-3, 1e-3, 1e-6
SHARP = 1000.0
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def flags(scene, init="depth", **over):
    return argparse.Namespace(**{
        "steps": STEPS, "size": SIZE, "rays": RAYS, "lr": LR, "out": None,
        "scene": scene, "init": init, "n_que": N_QUE, "device": "cpu",
        **over})


# the port's ResNets in the order a training forward calls them, and the
# modules whose calls ``relu_taps`` records: the ResNets, and every other
# module of a training step that holds a ReLU (the init net's own: the
# depth skip path or the cost volume's branches; the vis encoder's
# residual blocks; the aggregation nets' probability embedding and
# density head)
RESNETS = ("init_net.res_net", "image_encoder")
TAPPED = RESNETS + ("init_net", "vis_encoder", "agg_net", "fine_agg_net")


@contextlib.contextmanager
def relu_taps(calls):
    """``tests/test_torch_port_ft_databases.py: encoder_taps`` for the
    renderer's modules in ``TAPPED`` (by their path, the port's names):
    while a step is traced each call puts a record in ``calls`` under its
    module's name, which the step fills through ``jax.debug.callback``:
    ``masks``, each ReLU's input > 0 in call order (a ReLU of a nested
    tapped module goes to the innermost), and for the ResNets ``x`` the
    input and ``g`` the gradient of the output."""
    own_relu, inside = nn.relu, []

    def keep(rec, key, value, index=None):
        def put(v):
            if index is None:
                rec[key] = np.asarray(v)
            else:
                rec[key][index] = np.asarray(v)
        jax.debug.callback(put, value)

    def relu(x):
        if inside:
            rec = inside[-1]
            rec["masks"].append(None)
            keep(rec, "masks", x > 0, len(rec["masks"]) - 1)
        return own_relu(x)

    def intercept(next_fun, args, kwargs, context):
        name = ".".join(context.module.path)
        if name not in TAPPED or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        assert name not in calls, name
        rec = calls[name] = {"masks": []}
        resnet = name in RESNETS
        if resnet:
            keep(rec, "x", args[0])
        inside.append(rec)
        try:
            y = next_fun(*args, **kwargs)
        finally:
            inside.pop()
        if not resnet:
            return y

        @jax.custom_vjp
        def tap(y):
            return y

        def bwd(_, g):
            keep(rec, "g", g)
            return (g,)

        tap.defvjp(lambda y: (y, None), bwd)
        return tap(y)

    nn.relu = relu
    try:
        with nn.intercept_methods(intercept):
            yield
    finally:
        nn.relu = own_relu


# the JAX steps' tapped modules' records by init net (made when a step is
# traced, filled when it runs) and fine depths (taken when it is traced)
CALLS, CAPTURED = {"depth": {}, "cost_volume": {}}, []


@functools.lru_cache(None)
def jax_tool_step(init):
    """``tools/make_bench_weights.py``'s renderer, Adam over
    ``exponential_decay`` and jitted ``step`` (its lines 97-167) at the
    CPU's 16 + 16 samples, with the scene an argument (the tool's closes
    over it) so that the scenes share one compile: (renderer, optimizer,
    step, init). The step also returns the gradients and the fine depths
    it sampled; the tapped modules' records go to ``CALLS[init]``."""
    renderer = jR.NeurayRenderer(jR.RenderConfig(
        init_net_type=init, use_hierarchical_sampling=True,
        depth_sample_num=DN, fine_depth_sample_num=DN, ray_batch_num=RAYS,
        use_vis=False, fine_use_vis=False, use_bf16=False,
        gather_quant="none"))
    parts = j_render_loss({"use_nr_fine_loss": True, "use_ray_mask": True})
    opt = optax.adam(optax.exponential_decay(LR, STEPS, 0.05,
                                             staircase=False))

    def loss_fn(params, ref, src, que, key):
        CAPTURED.clear()
        out = renderer.apply(params, ref, que, True, src=src,
                             rngs={"sample": key})
        losses = parts(out, {})
        return sum(jnp.mean(v) for v in losses.values()), CAPTURED[-1]

    @jax.jit
    def step(params, opt_state, ref, src, que, key):
        (loss, fine), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, ref, src, que, key)
        updates, opt_state = opt.update(grads, opt_state)
        return (optax.apply_updates(params, updates), opt_state, loss, grads,
                fine)

    init_fn = jax.jit(lambda rngs, ref, src, que: renderer.init(
        rngs, ref, que, True, src=src))
    return renderer, opt, step, init_fn


class JaxTool:
    """The JAX tool's scene, queries and first steps on ``jax_tool_step``:
    for each step the parameters before it, its loss, gradients and fine
    depths and its tapped modules' records."""

    def __init__(self, scene, init):
        renderer, opt, step, init_fn = jax_tool_step(init)
        spheres = {"blobs": jsyn.make_blob_spheres(np.random.RandomState(42)),
                   "room": jsyn.make_room_spheres(np.random.RandomState(42))
                   }[scene]
        depth_range = (jsyn.ROOM_DEPTH_RANGE if scene == "room"
                       else jsyn.DEPTH_RANGE)
        ref = {k: jnp.asarray(v) for k, v in jsyn.make_sphere_scene(
            np.random.RandomState(0), 8, SIZE, SIZE, spheres,
            depth_range).items()}
        src = None
        if init == "cost_volume":
            poses_np = np.asarray(ref["poses"])
            centers = np.stack([-p[:, :3].T @ p[:, 3] for p in poses_np])
            ref["nn_ids"] = jnp.asarray(np.stack([
                np.argsort(np.linalg.norm(centers - centers[i], axis=1))[1:4]
                for i in range(len(centers))]).astype(np.int32))
            src = {k: ref[k] for k in ("imgs", "poses", "Ks", "depth_range")}
        self.ques = [
            {k: jnp.asarray(v) for k, v in jsyn.make_query(
                np.random.RandomState(100 + i), SIZE, SIZE, rn=0,
                full_image=False, spheres=spheres,
                depth_range=depth_range).items() if k != "coords"}
            for i in range(N_QUE)]
        self.diff = self.depth_n = None
        if init == "depth":
            depth_n = jN.extract_depth_for_init(ref["depth_range"],
                                                ref["depth"])
            self.depth_n = np.asarray(depth_n)
            self.diff = np.asarray(jax.jit(jN.get_diff_feats)(
                ref["imgs"], depth_n, ref["depth_range"], ref["poses"],
                ref["Ks"]))
        self.params = init_fn(
            {"params": jax.random.PRNGKey(0),
             "sample": jax.random.PRNGKey(1)}, ref, src,
            {**self.ques[0], "coords": jnp.zeros((1, RAYS, 2), jnp.float32)})
        if init == "cost_volume":
            self.params = sharpened(self.params)
        orig = jS.sample_fine_depth

        def capture(*args, **kw):
            CAPTURED.append(orig(*args, **kw))
            return CAPTURED[-1]

        calls = CALLS[init]
        with pytest.MonkeyPatch.context() as mp, relu_taps(calls):
            mp.setattr(jS, "sample_fine_depth", capture)
            opt_state = opt.init(self.params)
            host_rng = np.random.RandomState(7)
            self.steps = []
            params = self.params
            for i in range(2 if init == "depth" else 1):
                q = dict(self.ques[i % N_QUE])
                q["coords"] = jnp.asarray(np.stack(
                    [host_rng.randint(0, SIZE, RAYS),
                     host_rng.randint(0, SIZE, RAYS)],
                    -1)[None].astype(np.float32))
                new, opt_state, loss, grads, fine = step(
                    params, opt_state, ref, src, q, jax.random.PRNGKey(i))
                jax.effects_barrier()
                # the tapped modules' records, filled by this run
                assert calls.keys() == set(TAPPED)
                self.steps.append({"params": params, "loss": float(loss),
                                   "grads": grads, "fine": np.asarray(fine),
                                   "taps": copy.deepcopy(calls)})
                params = new


def sharpened(tree):
    """MVSNet's probability conv kernel x SHARP."""
    p = tree["params"]
    mv = p["init_net"]["mvsnet"]
    cr = dict(mv["cost_regularization"])
    cr["prob"] = {"kernel": cr["prob"]["kernel"] * SHARP,
                  "bias": cr["prob"]["bias"]}
    return {"params": {**p, "init_net": {**p["init_net"], "mvsnet": {
        **mv, "cost_regularization": cr}}}}


def flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def by_port_name(grads):
    """A flax gradient tree keyed by the port's parameter names."""
    return {k: v.double() for k, v in flax_to_torch(grads).items()}


def rel(a, b):
    return ((a - b).norm() / max(b.norm().item(), FLOOR)).item()


class PortTool:
    """The port tool's model, scene and queries (``make_bench_weights.
    build``) from the JAX tool's initial parameters, handed JAX's fine
    depths and diff features."""

    def __init__(self, monkeypatch, tool, scene, init):
        self.tool = tool
        self.renderer, self.ref, self.src, self.ques = M.build(
            flags(scene, init), CPU)
        load_flax_params(self.renderer, tool.steps[0]["params"])
        self.fines = []
        monkeypatch.setattr(S, "sample_fine_depth", lambda *a, **k: torch.
                            from_numpy(self.fines.pop(0).copy()))
        if tool.diff is not None:
            monkeypatch.setattr(N, "get_diff_feats", lambda *a: torch.
                                from_numpy(tool.diff.copy()))
            monkeypatch.setattr(N, "extract_depth_for_init", lambda *a:
                                torch.from_numpy(tool.depth_n.copy()))
        host_rng = np.random.RandomState(7)
        self.coords = [torch.from_numpy(M.step_coords(host_rng, SIZE, RAYS))
                       for _ in tool.steps]

    def que(self, i):
        return dict(self.ques[i % N_QUE], coords=self.coords[i])

    def trajectory(self):
        """The tool's own steps (its Adam): their loss values."""
        optimizer = torch.optim.Adam(list(self.renderer.parameters()),
                                     lr=LR, betas=(0.9, 0.999), eps=1e-8)
        generator = torch.Generator().manual_seed(7)
        losses = []
        for i, step in enumerate(self.tool.steps):
            self.fines.append(step["fine"])
            losses.append(M.train_step(
                self.renderer, optimizer, self.ref, self.src, self.que(i),
                M.lr_at(LR, STEPS, i), generator)["loss_total"])
        return losses

    def loss_at(self, params, i):
        """Step i's loss at the flax tree ``params``, no update."""
        load_flax_params(self.renderer, params)
        self.fines.append(self.tool.steps[i]["fine"])
        with torch.no_grad():
            out = self.renderer(self.ref, self.que(i), True, None,
                                torch.Generator(), self.src)
            losses = render_loss(M.LOSS_CFG)(out, {})
        return sum(v.mean() for v in losses.values()).item()

    def replayed_gradients(self, i):
        """Step i's gradients by name at JAX's parameters before it, with
        the ReLUs of every tapped module passing where JAX's did."""
        load_flax_params(self.renderer, self.tool.steps[i]["params"])
        self.fines.append(self.tool.steps[i]["fine"])
        records = self.tool.steps[i]["taps"]
        with replaying([self.renderer.get_submodule(n) for n in TAPPED],
                       [records[n] for n in TAPPED]):
            M.train_step(self.renderer,
                         torch.optim.Adam(list(self.renderer.parameters())),
                         self.ref, self.src, self.que(i), 0.0,
                         torch.Generator())
        return {n: p.grad.double()
                for n, p in self.renderer.named_parameters()}

    def gradients(self, i):
        """Step i's ``train_step`` at JAX's parameters before it: (loss,
        gradients by name, for each ResNet its copy at those parameters
        and its record: input, output gradient, ReLU masks)."""
        load_flax_params(self.renderer, self.tool.steps[i]["params"])
        nets = {n: self.renderer.get_submodule(n) for n in RESNETS}
        copies = {n: copy.deepcopy(m) for n, m in nets.items()}
        optimizer = torch.optim.Adam(list(self.renderer.parameters()))
        self.fines.append(self.tool.steps[i]["fine"])
        kept, hooks, tapes = {}, [], []
        for name, net in nets.items():
            def keep(module, inputs, output, name=name):
                output.retain_grad()
                kept[name] = (inputs[0].detach(), output)
            hooks.append(net.register_forward_hook(keep))
            tapes.append(chip_smoke.relu_tape(net))
        try:
            loss = M.train_step(self.renderer, optimizer, self.ref,
                                self.src, self.que(i), M.lr_at(LR, STEPS, i),
                                torch.Generator())["loss_total"]
        finally:
            for _, restore in reversed(tapes):
                restore()
            for h in hooks:
                h.remove()
        grads = {n: p.grad.double()
                 for n, p in self.renderer.named_parameters()}
        records = {n: (copies[n], {"x": kept[n][0], "g": kept[n][1].grad,
                                   "masks": masks})
                   for n, (masks, _) in zip(RESNETS, tapes)}
        return loss, grads, records


@contextlib.contextmanager
def replaying(nets, records):
    """While each of ``nets`` runs its forward, its ReLUs (``F.relu`` and
    the ``relu`` final of ``models/ibrnet.py: _Seq``) pass where the JAX
    record's masks (in call order; conv maps NHWC) say; each record's
    masks are used up, each on an input of its shape."""
    F = torch.nn.functional
    own, active = F.relu, []

    def relu(x, inplace=False):
        if not active:
            return own(x, inplace=inplace)
        masks, used = active[-1]
        m = masks[len(used)]
        if m.ndim == 4:
            m = np.moveaxis(m, -1, 1)
        assert m.shape == x.shape, (m.shape, x.shape)
        used.append(m)
        return x * torch.from_numpy(m.copy()).to(x.dtype)

    def leave(*args):
        active.pop()

    handles, states = [], []
    for net, rec in zip(nets, records):
        state = (rec["masks"], [])
        states.append(state)
        handles.append(net.register_forward_pre_hook(
            lambda *a, state=state: active.append(state)))
        handles.append(net.register_forward_hook(leave))
    finals = [m for net in nets for m in net.modules()
              if getattr(m, "final", None) is own]
    F.relu = relu
    for m in finals:
        m.final = relu
    try:
        yield
    finally:
        F.relu = own
        for m in finals:
            m.final = own
        for h in handles:
            h.remove()
    assert all(len(used) == len(masks) for masks, used in states)


def check_resnet(net, ours, theirs, port, jax_, x_tol, tol):
    """One ResNet's leaves (``port``, ``jax_``: the step's gradients by
    the net's own names) as the module's doc says. Returns the worst
    relative errors."""
    np.testing.assert_allclose(ours["x"].numpy(), theirs["x"], rtol=0,
                               atol=x_tol)
    assert len(ours["masks"]) == len(theirs["masks"])
    flips = sum(int((m.numpy() != np.moveaxis(j, -1, 1)).sum())
                for m, j in zip(ours["masks"], theirs["masks"]))
    # the port's f32 net on JAX's input, output gradient and masks
    replayed = encoder_grads(net, [theirs])
    bad = {k: rel(replayed[k], w) for k, w in jax_.items()
           if (replayed[k] - w).norm() > GRAD_TOL * w.norm() + FLOOR}
    assert not bad, bad
    # the port's own step against the f64 replay of its own masks, and
    # against JAX beyond what the flips alone move in f64
    own = encoder_grads(net, [ours], f64=True)
    swapped = encoder_grads(net, [dict(ours, masks=theirs["masks"])],
                            f64=True)
    for k, w in jax_.items():
        got = port[k]
        assert ((got - own[k]).norm() <= WITNESS_TOL * own[k].norm()
                + FLOOR), k
        moved = (own[k] - swapped[k]).norm()
        assert (got - w).norm() <= moved + tol * w.norm() + FLOOR, k
    big = [k for k, w in jax_.items() if w.norm() > 1e-4]
    return {"replayed": max(rel(replayed[k], jax_[k]) for k in big),
            "own": max(rel(port[k], own[k]) for k in big),
            "jax": max(rel(port[k], jax_[k]) for k in big),
            "flips": max(rel(own[k], swapped[k]) for k in big),
            "flipped": flips}


def check_step(port: PortTool, i: int):
    """Step i's loss and gradients: under JAX's ReLU masks every leaf to
    JAX's at 2e-3; the port's own step's ResNets by ``check_resnet``.
    Returns the worst relative errors."""
    step = port.tool.steps[i]
    want = by_port_name(step["grads"])
    under = port.replayed_gradients(i)
    assert under.keys() == want.keys()
    bad = {k: rel(under[k], w) for k, w in want.items()
           if (under[k] - w).norm() > GRAD_TOL * w.norm() + FLOOR}
    assert not bad, bad
    worst = {"JAX's masks": max(rel(under[k], w) for k, w in want.items()
                                if w.norm() > 1e-4)}
    loss, grads, records = port.gradients(i)
    assert abs(loss - step["loss"]) <= 1e-4, (loss, step["loss"])
    for name, (net, ours) in records.items():
        pre = name + "."
        # the init net's input: the images, the diff features (JAX's,
        # handed across) and the normalized inverse depth, which the two
        # packages round apart by up to ~2e-6
        got = check_resnet(
            net, ours, step["taps"][name],
            {k[len(pre):]: grads[k] for k in want if k.startswith(pre)},
            {k[len(pre):]: v for k, v in want.items() if k.startswith(pre)},
            0.0 if name == "image_encoder" else 1e-5, GRAD_TOL)
        worst.update({f"{name} {k}": v for k, v in got.items()})
    return worst


@pytest.mark.parametrize("scene", ["blobs", "room"])
def test_first_two_steps(monkeypatch, scene):
    tool = JaxTool(scene, "depth")
    port = PortTool(monkeypatch, tool, scene, "depth")
    first, second = port.trajectory()
    assert abs(first - tool.steps[0]["loss"]) <= 1e-4
    effect = abs(tool.steps[1]["loss"]
                 - port.loss_at(tool.steps[0]["params"], 1))
    assert abs(second - tool.steps[1]["loss"]) <= 0.1 * effect, (
        second, tool.steps[1]["loss"], effect)
    want = tool.steps[1]["loss"]
    print(f"{scene}: step 2's loss {second:.6f}, JAX {want:.6f}, the first "
          f"update's effect {effect:.6f}")
    for i in range(2):
        worst = check_step(port, i)
        print(f"{scene} step {i + 1}: worst of a leaf's norm "
              + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def test_learning_rate_is_optax():
    sched = optax.exponential_decay(LR, 1500, 0.05, staircase=False)
    for step in (0, 1, 2, 37, 750, 1499):
        np.testing.assert_allclose(M.lr_at(LR, 1500, step),
                                   float(sched(step)), rtol=1e-6)


def test_size_rules():
    assert M.train_size(400, "depth", CPU) == 64
    assert M.train_size(400, "cost_volume", torch.device("cuda")) == 384
    assert M.train_size(40, "cost_volume", CPU) == 32


def test_npz_round_trip(tmp_path):
    """Two steps on the pan scene through ``main``: the file is the
    flax tree ``renderer.init`` gives, leaf for leaf, read by the JAX
    package's ``load_params_npz``, and holds the trained parameters at
    f16."""
    out = tmp_path / "w.npz"
    trained, record = M.main(["--scene", "pan", "--steps", "2", "--size",
                              "32", "--rays", "32", "--n-que", "2",
                              "--device", "cpu", "--out", str(out)])
    assert record["out"] == str(out) and record["steps"] == 2
    assert np.isfinite([record["first_loss"], record["last_loss"]]).all()
    tree = j_load_npz(str(out))
    renderer = jR.NeurayRenderer(jR.RenderConfig(
        use_hierarchical_sampling=True, depth_sample_num=DN,
        fine_depth_sample_num=DN, use_vis=False, fine_use_vis=False))
    ref = {k: jnp.asarray(v) for k, v in jsyn.make_sphere_scene(
        np.random.RandomState(0), 2, SIZE, SIZE).items()}
    que = {k: jnp.asarray(v) for k, v in jsyn.make_query(
        np.random.RandomState(1), SIZE, SIZE, 8).items()}
    want = jax.eval_shape(lambda: renderer.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        ref, que, True))
    got = flat(tree)
    shapes = {"/".join(str(k.key) for k in path): v for path, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    assert got.keys() == shapes.keys()
    for k, v in shapes.items():
        assert got[k].shape == v.shape and got[k].dtype == np.float32, k
    # the trained parameters, each rounded to f16
    for k, v in flat(torch_to_flax(trained)).items():
        np.testing.assert_array_equal(got[k], v.astype(np.float16), k)


def test_default_output_outside_tools():
    for scene in ("sphere", "blobs", "room", "pan"):
        for init in ("depth", "cost_volume"):
            path = M.default_out(scene, init).resolve()
            assert (ROOT / "tools") not in path.parents
            assert path.parent == ROOT / "build" / "bench_weights"
    assert M.default_out("room", "cost_volume").name == \
        "bench_weights_room_cv.npz"
    assert M.default_out("sphere", "depth").name == "bench_weights.npz"
