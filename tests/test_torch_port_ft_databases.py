"""Finetuning outside NeRF-synthetic: the shipped FT configs of the DTU
test set (``configs/train/ft/neuray_ft_depth_fern.yaml``), of an LLFF
COLMAP capture (``neuray_ft_depth_birds.yaml``) and of the example
layout (``example/neuray_ft_desktop_pretrain.yaml``, split
``example_3``), each through the port's ``FtRenderer`` against the JAX
package's on the same fabricated scene (``data/fabricate.py``): the
split's ids, the padded reference images (``ref_pad_interval`` 16), the
ray_feats that ``init_params`` takes from a gen checkpoint (1e-4; see
``check_init`` for birds' size), and one finetuning step of the JAX
package's own ``make_train_step``: its outputs at 1e-4, losses at 1e-5,
and every gradient, ``ray_feats`` included, at 2e-3 per leaf in relative
norm. The image encoder's leaves are held to JAX under JAX's own ReLU
masks: a forward's f32 rounding flips a few of the encoder's ReLUs (1-34
elements in millions here), differently in each package, and one flip
moves the leaves above it by up to 2.4e-2 of their norm (ROADMAP hazard
j). So each encoder call's input and output gradient are held to JAX's,
the port's f32 encoder replaying JAX's masks on them to JAX's gradients
at 2e-3 (measured at most 2.3e-4, birds), the port's own step to an f64
replay of its own masks at 1e-3 (at most 2.2e-4), and the port's step to
JAX's within 2e-3 beyond what the flips alone move them in f64 (the
flips read up to 2.8e-3, 5.3e-3 and 2.4e-2 on fern, birds and desktop;
with the masks equal, the step would be held at 2e-3 plain).

Scenes at test size, each padded in its own way. fern: the DTU-test
layout, 10 views at 1600x1200 (the reader scales K from that size) read
at 80x60, padded to 80x64 (height only, as the real 800x600 pads to
800x608). birds: 5 LLFF originals at 1008x756, read at the ``high``
cache size and padded to 1008x768 (the real scene's shape; the ``low``
size cannot be read with depth: the dense depths are the high size's).
desktop: the example layout, 8 views 72x40 (not resized), padded to
80x48 (the card's 1280x720 makes a 180-row map). The FT nets are the
trained ``tools/bench_weights.npz``'s, the gen checkpoint the same
weights; 32 query rays, all on the sphere (on nearly empty rays the fine
sampler amplifies rounding: ROADMAP Queue 3, fault 3), 3 reference
views, 8 + 8 samples; JAX's fine draws are handed to the port, and JAX
runs at "highest" matmul precision. One file a database, so that the
suite's workers take them side by side.
"""
import contextlib
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import flax.linen as nn
import jax.numpy as jnp
import optax

from neuray_tpu.data import database as jDB
from neuray_tpu.models import ft as jF
from neuray_tpu.models import renderer as jR
from neuray_tpu.models.resunet import ResUNetLight
from neuray_tpu.ops import sampling as jS
from neuray_tpu.train import losses as jL
from neuray_tpu.utils.config import load_cfg

from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data import fabricate as FAB
from neuray_tpu_torch.models import ft as F
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.selfcheck import write_gen_checkpoint
from neuray_tpu_torch.train.losses import build_losses
from neuray_tpu_torch.utils.params import (
    flax_to_torch, ft_torch_to_flax, load_ft_flax_params, load_params_npz)
import chip_smoke
from tests.test_torch_port_train import compare_grad_trees

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GEN_CFG = dict(name="gen", init_net_type="depth",
               use_hierarchical_sampling=True, depth_sample_num=8,
               fine_depth_sample_num=8, dist_decoder_cfg={"use_vis": False})
GRAD_TOL = 2e-3
# the image encoder's gradients against the f64 replay of the port's own
# ReLU masks, in relative norm (measured up to 2.2e-4 at birds' shape)
WITNESS_TOL = 1e-3
CUTS = dict(gen_cfg=GEN_CFG, init_view_num=3, neighbor_view_num=3,
            train_ray_num=32, foreground_ratio=1.0, depth_sample_num=8,
            fine_depth_sample_num=8, ray_batch_num=256, ray_mask_point_num=4)


@dataclasses.dataclass(frozen=True)
class Case:
    config: str          # the shipped file under configs/train/ft
    write: tuple         # (writer name in data/fabricate.py, kwargs)
    database: str        # what the test scene is read as
    padded: tuple        # the padded reference images' (h, w)


CASES = {
    "fern": Case("neuray_ft_depth_fern.yaml",
                 ("write_dtu_test", dict(name="fern", n=10)),
                 "dtu_test/fern/black_80", (64, 80)),
    "birds": Case("neuray_ft_depth_birds.yaml",
                  ("write_llff_colmap", dict(name="birds", n=5, h=756,
                                             w=1008)),
                  "llff_colmap/birds/high", (768, 1008)),
    "desktop": Case("example/neuray_ft_desktop_pretrain.yaml",
                    ("write_example", dict(name="desktop", n=8, h=40, w=72)),
                    "example/desktop", (48, 80)),
}


def t(x):
    return torch.from_numpy(np.array(x))


def ft_cfg(case: Case, out: str) -> dict:
    cfg = load_cfg(str(ROOT / "configs" / "train" / "ft" / case.config))
    return {**cfg, **CUTS, "database_name": case.database,
            "output_root": out}


@pytest.fixture(scope="module")
def weights():
    return load_params_npz(str(ROOT / "tools" / "bench_weights.npz"))


def build(name, tmp_path_factory, weights):
    """The scene, both FtRenderers (the port's initialized from the gen
    checkpoint), JAX's ray_feats from the gen model and JAX's first
    finetuning step read out of its jitted step."""
    case = CASES[name]
    root = tmp_path_factory.mktemp(f"ft_{name}")
    writer, kw = case.write
    assert getattr(FAB, writer)(str(root / "data"), **kw).split("/")[:2] \
        == case.database.split("/")[:2]
    write_gen_checkpoint(root / "model", GEN_CFG, weights)
    cfg = ft_cfg(case, str(root / "model"))
    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision("highest"):
        mp.setattr(DB, "DATA_ROOT", str(root / "data"))
        mp.setattr(jDB, "DATA_ROOT", str(root / "data"))
        jft = jF.FtRenderer(dict(cfg))
        ft = F.FtRenderer(dict(cfg), device="cpu")
        ft.init_params()
        init_port = ft.ray_feats.detach().numpy().copy()
        gen_j = jR.NeurayRenderer(jR.RenderConfig.from_cfg(GEN_CFG))
        init_jax = np.asarray(jft.init_ray_feats_from_gen(gen_j, weights))
        net = {"params": {k: v for k, v in weights["params"].items()
                          if k != "init_net"}}
        tree = {"net": net, "ray_feats": init_jax}
        step = jax_step(jft, cfg, tree)
    load_ft_flax_params(ft, tree)
    return dict(case=case, cfg=cfg, jft=jft, ft=ft, init_port=init_port,
                init_jax=init_jax, step=step)


def on_sphere(que, n, seed):
    """que with its n rays moved onto pixels of its image that see the
    sphere (the fabricated backgrounds are black)."""
    img = np.asarray(que["imgs"])[0]
    ys, xs = np.nonzero(img.sum(-1) > 0.05)
    pick = np.random.RandomState(seed).choice(ys.size, n, replace=False)
    return dict(que, coords=np.stack([xs[pick], ys[pick]], -1)[None]
                .astype(np.float32))


@contextlib.contextmanager
def encoder_taps(calls):
    """While a step is traced, each call of JAX's image encoder
    (``ResUNetLight``) appends a record to ``calls`` that the step fills
    through ``jax.debug.callback``: ``x`` its input, ``g`` the gradient of
    its output (an identity with a custom VJP) and ``masks``, each ReLU's
    input > 0 in call order (``flax.linen.relu`` patched)."""
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
        if not (isinstance(context.module, ResUNetLight)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        rec = {"masks": []}
        calls.append(rec)
        keep(rec, "x", args[0])
        inside.append(rec)
        try:
            y = next_fun(*args, **kwargs)
        finally:
            inside.pop()

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


def jax_step(jft, cfg, tree):
    """One step of the JAX package's ``make_train_step`` (optax.adam after
    an identity transformation that reads the gradients out), its fine
    draws, outputs, losses and image encoder calls (``encoder_taps``)
    read out with ``jax.debug.callback``."""
    draws, outs, grads, calls = [], [], [], []
    orig = jS.sample_fine_depth

    def capture(depth, hit_prob, dr, fdn, random_sample, rng=None,
                inv_mode=True):
        if random_sample:
            u = jax.random.uniform(rng, (*hit_prob.shape[:-1], fdn))
            jax.debug.callback(lambda x: draws.append(np.asarray(x)), u)
        return orig(depth, hit_prob, dr, fdn, random_sample, rng, inv_mode)

    loss_fn = jL.build_losses(cfg)

    def loss_and_capture(outputs, data_gt):
        losses = loss_fn(outputs, data_gt)
        jax.debug.callback(lambda o, l: outs.append((o, l)), outputs, losses)
        return losses

    def update(updates, state, params=None):
        jax.debug.callback(lambda g: grads.append(g), updates)
        return updates, state

    opt = optax.chain(optax.GradientTransformation(
        lambda p: optax.EmptyState(), update), optax.adam(1e-4))
    que_i, ref_idx = jft.sample_train_indices(np.random.RandomState(3))
    que = on_sphere(jft._build_que_train(ref_idx, que_i,
                                         np.random.RandomState(4)),
                    cfg["train_ray_num"], 5)
    params = jax.tree.map(jnp.asarray, tree)
    with pytest.MonkeyPatch.context() as mp, encoder_taps(calls):
        mp.setattr(jS, "sample_fine_depth", capture)
        jft.make_train_step(opt, loss_and_capture)(
            params, opt.init(params), np.asarray(ref_idx), que,
            np.asarray(que_i), jax.random.PRNGKey(0))
    jax.effects_barrier()
    assert len(draws) == len(outs) == len(grads) == 1
    return {"que_i": que_i, "ref_idx": ref_idx, "que": que,
            "u": draws[0], "outputs": outs[0][0], "losses": outs[0][1],
            "grads": grads[0], "encoder": calls}


def port_step(c):
    """The port's forward, losses and gradients on JAX's batch and draws,
    and its image encoder's calls: each call's input, the gradient of its
    output and its ReLU masks (``chip_smoke.py``'s ``relu_tape``), as
    ``encoder_taps`` records JAX's."""
    ft, step = c["ft"], c["step"]
    enc = ft.net.image_encoder
    que = {k: t(v) for k, v in step["que"].items()}
    ft.zero_grad(set_to_none=True)
    calls = []

    def keep(module, inputs, output):
        output.retain_grad()
        calls.append((inputs[0].detach(), output))

    hook = enc.register_forward_hook(keep)
    masks, restore = chip_smoke.relu_tape(enc)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(R.NeurayRenderer, "draw_fine_u", staticmethod(
                lambda shape, device, generator: t(step["u"])))
            out = ft(step["ref_idx"], que, step["que_i"])
        losses = build_losses(c["cfg"])(out, {})
        total = sum(v.mean() for k, v in losses.items()
                    if k.startswith("loss"))
        total.backward()
    finally:
        restore()
        hook.remove()
    per = len(masks) // len(calls)
    records = [{"x": x, "g": y.grad, "masks": masks[i * per:(i + 1) * per]}
               for i, (x, y) in enumerate(calls)]
    return out, losses, ft_torch_to_flax(
        ft, {n: p.grad for n, p in ft.named_parameters()}), records


def encoder_grads(enc, calls, f64=False):
    """``enc``'s parameter gradients summed over ``calls`` (records of
    ``x``, ``g``, ``masks``): each call run on its input with each ReLU
    passing where its masks say and taken back from its output gradient;
    in f32 by the port's encoder itself, or in f64 by
    ``chip_smoke.encoder_f64``."""
    total = {}
    for rec in calls:
        x, g = torch.as_tensor(np.array(rec["x"])), torch.as_tensor(
            np.array(rec["g"]))
        # the port's masks are NCHW tensors, JAX's NHWC arrays
        masks = [torch.from_numpy(np.moveaxis(m, -1, 1).copy())
                 if isinstance(m, np.ndarray) else m for m in rec["masks"]]
        if f64:
            got = chip_smoke.encoder_f64(enc, x, g, masks=masks, prefix="")[0]
            got = {k.lstrip("."): v for k, v in got.items()}
        else:
            params = dict(enc.named_parameters())
            used, restore = chip_smoke.relu_tape(replay=masks)
            try:
                got = dict(zip(params, torch.autograd.grad(
                    enc(x), list(params.values()), g)))
            finally:
                restore()
            assert len(used) == len(masks)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v.double()
    return total


# ---- the checks, shared by the three cases ----

def check_split(c):
    ours = DB.get_database_split(c["ft"].database, c["cfg"]["database_split"])
    theirs = jDB.get_database_split(c["jft"].database,
                                    c["cfg"]["database_split"])
    assert [list(x) for x in ours] == [list(x) for x in theirs]
    np.testing.assert_array_equal(c["ft"].ref_ids, c["jft"].ref_ids)
    np.testing.assert_array_equal(c["ft"].val_ids, c["jft"].val_ids)
    assert len(c["ft"].val_ids) > 0


def check_init(c):
    ft, jft = c["ft"], c["jft"]
    n = len(ft.ref_ids)
    h, w = c["case"].padded
    assert tuple(ft.ref_store["imgs"].shape) == tuple(
        np.shape(jft.ref_store["imgs"])) == (n, h, w, 3)
    for k, v in jft.ref_store.items():
        if k in ft.ref_store:
            # K and pose within 1e-6, as the databases give them
            # (``tests/test_torch_port_databases.py``)
            np.testing.assert_allclose(
                ft.ref_store[k].numpy(), np.asarray(v), rtol=0,
                atol=1e-6 if k in ("Ks", "poses") else 0, err_msg=k)
    assert c["init_port"].shape == c["init_jax"].shape == (n, h // 4, w // 4,
                                                           32)
    # 1e-4, but for 1 element in 10^4, which may reach 2e-4: at birds'
    # 1008x768 the init net's InstanceNorms sum 40x the terms of a 64x64
    # view, and 76 of its 6.2M values land past 1e-4 (at most 1.58e-4)
    err = np.abs(c["init_port"] - c["init_jax"])
    assert err.max() <= 2e-4 and (err > 1e-4).mean() <= 1e-4, (
        err.max(), (err > 1e-4).sum())


def check_step(c):
    out, losses, grads, calls = port_step(c)
    theirs = c["step"]
    assert set(out) == set(theirs["outputs"])
    for k, v in theirs["outputs"].items():
        if k.startswith("ray_mask"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(v))
        else:
            np.testing.assert_allclose(out[k].detach().numpy(),
                                       np.asarray(v), rtol=0, atol=1e-4,
                                       err_msg=k)
    assert set(losses) == set(theirs["losses"])
    for k, v in theirs["losses"].items():
        np.testing.assert_allclose(losses[k].detach().numpy(), np.asarray(v),
                                   rtol=0, atol=1e-5, err_msg=k)
    # every leaf but the image encoder's against JAX
    enc = grads["net"]["params"].pop("image_encoder")
    enc_j = theirs["grads"]["net"]["params"].pop("image_encoder")
    try:
        n = compare_grad_trees(grads, theirs["grads"])
        assert n == 1 + len(jax.tree_util.tree_leaves(
            theirs["grads"]["net"]))
    finally:
        theirs["grads"]["net"]["params"]["image_encoder"] = enc_j
    check_encoder(c, calls, flax_to_torch(enc), flax_to_torch(enc_j))
    g = np.abs(grads["ray_feats"]).reshape(len(c["ft"].ref_ids), -1).max(-1)
    touched = set(theirs["ref_idx"]) | {theirs["que_i"]}
    assert all((g[i] > 0) == (i in touched) for i in range(len(g)))


def rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def check_encoder(c, calls, port, jax_):
    """The image encoder's leaves (``port``, ``jax_``: the two steps'
    gradients by the port's names) against JAX under JAX's ReLU masks,
    and the port's step beyond them by what the flips move in f64 (the
    module docstring)."""
    enc = c["ft"].net.image_encoder
    theirs = c["step"]["encoder"]
    assert len(calls) == len(theirs) == 2      # reference views, query
    flips, cot = 0, 0.0
    for ours, rec in zip(calls, theirs):
        np.testing.assert_array_equal(ours["x"].numpy(), rec["x"])
        cot = max(cot, rel(ours["g"], torch.from_numpy(np.array(rec["g"]))))
        assert cot <= GRAD_TOL
        assert len(ours["masks"]) == len(rec["masks"]) == 19
        flips += sum(int((m.numpy() != np.moveaxis(j, -1, 1)).sum())
                     for m, j in zip(ours["masks"], rec["masks"]))
    # the port's f32 encoder on JAX's inputs, output gradients and masks
    replayed = encoder_grads(enc, theirs)
    compare_grad_trees({k: v.numpy() for k, v in replayed.items()},
                       {k: v.numpy() for k, v in jax_.items()})
    # the port's own step against the f64 replay of its own masks, and
    # what the flips alone move: the same in f64 with JAX's masks
    own = encoder_grads(enc, calls, f64=True)
    swapped = encoder_grads(enc, [dict(o, masks=j["masks"])
                                  for o, j in zip(calls, theirs)], f64=True)
    floor = 1e-6
    worst = {"own": 0.0, "jax": 0.0, "flips": 0.0, "replayed": 0.0}
    for k, want in jax_.items():
        got, w, nj = port[k].double(), own[k], want.double().norm().item()
        err = (got - w).norm().item()
        assert err <= WITNESS_TOL * w.norm().item() + floor, k
        moved = (own[k] - swapped[k]).norm().item()
        gap = (got - want.double()).norm().item()
        assert gap <= moved + GRAD_TOL * nj + floor, (k, gap, moved, nj)
        if nj > 1e-4:
            worst["own"] = max(worst["own"], err / w.norm().item())
            worst["jax"] = max(worst["jax"], gap / nj)
            worst["flips"] = max(worst["flips"], moved / nj)
            worst["replayed"] = max(worst["replayed"],
                                    rel(replayed[k], want))
    print(f"image encoder: output gradients {cot:.3g} from JAX's, {flips} "
          f"ReLU elements flipped between the packages; of a leaf's norm, "
          f"the port on JAX's masks "
          f"{worst['replayed']:.3g} from JAX, its step {worst['own']:.3g} "
          f"from its own masks' f64 and {worst['jax']:.3g} from JAX, the "
          f"flips alone {worst['flips']:.3g}")


@pytest.fixture(scope="module")
def fern(tmp_path_factory, weights):
    return build("fern", tmp_path_factory, weights)


def test_fern_split_equals_jax(fern):
    check_split(fern)


def test_fern_padded_refs_and_init_equal_jax(fern):
    check_init(fern)


def test_fern_step_matches_jax(fern):
    check_step(fern)


def test_chip_smoke_ft_scenes_are_the_shipped_configs():
    """chip_smoke.py phase 15 finetunes these three shipped configs, each
    on the scene its writer makes at the reader's real size, which its
    ``database_name`` reads (no cut of the database); and the cases here
    are the same configs and writers at test size."""
    expected = {"write_llff_colmap": "llff_colmap/{name}/high",
                "write_dtu_test": "dtu_test/{name}/black_{half}",
                "write_example": "example/{name}"}
    names = []
    for name, path, writer, kw in chip_smoke.FT_DB_SCENES:
        cfg = load_cfg(str(ROOT / path))
        assert callable(getattr(FAB, writer))
        db = expected[writer].format(name=kw["name"], half=kw.get("w", 0) // 2)
        assert cfg["database_name"] == db, (path, db)
        assert cfg["train_dataset_cfg"]["database_name"] == db
        assert cfg["validate_initialization"] is True
        case = CASES[name]
        assert (case.config, case.write[0]) == (
            path.removeprefix("configs/train/ft/"), writer)
        names.append(name)
    assert names == ["birds", "fern", "desktop"]
    assert set(chip_smoke.FT_DB_CUTS) == {"total_step", "val_interval",
                                          "train_log_step"}

