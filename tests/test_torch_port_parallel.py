"""The port's ray-sharded rendering and the losses' group on 2 and 3 ranks
on the CPU (gloo; ``parallel/spawn.py: run_ranks`` with a ``file://``
rendezvous under the test's tmp dir), against the JAX package's sharded
counterparts on 2 devices of the 8-device virtual CPU mesh and against
the port's one process.

Renders: ``tests/test_torch_port_render.py``'s scene (3 views at 32x32,
1023 query rays, not a multiple of 2 ranks x 64-ray chunks) through
``make_sharded_render_fn``; the drivers as
``tests/test_torch_port_drivers.py`` holds them (the port on the maps JAX
encoded, JAX's own probe handed to both where the keep set must be the
same, windows compared off the borderline rays), each with ``mesh``.
JAX runs at "highest" matmul precision. Colours 1e-4, depths 1e-3, keep
sets identical, every rank's result identical. The losses: a small
model's outputs, the batch sharded over the ranks with 0-weight padding,
each loss value and the averaged gradient against one process at 1e-6.
The ranks import no JAX (``tests/torch_port_ranks.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuray_tpu.data.synthetic import make_query, make_sphere_scene
from neuray_tpu.models import renderer as jR
from neuray_tpu.parallel import sharding as jP

from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.parallel import sharding as P
from neuray_tpu_torch.parallel.spawn import run_ranks
from neuray_tpu_torch.utils.params import load_flax_params, load_params_npz
from tests import torch_port_ranks as ranks
from tests.test_torch_port_drivers import (
    AUTO_CASES, CFG as DRIVER_CFG, H, KEEP_BASE, TH, W, Pair,
    _window_borderline, assert_frames_match)
from tests.test_torch_port_render import CFG as RENDER_CFG, N_RAYS, WEIGHTS

torch.set_num_threads(1)

RANKS = 2
KEEP = ("pixel_colors_nr", "pixel_colors_nr_fine", "ray_mask")
DRIVER_KW = dict(threshold=TH, keep_base=KEEP_BASE, image_hw=(H, W),
                 dilate=1)
AUTO_KW = dict(threshold=TH, keep_base=KEEP_BASE,
               **AUTO_CASES["focus_strided_accept"])


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def spawn(fn, size, work, inputs, timeout=240):
    """``fn`` on ``size`` ranks over ``work/inputs.pt``; every rank's
    output, in rank order."""
    work.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, work / "inputs.pt")
    run_ranks(fn, size, (str(work),), timeout=timeout,
              init_method=f"file://{work}/rendezvous", device="cpu")
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(size)]


def same(a, b, where="") -> None:
    """a and b equal, bit for bit, through nested dicts and sequences."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)


def same_on_every_rank(outs):
    for other in outs[1:]:
        same(outs[0], other)


# ---------------- rendering ----------------

@pytest.fixture(scope="module")
def scenes():
    rng = np.random.RandomState(0)
    ref = make_sphere_scene(rng, 3, 32, 32)
    que = make_query(rng, 32, 32, 0, full_image=True)
    que = {k: v for k, v in que.items() if k != "imgs"}
    que["coords"] = que["coords"][:, :N_RAYS]
    params = load_params_npz(str(WEIGHTS))
    rng = np.random.RandomState(7)
    dref = make_sphere_scene(rng, 3, H, W)
    dque = make_query(rng, H, W, 0, full_image=True)
    del dque["imgs"]
    return (ref, que), Pair((dref, dque, params)), params, dref


@pytest.fixture(scope="module")
def port_ranks(scenes, tmp_path_factory):
    """Every rank's render_and_drivers output."""
    (ref, que), p, params, dref = scenes
    jprobe = p.jit(jR.make_probe_fn)
    jfocus = p.jit(jR.make_focus_probe_fn)
    jr = jR.NeurayRenderer(jR.RenderConfig(**RENDER_CFG))
    enc = jR.make_scene_encode_fn(jr)(
        params, {k: jnp.asarray(v) for k, v in ref.items()})
    inputs = {
        "weights": str(WEIGHTS), "render_cfg": RENDER_CFG, "keep": KEEP,
        "ref": ref, "que": que, "driver_cfg": DRIVER_CFG,
        "jax_maps": {k: np.asarray(enc[k], np.float32)
                     for k in ("img_feats", "ray_feats")},
        "driver_ref": {**dref, **{k: np.asarray(p.jref_c[k], np.float32)
                                  for k in ("img_feats", "ray_feats")}},
        "driver_que": {k: v.numpy() for k, v in p.que.items()},
        "jax_probe": np.asarray(jprobe),
        "jax_focus_probe": tuple(np.asarray(x) for x in jfocus),
        "driver_kw": DRIVER_KW, "auto_kw": AUTO_KW}
    outs = spawn(ranks.render_and_drivers, RANKS,
                 tmp_path_factory.mktemp("render"), inputs)
    return outs, jprobe, jfocus


def test_ranks_hold_the_same_results(port_ranks):
    same_on_every_rank(port_ranks[0])


def test_sharded_render_matches_jax_and_one_process(scenes, port_ranks):
    """1023 rays over 2 ranks of 64-ray chunks: the port's sharded render
    against JAX's ``make_sharded_render_fn`` on 2 devices, on the maps
    JAX encoded (``pre_encoded``) at 1e-4 and end to end (each rank
    encodes) at ``tests/test_torch_port_render.py``'s end-to-end bound,
    3e-4 (the 2x2 InstanceNorm of its 32x32 image encoder amplifies f32
    rounding); and end to end against the port's one-process
    ``render_full`` at 1e-5."""
    (ref, que), _, params, _ = scenes
    ours, on_maps = (port_ranks[0][0][k] for k in ("full", "on_jax_maps"))
    jr = jR.NeurayRenderer(jR.RenderConfig(**RENDER_CFG))
    theirs = jP.make_sharded_render_fn(jr, jP.make_mesh(RANKS), KEEP)(
        params, {k: jnp.asarray(v) for k, v in ref.items()},
        {k: jnp.asarray(v) for k, v in que.items()})
    r = R.NeurayRenderer(R.RenderConfig(**RENDER_CFG))
    load_flax_params(r, params)
    one = R.render_full(r.eval(), {k: torch.from_numpy(v) for k, v in
                                   ref.items()},
                        {k: torch.from_numpy(v) for k, v in que.items()},
                        KEEP)
    assert set(ours) == set(on_maps) == set(KEEP)
    for k in KEEP:
        assert ours[k].shape[:2] == on_maps[k].shape[:2] == (1, N_RAYS), k
        if k == "ray_mask":
            for x in (ours, on_maps, one):
                np.testing.assert_array_equal(x[k].numpy(),
                                              np.asarray(theirs[k]))
            continue
        np.testing.assert_allclose(on_maps[k].numpy(), np.asarray(theirs[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=0, atol=3e-4, err_msg=k)
        np.testing.assert_allclose(ours[k].numpy(), one[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_sharded_probes_match_jax(scenes, port_ranks):
    _, p, _, _ = scenes
    outs, jprobe, jfocus = port_ranks
    np.testing.assert_allclose(outs[0]["probe"].numpy(), np.asarray(jprobe),
                               rtol=0, atol=1e-4)
    score, near, far = outs[0]["focus_probe"]
    np.testing.assert_allclose(score.numpy(), np.asarray(jfocus[0]), rtol=0,
                               atol=1e-4)
    same = ~_window_borderline(p)
    for ours, theirs in ((near, jfocus[1]), (far, jfocus[2])):
        np.testing.assert_allclose(ours[0].numpy()[same],
                                   np.asarray(theirs)[0][same], rtol=1e-6)


@pytest.mark.parametrize("driver", ["probe_focus", "probe_skip",
                                    "skip_empty", "auto"])
def test_drivers_with_a_mesh_match_jax(scenes, port_ranks, driver):
    """Each driver with ``mesh``: the JAX package's with its 2-device mesh
    gives the same keep set and outputs; the port's one-process driver
    the same to 1e-6."""
    _, p, _, _ = scenes
    outs, jprobe, jfocus = port_ranks
    ours = outs[0][driver]
    jmesh = jP.make_mesh(RANKS)
    if driver == "auto":
        theirs = p.jax(jR.render_frame_probe_auto, mesh=jmesh, **AUTO_KW)
        one = p.port(R.render_frame_probe_auto, **AUTO_KW)
        for k in ("fallback", "probe_sample_num", "false_skip_rate"):
            assert ours[k] == theirs[k] == one[k], k
    elif driver == "skip_empty":
        kw = dict(threshold=TH, keep_base=KEEP_BASE)
        theirs = p.jax(jR.render_frame_skip_empty, mesh=jmesh, **kw)
        one = p.port(R.render_frame_skip_empty, **kw)
    elif driver == "probe_focus":
        theirs = p.jax(jR.render_frame_probe_focus, probe_out=jfocus,
                       mesh=jmesh, **DRIVER_KW)
        one = p.port(R.render_frame_probe_focus, probe_out=tuple(
            torch.from_numpy(np.asarray(x)) for x in jfocus), **DRIVER_KW)
    else:
        theirs = p.jax(jR.render_frame_probe_skip, probe_out=jprobe,
                       mesh=jmesh, **DRIVER_KW)
        one = p.port(R.render_frame_probe_skip, probe_out=torch.from_numpy(
            np.asarray(jprobe)), **DRIVER_KW)
    assert_frames_match(ours, theirs, skipped_zero=driver != "skip_empty")
    np.testing.assert_array_equal(ours["keep_mask"], one["keep_mask"])
    for k in (k + s for k in KEEP_BASE for s in ("", "_fine")):
        np.testing.assert_allclose(ours[k], one[k], rtol=0, atol=1e-6,
                                   err_msg=k)


# ---------------- sharding helpers ----------------

def test_one_process_mesh_is_the_unsharded_path(scenes):
    """A mesh of one rank (make_mesh without a world) joins no process
    group, and the ray loops with it are the plain chunk loops."""
    _, p, _, _ = scenes
    mesh = P.make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, None)
    assert not torch.distributed.is_initialized()
    a = R.probe_rays(p.r, p.ref_c, p.que, mesh)
    np.testing.assert_array_equal(a.numpy(),
                                  R.probe_rays(p.r, p.ref_c, p.que).numpy())


def test_make_mesh_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.make_mesh()


def test_pad_rays_repeats_the_last_ray():
    x = torch.arange(10.0).reshape(1, 5, 2)
    padded = P._pad_rays(x, 8)
    assert padded.shape == (1, 8, 2)
    assert (padded[0, 5:] == x[0, -1]).all()
    assert P._pad_rays(x, 5) is x


@pytest.mark.parametrize("size,rn,chunk", [(2, 1023, 64), (3, 10, 1),
                                           (2, 12, 1)])
def test_rank_parts_cover_the_rays_in_whole_chunks(size, rn, chunk):
    """The ranks' parts, in rank order, are the rays and then copies of the
    last one; each part a whole number of chunks, no rank a chunk more
    than it needs."""
    x = torch.arange(float(rn)).reshape(1, rn, 1)
    meshes = [P.Mesh(r, size, torch.device("cpu")) for r in range(size)]
    spans = [P.rank_span(rn, m, chunk) for m in meshes]
    parts = torch.cat([P.rank_part(x, m, chunk) for m in meshes], 1)
    per = spans[0][1]
    assert spans == [(r * per, per) for r in range(size)]
    assert per % chunk == 0 and per * size - rn < size * chunk
    assert parts[0, :rn, 0].tolist() == list(range(rn))
    assert (parts[0, rn:] == rn - 1).all()


def test_averaging_refuses_a_loss_it_was_not_told_of():
    """A loss value outside the configured names would be dropped from the
    reduction: it raises, before any collective."""
    w = torch.ones(2, requires_grad=True)
    w.grad = torch.ones(2)
    with pytest.raises(ValueError, match="loss_x"):
        P.average_gradients([w], P.Mesh(0, 2, torch.device("cpu")),
                            {"loss_x": torch.tensor(1.0)}, ("loss_a",))


# ---------------- losses with a group ----------------

LOSS_CFGS = [{"loss": ["render", "consist"], "use_ray_mask": True},
             {"loss": ["render", "consist"], "use_ray_mask": False}]


@pytest.mark.parametrize("size,rn", [(2, 12), (3, 10)])
def test_losses_with_a_group_equal_one_process(tmp_path, size, rn):
    """The render and consistency losses of a batch sharded over ``size``
    ranks (10 rays over 3: 2 pad rays of weight 0) hold the one-process
    values, and the gradient through the sums over the ranks, averaged,
    is the one-process full-batch gradient."""
    rng = np.random.RandomState(size)
    inp = {"cfgs": LOSS_CFGS,
           "x": torch.from_numpy(rng.randn(1, rn, 5).astype(np.float32)),
           "gt": torch.from_numpy(rng.rand(1, rn, 3).astype(np.float32)),
           "mask": torch.from_numpy(rng.rand(1, rn) > 0.3),
           "w1": torch.from_numpy(rng.randn(5, 3).astype(np.float32)),
           "w2": torch.from_numpy(rng.randn(5, 8).astype(np.float32))}
    outs = spawn(ranks.losses_rank, size, tmp_path, inp)
    same_on_every_rank(outs)
    one = ranks.loss_values_and_grads(inp)
    for ours, theirs in zip(outs[0], one):
        assert set(ours["values"]) == set(theirs["values"]) == {
            "loss_rgb_nr", "loss_prob", "loss_total"}
        for k, v in theirs["values"].items():
            assert ours["values"][k] == pytest.approx(v, rel=0, abs=1e-6), k
        for k in ("w1", "w2"):
            np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
            assert theirs[k].abs().max() > 1e-3


def test_ranks_with_different_losses_average_by_name(tmp_path):
    """A loss only some ranks hold is averaged over those, one no rank
    holds is left out; the gradients over every rank (the ranks' totals
    averaged)."""
    outs = spawn(ranks.uneven_losses_rank, 2, tmp_path, {})
    same_on_every_rank(outs)
    assert outs[0]["values"] == {"loss_a": 4.5, "loss_b": 5.0,
                                 "loss_total": 7.0}
    assert outs[0]["grad"].tolist() == [2.5, 3.5]


def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="ranks failed"):
        spawn(ranks.losses_rank, 2, tmp_path, {"cfgs": "not a config"})


def test_a_hung_rank_is_killed(tmp_path):
    """Rank 1 never reaches the collective rank 0 waits in: the run ends
    at its timeout with both ranks killed."""
    with pytest.raises(TimeoutError, match="killed"):
        spawn(ranks.hang_rank, 2, tmp_path, {}, timeout=10)
