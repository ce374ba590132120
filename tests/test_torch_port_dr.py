"""The port's direct-rendering branch (``use_dr_prediction``:
``NeurayRenderer._direct_rendering``, the SH fit of ``ops/sh.py``)
against the JAX package's: the coarse and fine DR colours and hit
probabilities of the exact ray loop for both ``use_nr_color_for_dr``
values, the network colours unchanged by the branch, a focused-driver
frame that keeps ``pixel_colors_dr``, one training step with the DR
losses, and the bf16 route.

Scene: ``tests/test_torch_port_drivers.py``'s (the synthetic sphere, 3
views at 32x32, the full-image query, 8 + 8 samples, the trained
``tools/bench_weights.npz``); the port renders from the maps JAX encoded.
The training step is ``tests/test_torch_port_train.py``'s (3 views at
64x64, 32 rays through the sphere, JAX's fine draws handed to the port,
JAX's cross-view diff features too), with ``use_dr_loss`` and
``use_dr_fine_loss``.

Tolerances. DR hit probabilities and the NR colours: 1e-4. The SH colours
go through an f32 inverse of the normal equations, whose error is its
condition number times f32's epsilon (``tests/test_torch_port_sh.py``):
with 3 views a sample the 16x16 ``lhs`` has rank <= 3 and regularizers
down to 1e-3, and f32 rounding of the gathered colours and hit
probabilities (1e-7) moves a sample's SH colour by up to ~1e-3 in either
package; composited, the pixels differ by up to 2.35e-4 (mean up to
2.5e-5) here. So ``pixel_colors_dr`` with SH colours is held at 5e-4 in
max and 1e-4 in mean; with the network's colours
(``use_nr_color_for_dr``) at 1e-4. The DR losses' gradients: 2e-3 per leaf in relative norm. bf16:
the lossy-mode rule of ``tests/test_torch_port_bf16.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuray_tpu.models import init_net as jN
from neuray_tpu.models import renderer as jR
from neuray_tpu.ops import sampling as jS
from neuray_tpu.train import losses as jL

from neuray_tpu_torch.models import init_net as N
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.train import losses as L
from neuray_tpu_torch.utils.params import load_flax_params, torch_to_flax
from tests import test_torch_port_bf16 as B16
from tests import test_torch_port_train as TR
from tests.test_torch_port_drivers import (  # noqa: F401 (fixtures)
    H, TH, W, pairs, scene, t)

torch.set_num_threads(1)

DR_KEEP = ("pixel_colors_nr", "pixel_colors_nr_fine", "pixel_colors_dr",
           "pixel_colors_dr_fine", "hit_prob_dr", "hit_prob_dr_fine")


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def dr_close(key, ours, theirs, sh):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape, key
    assert np.isfinite(ours).all(), key
    err = np.abs(ours - theirs)
    print(f"{key}: max {err.max():.3g} mean {err.mean():.3g}")
    if sh and key.startswith("pixel_colors_dr"):
        assert err.max() <= 5e-4 and err.mean() <= 1e-4, (
            key, err.max(), err.mean())
    else:
        assert err.max() <= 1e-4, (key, err.max())


@pytest.mark.parametrize("nr_color", [False, True])
def test_dr_ray_loop_matches_jax(pairs, nr_color):
    """The exact coarse + fine loop with ``use_dr_prediction``: DR colours
    and hit probabilities against JAX, and the network colours bit-equal
    to the port's own pass without the branch."""
    p = pairs(use_dr_prediction=True, use_nr_color_for_dr=nr_color)
    theirs = p.jit(jR.make_ray_render_fn, keep=DR_KEEP)
    ours = p.port(R.render_rays, DR_KEEP)
    assert set(ours) == set(theirs) == set(DR_KEEP)
    for k in DR_KEEP:
        dr_close(k, ours[k].numpy(), theirs[k], not nr_color)
    plain = pairs().port(R.render_rays, DR_KEEP)
    assert set(plain) == {"pixel_colors_nr", "pixel_colors_nr_fine"}
    for k, v in plain.items():
        assert torch.equal(ours[k], v), k
    assert (ours["pixel_colors_dr"] != ours["pixel_colors_nr"]).any()


def test_dr_outputs_need_the_branch(pairs):
    """Without ``use_dr_prediction`` no DR key appears, and the default
    keep keys carry the DR colours where the branch is on."""
    assert {"pixel_colors_dr", "pixel_colors_dr_fine"} <= set(R.DEFAULT_KEEP)
    p = pairs(use_dr_prediction=True)
    que = dict(p.que, coords=p.que["coords"][:, 500:564])
    with torch.no_grad():
        out = p.r.render_chunk(p.ref_c, que)
        plain = pairs().r.render_chunk(pairs().ref_c, que)
    dr = {"pixel_colors_dr", "hit_prob_dr"}
    assert dr | {k + "_fine" for k in dr} <= set(out)
    assert not {k for k in plain if "_dr" in k}
    assert set(out) - set(plain) == dr | {k + "_fine" for k in dr}


def test_dr_focused_frame_matches_jax(pairs):
    """``render_frame_probe_focus`` with ``pixel_colors_dr`` in its keep
    keys (as the render CLI keeps it under ``use_dr_prediction``), on
    JAX's focus probe."""
    p = pairs(use_dr_prediction=True)
    jprobe = p.jit(jR.make_focus_probe_fn)
    kw = dict(threshold=TH, keep_base=("pixel_colors_nr", "pixel_colors_dr"),
              image_hw=(H, W), dilate=1)
    ours = p.port(R.render_frame_probe_focus,
                  probe_out=tuple(t(x) for x in jprobe), **kw)
    theirs = p.jax(jR.render_frame_probe_focus, probe_out=jprobe, **kw)
    assert ours["kept_rays"] == theirs["kept_rays"] > 0
    np.testing.assert_array_equal(ours["keep_mask"], theirs["keep_mask"])
    for k in ("pixel_colors_nr", "pixel_colors_nr_fine", "pixel_colors_dr",
              "pixel_colors_dr_fine"):
        dr_close(k, ours[k], theirs[k], True)
        assert (ours[k][0, ~ours["keep_mask"]] == 0).all(), k


# ---------------- one training step with the DR losses ----------------

DR_TRAIN_CFG = {**TR.CFG, "use_dr_prediction": True, "use_dr_loss": True,
                "use_dr_fine_loss": True}


@pytest.fixture(scope="module")
def dr_step():
    """JAX's jitted value_and_grad of the loss with the DR terms, and the
    port's on the same weights, sample, fine draws and diff features."""
    captured = []
    orig = jS.sample_fine_depth

    def capture(depth, hit_prob, dr, fdn, random_sample, rng=None,
                inv_mode=True):
        if random_sample:
            captured.append(jax.random.uniform(
                rng, (*hit_prob.shape[:-1], fdn)))
        return orig(depth, hit_prob, dr, fdn, random_sample, rng, inv_mode)

    renderer = jR.NeurayRenderer(jR.RenderConfig.from_cfg(DR_TRAIN_CFG))
    loss_fn = jL.build_losses(DR_TRAIN_CFG)

    def total(params, batch, rng):
        captured.clear()
        out = renderer.apply(params, batch["ref"], batch["que"], True,
                             batch["depth_loss_coords"],
                             rngs={"sample": rng})
        losses = loss_fn(out, batch)
        tot = sum(jnp.mean(v) for k, v in losses.items()
                  if k.startswith("loss"))
        return tot, (losses, out, captured[-1])

    weights = TR.load_params_npz(str(TR.ROOT / "tools" / "bench_weights.npz"))
    sample = TR.sphere_sample()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jS, "sample_fine_depth", capture)
        step = jax.jit(jax.value_and_grad(total, has_aux=True))
        (tot, (losses, out, u)), grads = step(
            weights, TR.jax_batch(sample), jax.random.PRNGKey(0))
    ref = TR.jax_batch(sample)["ref"]
    diff = t(jax.jit(jN.get_diff_feats)(
        ref["imgs"], jN.extract_depth_for_init(ref["depth_range"],
                                               ref["depth"]),
        ref["depth_range"], ref["poses"], ref["Ks"]))
    with pytest.MonkeyPatch.context() as mp:
        TR.with_u(mp, np.asarray(u))
        mp.setattr(N, "get_diff_feats", lambda *args: diff)
        r = R.NeurayRenderer(R.RenderConfig.from_cfg(DR_TRAIN_CFG))
        load_flax_params(r, weights)
        r.train()
        batch = TR.tree_t(sample)
        p_out = r(batch["ref"], batch["que"], True,
                  batch["depth_loss_coords"])
        p_losses = L.build_losses(DR_TRAIN_CFG)(p_out, batch)
        p_tot = sum(v.mean() for k, v in p_losses.items()
                    if k.startswith("loss"))
        p_tot.backward()
    p_grads = torch_to_flax(r, {n: q.grad for n, q in r.named_parameters()})
    return {"jax": (float(tot), losses, out, grads),
            "port": (p_tot.item(), p_losses, p_out, p_grads)}


def test_dr_training_forward_and_losses_match_jax(dr_step):
    _, losses_j, out_j, _ = dr_step["jax"]
    _, losses_p, out_p, _ = dr_step["port"]
    assert set(out_p) == set(out_j)
    for k in ("pixel_colors_dr", "pixel_colors_dr_fine", "hit_prob_dr",
              "hit_prob_dr_fine", "pixel_colors_nr", "pixel_colors_nr_fine"):
        dr_close(k, out_p[k].detach().numpy(), out_j[k], True)
    assert {"loss_rgb_dr", "loss_rgb_dr_fine"} <= set(losses_p)
    assert set(losses_p) == set(losses_j)
    for k, v in losses_j.items():
        np.testing.assert_allclose(losses_p[k].detach().numpy(),
                                   np.asarray(v), rtol=0, atol=1e-4,
                                   err_msg=k)


def test_dr_training_gradients_match_jax(dr_step):
    """Every leaf within 2e-3 of its norm; the DR losses reach the dist
    decoders and the encoders (the SH fit's weights are the views' hit
    probabilities)."""
    grads_j, grads_p = dr_step["jax"][3], dr_step["port"][3]
    assert TR.compare_grad_trees(grads_p, grads_j) == 294


# ---------------- the bf16 route ----------------

@pytest.fixture(scope="module")
def bf16_sides(scene):
    ref, que, params = scene
    return {(pkg, bf16): B16.Side(pkg, params, (ref, que),
                                  use_dr_prediction=True, use_bf16=bf16)
            for pkg, bf16 in (("jax", False), ("jax", True), ("port", True))}


def test_dr_bf16_route_is_held_by_the_lossy_rule(bf16_sides):
    """``use_bf16``: the gathered colours are bf16, the views' hit
    probabilities f32 after the mask (as in JAX, where bf16 times the f32
    mask promotes), and the SH fit runs in f32 in both packages; the DR
    colours are held by the lossy-mode rule."""
    keep = DR_KEEP[:4]
    out = {k: s.rays(jR.make_ray_render_fn, R.render_rays, keep=keep)
           for k, s in bf16_sides.items()}
    for k in keep:
        B16.held(f"bf16 dr {k}", out["port", True][k], out["jax", True][k],
                 out["jax", False][k])
