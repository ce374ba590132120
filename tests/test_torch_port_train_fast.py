"""The shipped fast training config, ``configs/train/gen/
neuray_gen_depth_train_fast.yaml`` (``init_net_cfg.diff_scale: 2``: the
depth init net's cross-view diff features on the half pixel grid,
upsampled back), through the port's training forward and gradients
against the JAX package's, by ``tests/test_torch_port_train.py``'s rule
and on its inputs: 3 views at 64x64 (a 32x32 half grid), 32 query rays
through the sphere, 8 + 8 samples, the trained ``tools/bench_weights.npz``,
JAX's fine draws handed to the port; outputs 1e-4, losses 1e-4,
gradients 2e-3 per leaf in relative norm.

The half-grid diff features are a function of the data alone (JAX
stop-gradients them; the port's gather takes no gradient there, its
inputs being data). As for the full grid, the gradient check hands the
port JAX's half-grid features (``get_diff_feats`` on the subgrid), which
the port then upsamples itself: the init net's gradients amplify f32
rounding of those features (``test_init_net_gradients_amplify_the_diff_
feature_rounding``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuray_tpu.models import init_net as jN
from neuray_tpu.models import renderer as jR
from neuray_tpu.ops import sampling as jS
from neuray_tpu.train import losses as jL
from neuray_tpu.utils.config import load_cfg

from neuray_tpu_torch.models import init_net as N
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.train import losses as L
from neuray_tpu_torch.utils.params import load_flax_params, torch_to_flax
from tests import test_torch_port_train as TR

torch.set_num_threads(1)

PATH = TR.ROOT / "configs" / "train" / "gen" / "neuray_gen_depth_train_fast.yaml"
FAST = {**TR.CFG, "init_net_cfg": {"diff_scale": 2}}


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def test_shipped_fast_config_builds_the_same_renderer():
    """``RenderConfig.from_cfg`` of the shipped file equals JAX's, with
    the half-grid diff; the test's config differs from it only in the
    test's cuts."""
    cfg = load_cfg(str(PATH))
    ours, theirs = R.RenderConfig.from_cfg(cfg), jR.RenderConfig.from_cfg(cfg)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.init_diff_scale == 2 and ours.use_depth_loss
    test = R.RenderConfig.from_cfg(FAST)
    assert dataclasses.replace(
        ours, depth_sample_num=8, fine_depth_sample_num=8, ray_batch_num=32,
        ray_mask_point_num=4) == test
    assert R.NeurayRenderer(ours).init_net.diff_scale == 2


@pytest.fixture(scope="module")
def fast_step():
    """JAX's jitted value_and_grad of the trainer's loss with
    ``diff_scale`` 2, and the port's, run twice: with its own half-grid
    diff features (forward) and with JAX's (gradients)."""
    captured = []
    orig = jS.sample_fine_depth

    def capture(depth, hit_prob, dr, fdn, random_sample, rng=None,
                inv_mode=True):
        if random_sample:
            captured.append(jax.random.uniform(
                rng, (*hit_prob.shape[:-1], fdn)))
        return orig(depth, hit_prob, dr, fdn, random_sample, rng, inv_mode)

    renderer = jR.NeurayRenderer(jR.RenderConfig.from_cfg(FAST))
    loss_fn = jL.build_losses(FAST)

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
        (tot, (losses, out, u)), grads = jax.jit(jax.value_and_grad(
            total, has_aux=True))(weights, TR.jax_batch(sample),
                                  jax.random.PRNGKey(0))
    ref = TR.jax_batch(sample)["ref"]
    s = 2
    Ks_s = ref["Ks"] * jnp.asarray([1.0 / s, 1.0 / s, 1.0])[None, :, None]
    depth_n = jN.extract_depth_for_init(ref["depth_range"], ref["depth"])
    half = TR.t(jax.jit(jN.get_diff_feats)(
        ref["imgs"][:, ::s, ::s], depth_n[:, ::s, ::s], ref["depth_range"],
        ref["poses"], Ks_s))
    runs, seen = [], []
    for jax_half in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            TR.with_u(mp, np.asarray(u))
            diff = N.get_diff_feats

            def spy(imgs, *args):
                out = half if jax_half else diff(imgs, *args)
                seen.append((tuple(imgs.shape), out.requires_grad))
                return out

            mp.setattr(N, "get_diff_feats", spy)
            r = R.NeurayRenderer(R.RenderConfig.from_cfg(FAST))
            load_flax_params(r, weights)
            r.train()
            batch = TR.tree_t(sample)
            p_out = r(batch["ref"], batch["que"], True,
                      batch["depth_loss_coords"])
            p_losses = L.build_losses(FAST)(p_out, batch)
            p_tot = sum(v.mean() for k, v in p_losses.items()
                        if k.startswith("loss"))
            p_tot.backward()
        runs.append((p_tot.item(), p_losses, p_out, torch_to_flax(
            r, {n: q.grad for n, q in r.named_parameters()})))
    return {"jax": (float(tot), losses, out, grads), "port": runs[0],
            "port_jax_half": runs[1], "seen": seen}


def test_the_diff_gather_runs_on_the_half_grid_without_gradient(fast_step):
    assert fast_step["seen"] == [((3, 32, 32, 3), False)] * 2


@pytest.mark.parametrize("key", TR.OUT_KEYS)
def test_fast_training_forward_matches_jax(fast_step, key):
    theirs, ours = fast_step["jax"][2], fast_step["port"][2]
    np.testing.assert_allclose(ours[key].detach().numpy(),
                               np.asarray(theirs[key]), rtol=0, atol=1e-4)


def test_fast_training_losses_match_jax(fast_step):
    tot_j, losses_j, out_j, _ = fast_step["jax"]
    tot_p, losses_p, out_p, _ = fast_step["port"]
    assert set(out_p) == set(out_j) and set(losses_p) == set(losses_j)
    for k in ("ray_mask", "ray_mask_fine"):
        np.testing.assert_array_equal(out_p[k].numpy(), np.asarray(out_j[k]))
    for k, v in losses_j.items():
        np.testing.assert_allclose(losses_p[k].detach().numpy(),
                                   np.asarray(v), rtol=0, atol=1e-4,
                                   err_msg=k)
    assert tot_p == pytest.approx(tot_j, abs=1e-4)


def test_fast_training_gradients_match_jax(fast_step):
    grads_j, grads_p = fast_step["jax"][3], fast_step["port_jax_half"][3]
    assert TR.compare_grad_trees(grads_p, grads_j) == 294
