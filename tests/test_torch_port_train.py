"""The port's training slice against the JAX package's: the fine
sampler's training draws, the training forward, the losses, the full
gradient, a 5-step Adam trajectory, the synthetic training data, the
validation metrics, the learning-rate schedules, the weight bridge back
to flax, ``RenderConfig.from_cfg`` over the shipped configs and the
port's imports.

Shapes: 3 reference views at 64x64, 32 query rays, 8 coarse + 8 fine
samples, 8 depth-loss pixels a view (``CFG``, ``DATA``). The JAX side
runs at "highest" matmul precision (its default f32 matmul is bf16-grade
even on the CPU) through one jitted ``jax.value_and_grad`` of the JAX
trainer's loss (``neuray_tpu/parallel/sharding.py:438-446``). torch and
JAX draw different random numbers, so the port is handed JAX's own fine
draws ``u``: the test wraps ``neuray_tpu.ops.sampling.sample_fine_depth``
to capture them and ``NeurayRenderer.draw_fine_u`` to return them.

Forward and gradients are compared on the trained
``tools/bench_weights.npz`` and on query rays through the sphere: on
nearly empty rays the fine sampler divides by a coarse hit mass near 0,
and a rounding difference moves the fine depths (ROADMAP Queue 3, fault
3). Tolerances: outputs 1e-4, loss values 1e-5, gradients 2e-3 per leaf
in relative norm (``tests/test_backward_parity.py``'s bars).
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuray_tpu.data import train_dataset as jD
from neuray_tpu.models import init_net as jN
from neuray_tpu.models import renderer as jR
from neuray_tpu.ops import sampling as jS
from neuray_tpu.train import losses as jL
from neuray_tpu.train import lr as jLR
from neuray_tpu.train import metrics as jM
from neuray_tpu.utils.config import load_cfg

import chip_smoke
from neuray_tpu_torch.data import train_dataset as D
from neuray_tpu_torch.models import init_net as N
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.ops import sampling as S
from neuray_tpu_torch.train import losses as L
from neuray_tpu_torch.train import lr as LR
from neuray_tpu_torch.train import metrics as M
from neuray_tpu_torch.train.trainer import Trainer
from neuray_tpu_torch.utils.params import (
    load_flax_params, load_params_npz, torch_to_flax)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(use_hierarchical_sampling=True, depth_sample_num=8,
           fine_depth_sample_num=8, ray_batch_num=32, ray_mask_point_num=4,
           use_depth_loss=True, dist_decoder_cfg={"use_vis": False},
           fine_dist_decoder_cfg={"use_vis": False}, loss=["render", "depth"],
           use_nr_fine_loss=True, lr_type="exp_decay",
           lr_cfg={"lr_init": 1e-4, "decay_step": 100000, "decay_rate": 0.5})
DATA = {"rfn": 3, "h": 64, "w": 64, "train_ray_num": 32,
        "depth_loss_coords_num": 8}


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def t(x):
    return torch.from_numpy(np.array(x))


def tree_t(tree):
    return {k: tree_t(v) if isinstance(v, dict) else t(v)
            for k, v in tree.items()}


def sphere_sample(index=0):
    """Training sample ``index`` of the synthetic set with its 32 query
    rays moved onto pixels where the query view sees the sphere."""
    s = jD.SyntheticRendererDataset(DATA, True)[index]
    del s["scene_name"]
    rng = np.random.RandomState(index)
    ys, xs = np.nonzero(s["que"]["imgs"][0].sum(-1) > 0)
    pick = rng.choice(ys.size, DATA["train_ray_num"], replace=False)
    s["que"]["coords"] = np.stack([xs[pick], ys[pick]], -1)[None].astype(
        np.float32)
    return s


@pytest.fixture(scope="module")
def jax_step():
    """JAX's jitted value_and_grad of the trainer's loss: (params, batch,
    rng) -> ((total, (losses, outputs, u)), grads), u the fine sampler's
    draws, captured from inside the forward."""
    captured = []
    orig = jS.sample_fine_depth

    def capture(depth, hit_prob, dr, fdn, random_sample, rng=None,
                inv_mode=True):
        if random_sample:
            captured.append(jax.random.uniform(
                rng, (*hit_prob.shape[:-1], fdn)))
        return orig(depth, hit_prob, dr, fdn, random_sample, rng, inv_mode)

    renderer = jR.NeurayRenderer(jR.RenderConfig.from_cfg(CFG))
    loss_fn = jL.build_losses(CFG)

    def total(params, batch, rng):
        captured.clear()
        out = renderer.apply(params, batch["ref"], batch["que"], True,
                             batch["depth_loss_coords"],
                             rngs={"sample": rng})
        losses = loss_fn(out, batch)
        tot = sum(jnp.mean(v) for k, v in losses.items()
                  if k.startswith("loss"))
        return tot, (losses, out, captured[-1])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jS, "sample_fine_depth", capture)
        yield renderer, jax.jit(jax.value_and_grad(total, has_aux=True))


@pytest.fixture(scope="module")
def weights():
    return load_params_npz(str(ROOT / "tools" / "bench_weights.npz"))


def jax_batch(sample):
    return jax.tree.map(jnp.asarray, sample)


def port_renderer(params):
    r = R.NeurayRenderer(R.RenderConfig.from_cfg(CFG))
    load_flax_params(r, params)
    return r.train()


def with_u(monkeypatch, u):
    """The port's fine draws replaced by JAX's u (one array, or one per
    call in order)."""
    draws = iter(u) if isinstance(u, list) else iter([u] * 1000)
    monkeypatch.setattr(R.NeurayRenderer, "draw_fine_u", staticmethod(
        lambda shape, device, generator: t(next(draws))))


def port_loss(renderer, batch):
    out = renderer(batch["ref"], batch["que"], True,
                   batch["depth_loss_coords"])
    losses = L.build_losses(CFG)(out, batch)
    total = sum(v.mean() for k, v in losses.items() if k.startswith("loss"))
    return total, losses, out


# ---------------- the fine sampler's training draws ----------------

def test_sample_fine_depth_with_jax_u():
    rng = np.random.RandomState(3)
    qn, rn, dn, fdn = 1, 9, 16, 24
    depth_range = np.array([[1.5, 6.0]], np.float32)
    depth = np.asarray(jS.sample_depth(jnp.asarray(depth_range), qn, rn, dn,
                                       False)[0])
    hit_prob = rng.rand(qn, rn, dn).astype(np.float32) ** 4
    hit_prob[0, 0] = 0.0                          # flat pdf row
    hit_prob[0, 1, :] = 0.0
    hit_prob[0, 1, 5] = 1.0                       # a spike
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, (qn, rn, fdn)))
    theirs = jS.sample_fine_depth(depth, hit_prob, depth_range, fdn, True,
                                  key)
    ours = S.sample_fine_depth(t(depth), t(hit_prob), t(depth_range), fdn,
                               u=t(u))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5,
                               atol=1e-5)
    assert not (np.diff(ours.numpy(), axis=-1) >= 0).all()   # unsorted


def test_training_fine_depths_are_the_sorted_draws(monkeypatch, weights):
    """In training the fine sampler reads the CDF at the drawn u and the
    fine pass renders the sorted result; the coarse depths are not
    jittered."""
    s = tree_t(sphere_sample())
    u = np.random.RandomState(0).rand(1, 32, 8).astype(np.float32)
    with_u(monkeypatch, u)
    calls, rendered = [], []
    sample = S.sample_fine_depth

    def spy_sampler(*args):
        calls.append((args, sample(*args)))
        return calls[-1][1]

    monkeypatch.setattr(S, "sample_fine_depth", spy_sampler)
    r = port_renderer(weights)
    render = r._render_by_depth

    def spy_render(depth, *args):
        rendered.append(depth)
        return render(depth, *args)

    monkeypatch.setattr(r, "_render_by_depth", spy_render)
    with torch.no_grad():
        r(s["ref"], s["que"], True)
    (args, drawn), = calls
    assert torch.equal(args[4], t(u))
    coarse, _ = S.sample_depth(s["que"]["depth_range"], 1, 32, 8)
    assert torch.equal(rendered[0], coarse)
    assert torch.equal(rendered[1], drawn.sort(dim=-1).values)
    assert not torch.equal(rendered[1], drawn)


# ---------------- the training forward, losses and gradients ----------------

@pytest.fixture(scope="module")
def matched(jax_step, weights):
    """JAX's loss, outputs, u and gradients on the trained weights and a
    sphere sample; the port's on the same inputs and u, run twice: with
    its own cross-view diff features (the forward and the losses), and
    with JAX's (the gradients). The diff features are a pure function of
    the data (stop-gradiented in JAX) that the two packages round apart
    by up to 6.3e-6; on this scene the depth init net's gradients move
    by up to 4.4e-3 with them (the port alone:
    ``test_init_net_gradients_amplify_the_diff_feature_rounding``), so
    the gradients are compared on the same features."""
    renderer, step = jax_step
    sample = sphere_sample()
    (tot, (losses, out, u)), grads = step(weights, jax_batch(sample),
                                          jax.random.PRNGKey(0))
    ref = jax_batch(sample)["ref"]
    depth_n = jN.extract_depth_for_init(ref["depth_range"], ref["depth"])
    diff = t(jax.jit(jN.get_diff_feats)(ref["imgs"], depth_n,
                                        ref["depth_range"], ref["poses"],
                                        ref["Ks"]))
    runs = []
    for jax_diff in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            with_u(mp, np.asarray(u))
            if jax_diff:
                mp.setattr(N, "get_diff_feats", lambda *args: diff)
            r = port_renderer(weights)
            total, p_losses, p_out = port_loss(r, tree_t(sample))
            total.backward()
        runs.append((total.item(), p_losses, p_out, torch_to_flax(
            r, {n: p.grad for n, p in r.named_parameters()})))
    return {"jax": (float(tot), losses, out, grads), "port": runs[0],
            "port_jax_diff": runs[1], "jax_diff": diff}


OUT_KEYS = ["pixel_colors_nr", "pixel_colors_nr_fine", "hit_prob_nr",
            "hit_prob_nr_fine", "colors_nr", "colors_nr_fine",
            "pixel_colors_gt", "pixel_colors_gt_fine", "depth_mean",
            "depth_mean_2", "depth_mean_fine", "depth_mean_fine_2",
            "depth_coords"]


@pytest.mark.parametrize("key", OUT_KEYS)
def test_training_forward_matches_jax(matched, key):
    theirs, ours = matched["jax"][2], matched["port"][2]
    np.testing.assert_allclose(ours[key].detach().numpy(),
                               np.asarray(theirs[key]), rtol=0, atol=1e-4)


def test_training_forward_keys_and_masks(matched):
    theirs, ours = matched["jax"][2], matched["port"][2]
    assert set(ours) == set(theirs)
    for k in ("ray_mask", "ray_mask_fine"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))


def test_loss_values_through_the_forward_match_jax(matched):
    tot_j, losses_j = matched["jax"][:2]
    tot_p, losses_p = matched["port"][:2]
    assert set(losses_p) == set(losses_j)
    for k, v in losses_j.items():
        np.testing.assert_allclose(losses_p[k].detach().numpy(),
                                   np.asarray(v), rtol=0, atol=1e-4,
                                   err_msg=k)
    assert tot_p == pytest.approx(tot_j, abs=1e-4)


def compare_grad_trees(got, want, tol=2e-3, floor=1e-6):
    """Per-leaf relative-norm comparison of two flax trees
    (``tests/test_backward_parity.py: _compare_grad_trees``). ``floor``:
    a conv bias that feeds an InstanceNorm (or a softmax) has an exactly
    zero gradient, and both packages leave up to ~4e-7 of rounding in
    it."""
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert set(flat_g) == set(flat_w)
    bad = []
    for k in sorted(flat_w, key=str):
        a = np.asarray(flat_g[k], np.float64)
        b = np.asarray(flat_w[k], np.float64)
        assert a.shape == b.shape, jax.tree_util.keystr(k)
        err, nb = np.linalg.norm(a - b), np.linalg.norm(b)
        if err > tol * nb + floor:
            bad.append(f"{jax.tree_util.keystr(k)}: |d|={err:.3e} "
                       f"|ref|={nb:.3e}")
    assert not bad, "gradient mismatches:\n" + "\n".join(bad)
    return len(flat_w)


def test_gradients_match_jax(matched):
    grads_j, grads_p = matched["jax"][3], matched["port_jax_diff"][3]
    assert compare_grad_trees(grads_p, grads_j) == 294


def test_init_net_gradients_amplify_the_diff_feature_rounding(matched):
    """Why the gradient test hands the port JAX's diff features: the
    port's own differ from them by f32 rounding only, yet the depth init
    net's gradients move past the 2e-3 bar with them on this scene, while
    no other parameter's moves near it."""
    s = tree_t(sphere_sample())
    ref = s["ref"]
    own = N.get_diff_feats(
        ref["imgs"], N.extract_depth_for_init(ref["depth_range"],
                                              ref["depth"]),
        ref["depth_range"], ref["poses"], ref["Ks"])
    feat_err = (own - matched["jax_diff"]).abs().max().item()
    own_g = dict(jax.tree_util.tree_flatten_with_path(matched["port"][3])[0])
    shared = dict(jax.tree_util.tree_flatten_with_path(
        matched["port_jax_diff"][3])[0])
    rel = {jax.tree_util.keystr(k): np.linalg.norm(own_g[k] - v)
           / np.linalg.norm(v) for k, v in shared.items()
           if np.linalg.norm(v) > 1e-3}
    init = max(v for k, v in rel.items() if "init_net" in k)
    rest = max(v for k, v in rel.items() if "init_net" not in k)
    print(f"diff features {feat_err:.3g} apart; gradients move by up to "
          f"{init:.3g} in the init net, {rest:.3g} elsewhere")
    assert feat_err < 1e-5
    assert init > 2e-3 > 10 * rest


# ---------------- the losses on matched output dicts ----------------

def loss_inputs():
    """Random output dicts and ground truth in both packages' forms."""
    rng = np.random.RandomState(0)
    qn, rn, dn = 2, 16, 8
    rfn, pn, h, w = 3, 12, 16, 16

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    pr = {k: rng.rand(qn, rn, 3).astype(np.float32) for k in (
        "pixel_colors_gt", "pixel_colors_nr", "pixel_colors_nr_fine",
        "pixel_colors_dr", "pixel_colors_dr_fine")}
    pr["ray_mask"] = rng.rand(qn, rn) > 0.3
    pr["ray_weight"] = (rng.rand(qn, rn) > 0.2).astype(np.float32)
    for k in ("hit_prob_nr", "hit_prob_self", "hit_prob_nr_fine",
              "hit_prob_self_fine"):
        pr[k] = u(0.01, 0.99, qn, rn, dn)
    pr["depth_coords"] = np.stack([u(0, w - 1, rfn, pn),
                                   u(0, h - 1, rfn, pn)], -1)
    pr["depth_mean"] = u(0.1, 0.9, rfn, pn)
    pr["depth_mean_fine"] = u(0.1, 0.9, rfn, pn)
    true_depth = u(2.0, 5.0, rfn, h, w, 1)
    ref = {"true_depth": true_depth,
           "depth": true_depth + rng.randn(rfn, h, w, 1).astype(
               np.float32) * 0.05,
           "depth_range": np.tile(np.float32([[2.0, 6.0]]), (rfn, 1))}
    return pr, ref


@pytest.mark.parametrize("cfg", [
    {"use_ray_mask": True, "use_nr_fine_loss": True, "use_dr_loss": True,
     "use_dr_fine_loss": True},
    {"use_ray_mask": False}, {"use_ray_mask": False, "weighted": True},
    {"use_ray_mask": True, "weighted": True}])
def test_render_loss_matches_jax(cfg):
    pr, _ = loss_inputs()
    if not cfg.get("weighted"):
        del pr["ray_weight"]
    want = jL.render_loss(cfg)(jax.tree.map(jnp.asarray, pr), {})
    got = L.render_loss(cfg)(tree_t(pr), {})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("cfg,gso", [
    ({}, None), ({}, 0.0), ({}, 1.0), ({"depth_loss_type": "smooth_l1"}, 1.0),
    ({"depth_loss_type": "smooth_l1"}, None), ({"no_depth": True}, None)])
def test_depth_loss_matches_jax(cfg, gso):
    pr, ref = loss_inputs()
    if cfg.get("no_depth"):
        ref = {}
    gt = {"ref": ref} if gso is None else {"ref": ref,
                                           "is_gso": np.float32(gso)}
    want = jL.depth_loss(cfg)(jax.tree.map(jnp.asarray, pr),
                              jax.tree.map(jnp.asarray, gt))
    got = L.depth_loss(cfg)(tree_t(pr), tree_t(gt))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("weighted", [False, True])
def test_consistency_loss_and_build_losses_match_jax(weighted):
    pr, ref = loss_inputs()
    if not weighted:
        del pr["ray_weight"]
    cfg = {"loss": ["render", "depth", "consist"], "use_nr_fine_loss": True}
    gt = {"ref": ref}
    want = jL.build_losses(cfg)(jax.tree.map(jnp.asarray, pr),
                                jax.tree.map(jnp.asarray, gt))
    got = L.build_losses(cfg)(tree_t(pr), tree_t(gt))
    assert set(got) == set(want) >= {"loss_prob", "loss_prob_fine"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert L.consistency_loss({})({"x": t(np.zeros(1))}, {}) == {}


# ---------------- five Adam steps against optax ----------------

def test_adam_trajectory_matches_optax(jax_step, monkeypatch, tmp_path):
    """Five updates from JAX's own init on one sphere sample: the JAX
    trainer's optax.adam with the config's schedule against the port's
    ``Trainer.train_step``, with JAX's u each step. As in
    ``tests/test_backward_parity.py:559-624``: Adam moves every coordinate
    whose gradient sits at the rounding floor by a full lr, so the two
    trajectories part after a few steps; steps 1-2 hold 1e-3 (a wiring
    fault such as a missing bias correction moves step 2 by the whole
    per-step decrease), all five 3%, and both fall."""
    import optax
    renderer, step = jax_step
    sample = sphere_sample(1)
    batch = jax_batch(sample)
    params = jax.jit(lambda k: renderer.init(
        {"params": k, "sample": k}, batch["ref"], batch["que"], True,
        batch["depth_loss_coords"]))(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    opt = optax.adam(learning_rate=jLR.name2lr_manager[CFG["lr_type"]](
        CFG["lr_cfg"]))
    opt_state = opt.init(params)
    traj_j, draws = [], []
    for i in range(5):
        (tot, (_, _, u)), grads = step(params, batch, jax.random.PRNGKey(i))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        traj_j.append(float(tot))
        draws.append(np.asarray(u))

    with_u(monkeypatch, draws)
    trainer = Trainer({**CFG, "train_dataset_type": "synthetic",
                       "train_dataset_cfg": DATA,
                       "output_root": str(tmp_path)}, device="cpu")
    load_flax_params(trainer.renderer, init)
    batch_t = trainer.to_device(sample)
    traj_p = [trainer.train_step(batch_t)["loss_total"] for _ in range(5)]

    assert traj_p[-1] < traj_p[0] and traj_j[-1] < traj_j[0]
    np.testing.assert_allclose(traj_p[:2], traj_j[:2], rtol=0, atol=1e-3,
                               err_msg=f"port {traj_p} vs jax {traj_j}")
    np.testing.assert_allclose(traj_p, traj_j, rtol=3e-2, atol=0,
                               err_msg=f"port {traj_p} vs jax {traj_j}")


# ---------------- data, metrics, schedules, weights ----------------

@pytest.mark.parametrize("is_train", [True, False])
def test_synthetic_dataset_equals_jax(is_train):
    cfg = {"rfn": 2, "h": 24, "w": 20, "train_ray_num": 17,
           "depth_loss_coords_num": 5}
    ours_ds = D.SyntheticRendererDataset(cfg, is_train)
    theirs_ds = jD.SyntheticRendererDataset(cfg, is_train)
    assert len(ours_ds) == len(theirs_ds) == 1024
    for index in (0, 3, 77, 2 ** 16 + 3):
        ours, theirs = ours_ds[index], theirs_ds[index]
        flat_o = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
        flat_t = dict(jax.tree_util.tree_flatten_with_path(theirs)[0])
        assert flat_o.keys() == flat_t.keys()
        for k, v in flat_t.items():
            if isinstance(v, str):
                assert flat_o[k] == v
                continue
            assert flat_o[k].dtype == v.dtype, k
            assert flat_o[k].shape == v.shape, k
            assert flat_o[k].tobytes() == v.tobytes(), k
    assert D.name2dataset.keys() == jD.name2dataset.keys()


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    h, w = 30, 26
    gt = rng.rand(h, w, 3).astype(np.float32)
    data_pr = {"pixel_colors_gt": gt.reshape(1, -1, 3)}
    for i, key in enumerate(("pixel_colors_nr", "pixel_colors_nr_fine")):
        noisy = np.clip(gt + rng.randn(h, w, 3) * 0.05 * (i + 1), 0, 1)
        data_pr[key] = noisy.astype(np.float32).reshape(1, -1, 3)
    a = M.color_map_backward(gt)
    b = M.color_map_backward(data_pr["pixel_colors_nr"].reshape(h, w, 3))
    assert M.compute_psnr(a, b) == pytest.approx(jM.compute_psnr(a, b),
                                                 rel=1e-6)
    assert M.compute_ssim(a, b) == pytest.approx(jM.compute_ssim(a, b),
                                                 rel=1e-6, abs=1e-6)
    for margin in (1.0, 0.7):
        cfg = {"eval_margin_ratio": margin}
        ours = M.PSNR_SSIM(cfg)(data_pr, {"que_shape": (h, w)}, 0)
        theirs = jM.PSNR_SSIM(cfg)(data_pr, {"que_shape": (h, w)}, 0)
        assert ours.keys() == theirs.keys() == {
            "psnr_nr", "ssim_nr", "psnr_nr_fine", "ssim_nr_fine"}
        for k in ours:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-6,
                                       atol=1e-6)
        for name, fn in M.name2key_metrics.items():
            assert fn(ours) == pytest.approx(
                jM.name2key_metrics[name](theirs), rel=1e-6)


@pytest.mark.parametrize("name,cfg", [
    ("exp_decay", {"lr_init": 4e-4, "decay_step": 100, "decay_rate": 0.5,
                   "lr_min": 3e-5}),
    ("exp_decay", {}),
    ("warm_up_exp_decay", {"lr_warm": 2e-4, "warm_step": 50,
                           "lr_init": 1e-3, "decay_step": 30})])
def test_lr_schedules_match_jax(name, cfg):
    ours = LR.name2lr_manager[name](cfg)
    theirs = jLR.name2lr_manager[name](cfg)
    for step in (0, 1, 7, 49, 50, 51, 99, 100, 101, 250, 10 ** 6):
        assert ours(step) == pytest.approx(theirs(step), rel=1e-12)
        # optax calls the schedule with an int32 count
        assert ours(step) == pytest.approx(
            float(theirs(jnp.asarray(step, jnp.int32))), rel=1e-6)


def test_torch_to_flax_round_trips_every_leaf(weights):
    r = R.NeurayRenderer(R.RenderConfig.from_cfg(CFG))
    load_flax_params(r, weights)
    back = torch_to_flax(r)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(weights)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_b.keys() == flat_w.keys() and len(flat_w) == 294
    for k, v in flat_w.items():
        assert flat_b[k].dtype == np.float32
        np.testing.assert_array_equal(flat_b[k], v, err_msg=str(k))
    # named tensors in place of the parameters (gradients) take the same
    # route
    twice = torch_to_flax(r, {n: 2 * p for n, p in r.named_parameters()})
    k = next(iter(flat_w))
    np.testing.assert_array_equal(
        dict(jax.tree_util.tree_flatten_with_path(twice)[0])[k],
        2 * flat_w[k])


# ---------------- configs ----------------

DEPTH_CONFIGS = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "configs").glob("*/**/*.yaml")
    if "/gen/" in str(p) and load_cfg(str(p)).get("init_net_type") == "depth")


@pytest.mark.parametrize("path", DEPTH_CONFIGS)
def test_render_config_from_cfg_matches_jax(path):
    cfg = load_cfg(str(ROOT / path))
    ours = R.RenderConfig.from_cfg(cfg)
    theirs = jR.RenderConfig.from_cfg(cfg)
    for f in dataclasses.fields(theirs):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert {f.name for f in dataclasses.fields(ours)} == {
        f.name for f in dataclasses.fields(theirs)}
    R.NeurayRenderer(ours)


def test_depth_configs_cover_the_shipped_files():
    assert "configs/gen/neuray_gen_depth.yaml" in DEPTH_CONFIGS
    assert "configs/train/gen/neuray_gen_depth_train.yaml" in DEPTH_CONFIGS
    assert len(DEPTH_CONFIGS) == 5


def test_chip_smoke_train_profile_is_the_shipped_training_config():
    """chip_smoke.py phase 8 trains the fields of
    configs/train/gen/neuray_gen_depth_train.yaml (the card's machine
    has no yaml), cut only where ``TRAIN_CUTS`` says."""
    cfg = load_cfg(str(ROOT / "configs" / "train" / "gen" /
                       "neuray_gen_depth_train.yaml"))
    profile = chip_smoke.TRAIN_PROFILE
    assert set(profile) == set(cfg) - set(chip_smoke.TRAIN_CUTS)
    for k, v in profile.items():
        assert v == cfg[k], k
    rc = R.RenderConfig.from_cfg({**profile, **chip_smoke.TRAIN_CUTS})
    assert rc == R.RenderConfig.from_cfg(cfg)
    assert (rc.init_net_type, rc.depth_sample_num, rc.fine_depth_sample_num,
            rc.use_vis, rc.fine_use_vis, rc.use_hierarchical_sampling) == (
        "depth", 64, 64, False, False, True)


@pytest.mark.parametrize("name, relus", [("image_encoder", 1 + 2 * 9),
                                         ("init_net.res_net", 1 + 2 * 6)])
def test_chip_smoke_witness_replays_relu_masks(weights, name, relus):
    """chip_smoke.py phase 12's f64 witness of the renderer's ResUNets
    (``WITNESSED``): given an f32 forward's ReLU masks (``relu_tape``), its
    parameter gradients are that forward's within f32 rounding (1e-4 of
    each leaf's norm, plus 1e-6 of the largest: a conv bias before an
    InstanceNorm has an exactly zero gradient, which f32 leaves as
    rounding); the witness makes as many ReLU calls as it replays (the
    stem's and two a block) and ``F.relu`` comes back. The trained
    encoder on the synthetic sample's 3 views at 64x64 (the init net's on
    its 12 channels: images, depth and random diff features), a random
    output gradient."""
    assert name in chip_smoke.WITNESSED
    enc = port_renderer(weights).get_submodule(name)
    rng = np.random.RandomState(0)
    imgs = sphere_sample()["ref"]["imgs"]
    if name != "image_encoder":
        imgs = np.concatenate([imgs, rng.rand(3, 64, 64, 9)], -1)
    imgs = t(imgs.astype(np.float32))
    grad = t(rng.randn(3, 16, 16, 32).astype(np.float32))
    relu = torch.nn.functional.relu
    masks, restore = chip_smoke.relu_tape(enc)
    try:
        enc(imgs).backward(grad)
    finally:
        restore()
    assert torch.nn.functional.relu is relu and len(masks) == relus
    witness, _, used = chip_smoke.encoder_f64(enc, imgs, grad, masks=masks,
                                              prefix=name)
    assert torch.nn.functional.relu is relu and len(used) == relus
    floor = 1e-6 * max(w.norm() for w in witness.values())
    for n, p in enc.named_parameters():
        w = witness[f"{name}.{n}"]
        assert (p.grad.double() - w).norm() <= 1e-4 * w.norm() + floor, n


# ---------------- imports ----------------

FORBIDDEN = ("jax", "flax", "yaml", "cv2", "PIL", "neuray_tpu", "optax",
             "orbax")


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "neuray_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in imported_modules(ROOT / path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
