"""The port's finetuning slice against the JAX package's: the self-hit
pass, the gathers of maps at two resolutions, the ray features from the
gen model's init net, the FT training forward, its losses and every
gradient (``ray_feats`` included), a 3-step Adam trajectory through the
JAX package's own ``FtRenderer.make_train_step``, the FT render function
and the FT parameter tree.

Scene: the port's fabricated NeRF-synthetic sphere
(``data/synthetic.write_nerf_synthetic_sphere``), 8 train views at
64x64 (at 32x32 the encoders' InstanceNorm over 2x2 pixels puts the
forward at ~2e-4, ``tests/test_torch_port_train.py``), read by both
packages (JAX through cv2). 4 reference views a step, 32 query rays, 8
coarse + 8 fine samples, ``ray_feats`` [8, 16, 16, 32] from the trained
``tools/bench_weights.npz``'s init net, the net from the same weights.
The query rays all hit the sphere (``foreground_ratio`` 1): on nearly
empty rays the fine sampler divides by a coarse hit mass near 0 and a
rounding difference moves the fine depths (ROADMAP Queue 3, fault 3).

The JAX side runs at "highest" matmul precision. torch and JAX draw
different random numbers, so the port is handed JAX's fine draws ``u``,
read out of JAX's jitted step with ``jax.debug.callback`` (as are its
outputs, losses and first gradients). Tolerances: outputs 1e-4, loss
values 1e-5, gradients 2e-3 per leaf in relative norm
(``tests/test_backward_parity.py``'s bars).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from neuray_tpu.data import database as jDB
from neuray_tpu.models import ft as jF
from neuray_tpu.models import renderer as jR
from neuray_tpu.ops import sampling as jS
from neuray_tpu.train import losses as jL
from neuray_tpu.train import lr as jLR

from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
from neuray_tpu_torch.models import ft as F
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.ops import sampling as S
from neuray_tpu_torch.train.ft_trainer import FtTrainer
from neuray_tpu_torch.utils.params import (
    ft_flax_to_torch, ft_torch_to_flax, load_flax_params,
    load_ft_flax_params, load_params_npz)
from tests.test_torch_port_train import ROOT, compare_grad_trees

torch.set_num_threads(1)

SIZE, N_TRAIN = 64, 8
CFG = dict(
    name="ft_parity", database_name="nerf_synthetic/sphere/black_800",
    database_split="val_all", gen_cfg=None, use_validation=True,
    validate_initialization=False, init_view_num=4, neighbor_view_num=4,
    train_ray_num=32, foreground_ratio=1.0, ray_feats_res=[16, 16],
    use_self_hit_prob=True, use_hierarchical_sampling=True,
    depth_sample_num=8, fine_depth_sample_num=8, ray_batch_num=256,
    ray_mask_point_num=4, dist_decoder_cfg={"use_vis": False},
    loss=["render", "consist"], use_nr_fine_loss=True, lr_type="exp_decay",
    lr_cfg={"lr_init": 1e-4, "decay_step": 100000, "decay_rate": 0.5})
GEN_CFG = dict(name="gen", init_net_type="depth",
               use_hierarchical_sampling=True, depth_sample_num=8,
               fine_depth_sample_num=8, dist_decoder_cfg={"use_vis": False})


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The scene folder, both packages' DATA_ROOT on it for the module,
    and both FtRenderers (the port's on the CPU)."""
    root = str(tmp_path_factory.mktemp("ft"))
    write_nerf_synthetic_sphere(root, n_train=N_TRAIN, size=SIZE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DB, "DATA_ROOT", root)
        mp.setattr(jDB, "DATA_ROOT", root)
        yield {"root": root, "jax": jF.FtRenderer(dict(CFG)),
               "port": F.FtRenderer(dict(CFG), device="cpu")}


@pytest.fixture(scope="module")
def weights():
    return load_params_npz(str(ROOT / "tools" / "bench_weights.npz"))


@pytest.fixture(scope="module")
def net_tree(weights):
    """The FT net's tree: the trained weights without the init net."""
    return {"params": {k: v for k, v in weights["params"].items()
                       if k != "init_net"}}


@pytest.fixture(scope="module")
def init_feats(scene, weights):
    """Each package's ray_feats from the gen model's init net."""
    gen_j = jR.NeurayRenderer(jR.RenderConfig.from_cfg(GEN_CFG))
    with jax.default_matmul_precision("highest"):
        theirs = np.asarray(scene["jax"].init_ray_feats_from_gen(
            gen_j, weights))
    gen = R.NeurayRenderer(R.RenderConfig.from_cfg(GEN_CFG))
    load_flax_params(gen, weights)
    ours = scene["port"].init_ray_feats_from_gen(gen).numpy()
    return ours, theirs


def ft_tree(net_tree, init_feats):
    return {"net": net_tree, "ray_feats": init_feats[1]}


def port_ft(scene, net_tree, init_feats):
    ft = scene["port"]
    load_ft_flax_params(ft, ft_tree(net_tree, init_feats))
    return ft


def with_u(monkeypatch, draws):
    """The port's fine draws replaced by JAX's, in order."""
    it = iter(draws)
    monkeypatch.setattr(R.NeurayRenderer, "draw_fine_u", staticmethod(
        lambda shape, device, generator: t(next(it))))


# ---------------- the renderer's new paths ----------------

@pytest.mark.parametrize("is_fine", [False, True])
@pytest.mark.parametrize("fhw", [(16, 16), (12, 20)])
def test_self_hit_prob_matches_jax(net_tree, is_fine, fhw):
    """``_predict_self_hit_prob``: the query's own ray_feats [1, fh, fw,
    32] sampled at its coords (some outside the image: the border clamp)
    through the fused gather, decoded and integrated over its depths."""
    rng = np.random.RandomState(fhw[1] + is_fine)
    que = {"coords": rng.uniform(-3, SIZE + 2, (1, 40, 2)).astype(np.float32),
           "imgs": rng.rand(1, SIZE, SIZE, 3).astype(np.float32),
           "ray_feats": rng.randn(1, *fhw, 32).astype(np.float32),
           "depth_range": np.float32([[2.0, 6.0]])}
    depth = np.sort(rng.uniform(2.0, 6.0, (1, 40, 8)), -1).astype(np.float32)
    dists = np.asarray(jS.depth2inv_dists(depth, que["depth_range"]))
    renderer = jR.NeurayRenderer(jR.RenderConfig.from_cfg(CFG))
    method = jR.NeurayRenderer._predict_self_hit_prob
    theirs = jax.jit(lambda p, q, d, i: renderer.apply(
        p, q, d, i, is_fine, method=method))(
        net_tree, jax.tree.map(jnp.asarray, que), depth, dists)
    net = R.NeurayRenderer(R.RenderConfig.from_cfg(
        {**CFG, "init_net_type": ""}))
    load_flax_params(net, net_tree)
    with torch.no_grad():
        ours = net._predict_self_hit_prob(
            {k: t(v) for k, v in que.items()}, t(depth),
            S.depth2inv_dists(t(depth), t(que["depth_range"])), is_fine)
    assert ours.shape == (1, 40, 8)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=1e-4)


def test_maps_at_two_resolutions_render_as_jax(scene, net_tree, monkeypatch):
    """ray_feats at [12, 20] beside img_feats at the image's quarter
    [16, 16]: no packed map, three gathers a pass (rgb, ray_feats,
    img_feats), as the JAX package's plain route; coarse + fine eval
    render at 1e-4."""
    rng = np.random.RandomState(7)
    jft = scene["jax"]
    ref = {k: np.asarray(v) for k, v in jft._slice_ref(np.arange(4)).items()}
    ref["ray_feats"] = rng.randn(4, 12, 20, 32).astype(np.float32)
    ref["img_feats"] = rng.randn(4, 16, 16, 32).astype(np.float32)
    ys, xs = np.nonzero(jft.val_info["masks"][0, :, :, 0] > 0)
    que = {"coords": np.stack([xs, ys], -1)[None, :100].astype(np.float32)}
    for k in ("poses", "Ks", "depth_range"):
        que[k] = jft.val_info[k][:1]

    renderer = jR.NeurayRenderer(jR.RenderConfig.from_cfg(
        {**CFG, "init_net_type": ""}))
    ref_j = renderer.build_gather_cache(jax.tree.map(jnp.asarray, ref))
    assert not {"fused_map", "rgb_quad"} & set(ref_j)
    theirs = jax.jit(lambda p, r, q: renderer.apply(
        p, r, q, False, method=jR.NeurayRenderer.render_chunk))(
        net_tree, ref_j, jax.tree.map(jnp.asarray, que))

    net = scene["port"].net
    load_flax_params(net, net_tree)
    calls = []
    gather = R.interpolate_feature_map
    monkeypatch.setattr(R, "interpolate_feature_map", lambda feats, *a: (
        calls.append(tuple(feats.shape[1:3])), gather(feats, *a))[1])
    with torch.no_grad():
        ref_c = net.build_gather_cache({k: t(v) for k, v in ref.items()})
        assert "feats" not in ref_c
        ours = net.render_chunk(ref_c, {k: t(v) for k, v in que.items()})
    assert calls == [(SIZE, SIZE), (12, 20), (16, 16)] * 2
    for k in ("pixel_colors_nr", "pixel_colors_nr_fine", "hit_prob_nr",
              "hit_prob_nr_fine"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


# ---------------- the FT model ----------------

def test_init_ray_feats_from_gen_matches_jax(init_feats):
    """Forward only (no gradient amplifies the diff features' rounding
    here): each view's init-net map from its 4 nearest views at 1e-4."""
    ours, theirs = init_feats
    assert ours.shape == theirs.shape == (N_TRAIN, SIZE // 4, SIZE // 4, 32)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)


def test_ft_scene_state_equals_jax(scene):
    """The split, nearest views, the store and the step's draws."""
    jft, ft = scene["jax"], scene["port"]
    np.testing.assert_array_equal(ft.ref_ids, jft.ref_ids)
    np.testing.assert_array_equal(ft.ref_dist_idx, jft.ref_dist_idx)
    np.testing.assert_array_equal(ft.val_dist_idx, jft.val_dist_idx)
    for k, v in jft.ref_store.items():
        if k in ft.ref_store:
            np.testing.assert_array_equal(ft.ref_store[k].numpy(),
                                          np.asarray(v), err_msg=k)
    for seed in range(5):
        a = ft.sample_train_indices(np.random.RandomState(seed))
        b = jft.sample_train_indices(np.random.RandomState(seed))
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        rng_a, rng_b = (np.random.RandomState(seed) for _ in range(2))
        qa = ft._build_que_train(a[1], a[0], rng_a)
        qb = jft._build_que_train(b[1], b[0], rng_b)
        for k, v in qb.items():
            np.testing.assert_array_equal(qa[k].numpy(), np.asarray(v),
                                          err_msg=k)


@pytest.fixture(scope="module")
def jax_run(scene, net_tree, init_feats):
    """Three steps of the JAX package's own ``FtRenderer.make_train_step``
    with ``optax.adam`` at the config's schedule, on one batch. Read out
    through ``jax.debug.callback``: each step's fine draws, the first
    step's outputs, losses and gradients (an identity transformation
    chained before Adam), and each step's loss_total."""
    jft = scene["jax"]
    draws, outs, grads = [], [], []
    orig = jS.sample_fine_depth

    def capture(depth, hit_prob, dr, fdn, random_sample, rng=None,
                inv_mode=True):
        if random_sample:
            u = jax.random.uniform(rng, (*hit_prob.shape[:-1], fdn))
            jax.debug.callback(lambda x: draws.append(np.asarray(x)), u)
        return orig(depth, hit_prob, dr, fdn, random_sample, rng, inv_mode)

    loss_fn = jL.build_losses(CFG)

    def loss_and_capture(outputs, data_gt):
        losses = loss_fn(outputs, data_gt)
        jax.debug.callback(lambda o, l: outs.append((o, l)), outputs, losses)
        return losses

    def grad_capture():
        def update(updates, state, params=None):
            jax.debug.callback(lambda g: grads.append(g), updates)
            return updates, state
        return optax.GradientTransformation(lambda p: optax.EmptyState(),
                                            update)

    opt = optax.chain(grad_capture(), optax.adam(
        jLR.name2lr_manager[CFG["lr_type"]](CFG["lr_cfg"])))
    que_i, ref_idx = jft.sample_train_indices(np.random.RandomState(3))
    que = jft._build_que_train(ref_idx, que_i, np.random.RandomState(4))
    params = jax.tree.map(jnp.asarray, ft_tree(net_tree, init_feats))
    opt_state = opt.init(params)
    totals = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jS, "sample_fine_depth", capture)
        step = jft.make_train_step(opt, loss_and_capture)
        for i in range(3):
            params, opt_state, metrics = step(
                params, opt_state, np.asarray(ref_idx), que,
                np.asarray(que_i), jax.random.PRNGKey(i))
            totals.append(float(metrics["loss_total"]))
    jax.effects_barrier()
    assert len(draws) == 3 and len(outs) == 3 and len(grads) == 3
    return {"que_i": que_i, "ref_idx": ref_idx, "draws": draws,
            "outputs": outs[0][0], "losses": outs[0][1], "grads": grads[0],
            "totals": totals}


def port_batch(scene, jax_run):
    return scene["port"]._build_que_train(
        jax_run["ref_idx"], jax_run["que_i"], np.random.RandomState(4))


@pytest.fixture(scope="module")
def port_step(scene, net_tree, init_feats, jax_run):
    """The port's FT training forward, losses and gradients on the same
    parameters, batch and draws."""
    ft = port_ft(scene, net_tree, init_feats)
    with pytest.MonkeyPatch.context() as mp:
        with_u(mp, jax_run["draws"][:1])
        out = ft(jax_run["ref_idx"], port_batch(scene, jax_run),
                 jax_run["que_i"])
    from neuray_tpu_torch.train.losses import build_losses
    losses = build_losses(CFG)(out, {})
    total = sum(v.mean() for k, v in losses.items() if k.startswith("loss"))
    ft.zero_grad(set_to_none=True)
    total.backward()
    grads = ft_torch_to_flax(ft, {n: p.grad for n, p in ft.named_parameters()})
    return out, losses, grads


FT_OUT_KEYS = ["pixel_colors_nr", "pixel_colors_nr_fine", "hit_prob_nr",
               "hit_prob_nr_fine", "colors_nr", "colors_nr_fine",
               "pixel_colors_gt", "pixel_colors_gt_fine", "hit_prob_self",
               "hit_prob_self_fine"]


@pytest.mark.parametrize("key", FT_OUT_KEYS)
def test_ft_training_forward_matches_jax(jax_run, port_step, key):
    theirs, ours = jax_run["outputs"], port_step[0]
    np.testing.assert_allclose(ours[key].detach().numpy(),
                               np.asarray(theirs[key]), rtol=0, atol=1e-4)


def test_ft_training_forward_keys_and_masks(jax_run, port_step):
    theirs, ours = jax_run["outputs"], port_step[0]
    assert set(ours) == set(theirs)
    for k in ("ray_mask", "ray_mask_fine"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))


def test_ft_losses_match_jax(jax_run, port_step):
    theirs, ours = jax_run["losses"], port_step[1]
    assert set(ours) == set(theirs) == {
        "loss_rgb_nr", "loss_rgb_nr_fine", "loss_prob", "loss_prob_fine"}
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k].detach().numpy(), np.asarray(v),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_ft_gradients_match_jax(jax_run, port_step):
    """Every leaf, the net's and ``ray_feats`` [8, 16, 16, 32] (dense: the
    views the step did not select have a zero gradient on both sides)."""
    theirs, ours = jax_run["grads"], port_step[2]
    assert compare_grad_trees(ours, theirs) == 1 + sum(
        1 for _ in jax.tree_util.tree_leaves(theirs["net"]))
    g = np.abs(ours["ray_feats"]).reshape(N_TRAIN, -1).max(-1)
    touched = set(jax_run["ref_idx"]) | {jax_run["que_i"]}
    assert all((g[i] > 0) == (i in touched) for i in range(N_TRAIN))


def test_ft_adam_trajectory_matches_optax(scene, net_tree, init_feats,
                                          jax_run, monkeypatch, tmp_path):
    """Three updates on one batch: ``FtTrainer.train_step`` against the
    JAX package's ``make_train_step`` with optax.adam, each step with
    JAX's draws. ``test_adam_trajectory_matches_optax``'s envelope: Adam
    moves a coordinate whose gradient sits at the rounding floor by a
    whole lr, so the trajectories part slowly; steps 1-2 within 1e-3
    (a missing bias correction moves step 2 by the whole per-step
    decrease), all within 3%, and both fall."""
    monkeypatch.setattr(DB, "DATA_ROOT", scene["root"])
    trainer = FtTrainer({**CFG, "output_root": str(tmp_path)}, device="cpu")
    load_ft_flax_params(trainer.ft, ft_tree(net_tree, init_feats))
    trainer.build_optimizer()
    with_u(monkeypatch, jax_run["draws"])
    que = port_batch(scene, jax_run)
    batch = (jax_run["ref_idx"], que, jax_run["que_i"])
    ours = [trainer.train_step(batch)["loss_total"] for _ in range(3)]
    theirs = jax_run["totals"]
    assert ours[-1] < ours[0] and theirs[-1] < theirs[0]
    np.testing.assert_allclose(ours[:2], theirs[:2], rtol=0, atol=1e-3,
                               err_msg=f"port {ours} vs jax {theirs}")
    np.testing.assert_allclose(ours, theirs, rtol=3e-2, atol=0,
                               err_msg=f"port {ours} vs jax {theirs}")


def test_ft_render_fn_matches_jax(scene, net_tree, init_feats):
    """``make_ft_render_fn`` on 200 pixels of val view 0 where it sees the
    sphere, from its 4 nearest train views' ray_feats: eval coarse + fine
    at 1e-4."""
    jft = scene["jax"]
    ref_idx = jft.val_dist_idx[0][:CFG["neighbor_view_num"]]
    ys, xs = np.nonzero(jft.val_info["masks"][0, :, :, 0] > 0)
    pick = np.random.RandomState(0).choice(ys.size, 200, replace=False)
    que = {"coords": np.stack([xs[pick], ys[pick]], -1)[None].astype(
        np.float32)}
    for k in ("poses", "Ks", "depth_range"):
        que[k] = jft.val_info[k][:1]
    ref = jft._slice_ref(ref_idx)
    ref["ray_feats_raw"] = jnp.asarray(init_feats[1][ref_idx])
    theirs = jF.make_ft_render_fn(jft)(net_tree, ref,
                                       jax.tree.map(jnp.asarray, que))

    ft = port_ft(scene, net_tree, init_feats)
    ref_t = ft._slice_ref(t(ref_idx))
    ref_t["ray_feats_raw"] = ft.ray_feats.detach()[t(ref_idx)]
    ours = F.make_ft_render_fn(ft)(ref_t, {k: t(v) for k, v in que.items()})
    assert set(ours) == {"pixel_colors_nr", "pixel_colors_nr_fine"}
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-4, err_msg=k)


def test_validate_view_renders_the_whole_view(scene, net_tree, init_feats):
    ft = port_ft(scene, net_tree, init_feats)
    out, gt, (h, w) = ft.validate_view(F.make_ft_render_fn(ft), 2)
    assert (h, w) == (SIZE, SIZE) and gt.shape == (SIZE, SIZE, 3)
    np.testing.assert_array_equal(gt, scene["jax"].val_info["imgs"][2])
    for v in out.values():
        assert v.shape == (1, SIZE * SIZE, 3) and torch.isfinite(v).all()


# ---------------- the FT tree ----------------

def test_ft_tree_round_trips_every_leaf(scene, net_tree, init_feats):
    tree = ft_tree(net_tree, init_feats)
    ft = port_ft(scene, net_tree, init_feats)
    assert set(ft_flax_to_torch(tree)) == set(ft.state_dict())
    back = ft_torch_to_flax(ft)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_b.keys() == flat_w.keys()
    for k, v in flat_w.items():
        assert flat_b[k].dtype == np.float32
        np.testing.assert_array_equal(flat_b[k], v, err_msg=str(k))
    with pytest.raises(ValueError, match="init_net"):
        load_ft_flax_params(ft, {"net": {"params": {
            **net_tree["params"], "init_net": {"conv_out": {"kernel": np.zeros(
                (1, 1, 48, 32), np.float32)}}}}, "ray_feats": init_feats[1]})
