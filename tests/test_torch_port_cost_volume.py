"""The port's cost-volume init net against the JAX package's: the weight
bridge over ``tools/bench_weights_cv.npz``, MVSNet's modules
(``FrozenBN``, ``FeatureNet``, ``CostRegNet`` with its transposed
convs), ``homo_warp``, ``depth_regression``, ``get_depth_vals``,
``construct_project_matrix``, the eval-time resize, ``CostVolumeInitNet``,
the cost-volume render through ``render_full`` with src views, the
training forward's gradients (MVSNet's exactly 0) and the bf16 + u8
render.

Scene: the synthetic sphere, 3 reference views at 64x64 that are also
the source views, ``nn_ids`` each view's 2 nearest other views by camera
centre (``tools/bench_cost_volume.py``'s wiring); MVSNet at the weights'
64 planes over [16, 16] maps. The JAX side runs with ``use_bf16=False``
at "highest" matmul precision (ROADMAP Queue 3, hazard a), its modules
under ``jax.jit``. Tolerances: module outputs and renders 1e-4 (stated
otherwise where the module's scale calls for it), gradients 2e-3 per
leaf in relative norm; the bf16 + u8 render by the rule of
``tests/test_torch_port_bf16.py``.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuray_tpu.data import train_dataset as jD
from neuray_tpu.data.synthetic import make_query, make_sphere_scene
from neuray_tpu.models import cost_volume as jCV
from neuray_tpu.models import mvsnet as jM
from neuray_tpu.models import renderer as jR
from neuray_tpu.ops import sampling as jS
from neuray_tpu.train import losses as jL

from neuray_tpu_torch.models import cost_volume as CV
from neuray_tpu_torch.models import mvsnet as M
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.train import losses as L
from neuray_tpu_torch.utils.params import (
    flax_to_torch, init_like_flax, load_flax_params, load_params_npz,
    torch_to_flax)
from tests.test_torch_port_bf16 import MODES, held
from tests.test_torch_port_train import compare_grad_trees

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "tools" / "bench_weights_cv.npz"
H = W = 64
RFN, NN = 3, 2
# configs/gen/neuray_gen_cost_volume.yaml's render fields at test size
CFG = dict(init_net_type="cost_volume", use_hierarchical_sampling=True,
           depth_sample_num=8, fine_depth_sample_num=8, ray_batch_num=128,
           use_vis=False, fine_use_vis=False, render_depth=True,
           ray_mask_point_num=4)
N_RAYS = 1023


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def t(x):
    return torch.from_numpy(np.array(x))


def nearest_others(poses, nn):
    centers = np.stack([-p[:, :3].T @ p[:, 3] for p in poses])
    return np.stack([np.argsort(np.linalg.norm(centers - c, axis=1))[1:nn + 1]
                     for c in centers]).astype(np.int64)


def cv_scene(seed=0, rfn=RFN, h=H, w=W, nn=NN):
    """ref (with nn_ids) and src (the refs) of the sphere scene."""
    ref = make_sphere_scene(np.random.RandomState(seed), rfn, h, w)
    ref["nn_ids"] = nearest_others(ref["poses"], nn)
    src = {k: ref[k] for k in ("imgs", "poses", "Ks", "depth_range")}
    return ref, src


def jx(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def tt(tree):
    return {k: t(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def weights():
    return load_params_npz(str(WEIGHTS))


@pytest.fixture(scope="module")
def init_tree(weights):
    return weights["params"]["init_net"]


def port(module, tree):
    load_flax_params(module, {"params": tree})
    return module.eval()


# ---------------- the weight bridge ----------------

def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_bridge_round_trips_every_leaf_of_the_cv_weights(weights):
    renderer = R.NeurayRenderer(R.RenderConfig(**CFG))
    load_flax_params(renderer, weights)
    back = dict(_flat(torch_to_flax(renderer)))
    want = dict(_flat(weights))
    assert len(want) == len(back) == 431
    assert set(back) == set(want)
    for k, v in want.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v, err_msg="/".join(k))
    fb = renderer.init_net.mvsnet.cost_regularization.conv0.bn
    assert not fb.mean.requires_grad and not fb.var.requires_grad
    assert fb.weight.requires_grad


def test_bridge_maps_each_3d_kernel_kind():
    """A Conv3d kernel [kd, kh, kw, in, out] and a ConvTranspose3d one in
    flax's transpose_kernel layout [kd, kh, kw, out, in] both become
    their torch module's weight by the one permutation."""
    k = np.arange(3 * 3 * 3 * 4 * 6, dtype=np.float32).reshape(3, 3, 3, 4, 6)
    w = flax_to_torch({"a": {"kernel": k}})["a.weight"].numpy()
    assert w.shape == (6, 4, 3, 3, 3)
    assert w[5, 2, 0, 1, 2] == k[0, 1, 2, 2, 5]
    assert torch.nn.Conv3d(4, 6, 3).weight.shape == w.shape
    assert torch.nn.ConvTranspose3d(6, 4, 3).weight.shape == w.shape


def test_deconv_kernel_mapping_matches_jax_transpose_kernel():
    """The proof of the ConvTranspose3d mapping: JAX's ``_DeconvBn`` conv
    (VALID ``nn.ConvTranspose(transpose_kernel=True)`` cropped to
    [1:2i+1]) and the port's ``ConvTranspose3d(k3, s2, p1, op1)`` with
    the bridged kernel, no flip, on random input; the spatially flipped
    kernel does not match."""
    rng = np.random.RandomState(0)
    kernel = rng.randn(3, 3, 3, 5, 7).astype(np.float32)   # k,k,k,out,in
    x = rng.randn(2, 3, 4, 5, 7).astype(np.float32)        # n,d,h,w,in
    params = {"conv": {"kernel": kernel},
              "bn": {"scale": np.ones(5, np.float32),
                     "bias": np.zeros(5, np.float32),
                     "mean": np.zeros(5, np.float32),
                     "var": np.full(5, 1.0 - 1e-5, np.float32)}}
    theirs = np.asarray(jax.jit(jM._DeconvBn(5).apply)(
        {"params": params}, jnp.asarray(x)))
    mod = port(M._DeconvBn(7, 5), params)
    ours = mod(t(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert ours.shape == theirs.shape == (2, 6, 8, 10, 5)
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=0,
                               atol=1e-4)
    with torch.no_grad():
        mod.conv.weight.copy_(mod.conv.weight.flip(2, 3, 4))
    flipped = mod(t(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert np.abs(flipped.detach().numpy() - theirs).max() > 0.1


def test_init_like_flax_covers_the_cost_volume_net():
    """flax's initializers: 3-D kernels by fan_in (a transposed kernel's
    counts its out channels), FrozenBN scale 1, bias 0, mean 0, var 1."""
    net = CV.CostVolumeInitNet(8)
    for p in net.parameters():
        torch.nn.init.constant_(p, 7.0)
    torch.manual_seed(0)
    init_like_flax(net)
    cr = net.mvsnet.cost_regularization
    for conv, fan_in in ((cr.conv6.conv, 27 * 64), (cr.conv7.conv, 27 * 32)):
        w = conv.weight.detach()
        std = np.sqrt(1.0 / fan_in)
        assert abs(w.std().item() - std) < 0.1 * std
        assert w.abs().max().item() <= 2 * std / 0.87962566103423978
    bn = cr.conv7.bn
    for p, v in ((bn.weight, 1.0), (bn.bias, 0.0), (bn.mean, 0.0),
                 (bn.var, 1.0)):
        assert torch.equal(p, torch.full_like(p, v))
    assert torch.equal(cr.prob.bias, torch.zeros(1))


# ---------------- MVSNet's modules ----------------

def test_frozen_bn_matches_jax():
    rng = np.random.RandomState(1)
    p = {"scale": rng.randn(6), "bias": rng.randn(6), "mean": rng.randn(6),
         "var": rng.rand(6) + 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.randn(2, 5, 7, 6).astype(np.float32) * 3
    theirs = np.asarray(jM.FrozenBN(6).apply({"params": p}, jnp.asarray(x)))
    ours = port(M.FrozenBN(6), p)(t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).detach().numpy(),
                               theirs, rtol=0, atol=1e-5)
    assert (theirs < 0).any()                   # the leaky branch ran


def test_feature_net_matches_jax(init_tree):
    tree = init_tree["mvsnet"]["feature"]
    x = np.random.RandomState(2).randn(2, 40, 48, 3).astype(np.float32)
    theirs = np.asarray(jax.jit(jM.FeatureNet().apply)(
        {"params": tree}, jnp.asarray(x)))
    ours = port(M.FeatureNet(), tree)(t(x).permute(0, 3, 1, 2))
    assert theirs.shape == (2, 10, 12, 32)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).detach().numpy(),
                               theirs, rtol=0, atol=1e-4)


def test_cost_reg_net_matches_jax(init_tree):
    """The 3-D U-Net with its three transposed convs, on a variance-like
    volume [1, 16, 8, 24, 32] (channels-last in JAX)."""
    tree = init_tree["mvsnet"]["cost_regularization"]
    x = np.random.RandomState(3).rand(1, 16, 8, 24, 32).astype(np.float32)
    theirs = np.asarray(jax.jit(jM.CostRegNet().apply)(
        {"params": tree}, jnp.asarray(x)))[..., 0]
    ours = port(M.CostRegNet(), tree)(t(x).permute(0, 4, 1, 2, 3))[:, 0]
    assert ours.shape == theirs.shape == (1, 16, 8, 24)
    scale = np.abs(theirs).max()
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=0,
                               atol=1e-4 * max(scale, 1.0))


def _warp_inputs():
    """Random features and a source projection that puts part of the
    planes behind the source camera (z < 1e-4, clamped) and part of the
    points outside the map."""
    rng = np.random.RandomState(4)
    n, h, w, c, dn = 2, 12, 16, 8, 6
    feats = rng.randn(n, h, w, c).astype(np.float32)
    src = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    src[:, 2, 0] = rng.uniform(-0.05, 0.05, n)
    src[:, 2, 1] = rng.uniform(-0.05, 0.05, n)
    src[:, :3, 3] = [[1.0, -2.0, -1.2], [-3.0, 1.0, -0.9]]
    ref_inv = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    ref_inv[:, 0, 0] = ref_inv[:, 1, 1] = 0.9
    depth = np.stack([np.linspace(0.4, 9.0, dn)] * n).astype(np.float32)
    return feats, src, ref_inv, depth


def test_homo_warp_matches_jax():
    feats, src, ref_inv, depth = _warp_inputs()
    theirs = np.asarray(jax.jit(jM.homo_warp)(
        jnp.asarray(feats), jnp.asarray(src), jnp.asarray(ref_inv),
        jnp.asarray(depth)))
    ours = M.homo_warp(t(feats).permute(0, 3, 1, 2), t(src), t(ref_inv),
                       t(depth)).permute(0, 2, 3, 4, 1).numpy()
    assert ours.shape == theirs.shape == (2, 6, 12, 16, 8)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)
    # the cases the inputs were built for: planes behind the source camera
    # (every tap outside, exactly 0), points outside, and points inside
    zero = (theirs == 0).all(-1)
    assert zero[:, 0].all()                      # z < 0 on the nearest plane
    assert 0 < zero[:, -1].mean() < 1            # partly out of the map
    assert (~zero).sum() > 500


def test_depth_regression_and_depth_vals_match_jax():
    rng = np.random.RandomState(5)
    dr = np.array([[1.3, 5.5], [0.7, 9.0]], np.float32)
    for dn in (8, 64):
        ours = CV.get_depth_vals(t(dr), dn).numpy()
        theirs = np.asarray(jCV.get_depth_vals(jnp.asarray(dr), dn))
        np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)
        assert (ours[:, -1] == dr[:, 1]).all()              # far pinned
        prob = rng.rand(2, dn, 5, 6).astype(np.float32)
        np.testing.assert_allclose(
            M.depth_regression(t(prob), t(ours)).numpy(),
            np.asarray(jM.depth_regression(jnp.asarray(prob),
                                           jnp.asarray(ours))),
            rtol=1e-6, atol=0)


def test_construct_project_matrix_matches_jax():
    ref, _ = cv_scene()
    for ratio in (1.0, 0.75, 0.8):
        ours = CV.construct_project_matrix(0.25 * ratio, 0.25 * ratio,
                                           t(ref["Ks"]), t(ref["poses"]))
        theirs = jCV.construct_project_matrix(
            0.25 * ratio, 0.25 * ratio, jnp.asarray(ref["Ks"]),
            jnp.asarray(ref["poses"]))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-6, atol=1e-6)


# ---------------- the eval-time resize ----------------

@pytest.mark.parametrize("src_hw,dst_hw,channels", [
    ((768, 1024), (576, 768), 3), ((800, 800), (640, 640), 3),
    ((144, 192), (192, 256), 8), ((160, 160), (200, 200), 8)])
def test_resize_matches_jax_image_resize(src_hw, dst_hw, channels):
    """``resize_bilinear`` against ``jax.image.resize(..., "bilinear")``
    on both branches' image downsample and logits upsample; without the
    antialiasing, the downsample is far off (ROADMAP Queue 3, fault 7)."""
    x = np.random.RandomState(6).rand(2, channels, *src_hw).astype(
        np.float32)
    theirs = np.asarray(jax.image.resize(
        jnp.asarray(x), (2, channels, *dst_hw), "bilinear"))
    ours = CV.resize_bilinear(t(x), *dst_hw).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    plain = torch.nn.functional.interpolate(
        t(x), size=dst_hw, mode="bilinear", align_corners=False).numpy()
    print(f"{src_hw} -> {dst_hw}: max |diff| from jax.image.resize "
          f"{np.abs(ours - theirs).max():.3g} antialiased, "
          f"{np.abs(plain - theirs).max():.3g} plain")
    if dst_hw[0] < src_hw[0]:
        assert np.abs(plain - theirs).max() > 0.05
    else:
        np.testing.assert_allclose(plain, theirs, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", [(768, 1024), (800, 800)])
def test_build_cost_volume_eval_resize_matches_jax(init_tree, hw):
    """The eval-time branch in place: one 1024x768 (800x800) view and one
    source view through MVSNet at 768x576 (640x640) with the 0.75 (0.8)
    scaled projections, the logits resized back to h/4 x w/4; 8 planes
    keep it small. Not taken in training."""
    ref, src = cv_scene(1, rfn=2, h=hw[0], w=hw[1], nn=1)
    ref = {k: v[:1] for k, v in ref.items()}
    jnet = jCV.CostVolumeInitNet({"cost_volume_sn": 8})
    tree = {"params": {"mvsnet": init_tree["mvsnet"]}}
    run = jax.jit(lambda r, s, train: jnet.apply(
        tree, r, s, train, method=jCV.CostVolumeInitNet.build_cost_volume),
        static_argnums=2)
    net = CV.CostVolumeInitNet(8)
    load_flax_params(net.mvsnet, {"params": init_tree["mvsnet"]})
    prob, depth = net.eval().build_cost_volume(tt(ref), tt(src))
    t_prob, t_depth = run(jx(ref), jx(src), False)
    assert prob.shape == (1, 8, hw[0] // 4, hw[1] // 4)
    np.testing.assert_allclose(prob.numpy(), np.asarray(t_prob), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(depth.numpy(), np.asarray(t_depth), rtol=0,
                               atol=1e-4 * float(ref["depth_range"].max()))


# ---------------- the init net and the render ----------------
# ``bench_weights_cv.npz``'s MVSNet is at flax's initialization (the
# reference's mvsnet_pl.ckpt is not in the repository, and MVSNet takes no
# gradient in training): its logits are ~1e-3, the probability volume is
# ~1/64 everywhere and the depth map nearly constant. The init net's volume
# and depth branches then put near-constant maps through InstanceNorm
# (eps 1e-5), which magnifies f32 rounding ~1e4-fold: one ulp of JAX's own
# depth map moves JAX's own G' by ~1e-2, and the port lands within a few
# times that (``test_init_net_magnifies_the_volume_rounding``). So the
# init net, the render and the gradients are compared on ``SHARP``: the
# same weights with MVSNet's last conv kernel times 1000, which puts its
# logits at ~1 (a volume with contrast, depth maps that vary by ~0.1) and
# runs every module of the path.
SHARP = 1000.0


@pytest.fixture(scope="module")
def sharp(weights):
    tree = {"params": {**weights["params"], "init_net": {
        **weights["params"]["init_net"], "mvsnet": {
            **weights["params"]["init_net"]["mvsnet"],
            "cost_regularization": {
                **weights["params"]["init_net"]["mvsnet"][
                    "cost_regularization"]}}}}}
    cr = tree["params"]["init_net"]["mvsnet"]["cost_regularization"]
    cr["prob"] = {"kernel": cr["prob"]["kernel"] * np.float32(SHARP),
                  "bias": cr["prob"]["bias"]}
    return tree


def jax_cost_volume(init_tree, ref, src, is_train=False, sn=64):
    jnet = jCV.CostVolumeInitNet({"cost_volume_sn": sn})
    prob, depth = jax.jit(lambda r, s: jnet.apply(
        {"params": {"mvsnet": init_tree["mvsnet"]}}, r, s, is_train,
        method=jCV.CostVolumeInitNet.build_cost_volume))(jx(ref), jx(src))
    return np.asarray(prob), np.asarray(depth)


@pytest.fixture(scope="module")
def volume(init_tree):
    ref, src = cv_scene()
    return jax_cost_volume(init_tree, ref, src)


def jax_init_net(init_tree, ref, src, prob=None, depth=None):
    """JAX's G', on its own cost volume or on (prob, depth) given."""
    jnet = jCV.CostVolumeInitNet({"cost_volume_sn": 64})
    with pytest.MonkeyPatch.context() as mp:
        if prob is not None:
            mp.setattr(jCV.CostVolumeInitNet, "build_cost_volume",
                       lambda self, ref, src, is_train: (jnp.asarray(prob),
                                                         jnp.asarray(depth)))
        return np.asarray(jax.jit(jnet.apply)({"params": init_tree}, jx(ref),
                                               jx(src)))


def test_cost_volume_matches_jax(init_tree, volume):
    """MVSNet, the softmax and the depth regression at the weights' 64
    planes: a real volume (each pixel's probabilities sum to 1, the
    depths lie inside the range), held to JAX."""
    ref, src = cv_scene()
    net = port(CV.CostVolumeInitNet(64), init_tree)
    prob, depth = net.build_cost_volume(tt(ref), tt(src))
    assert prob.shape == (RFN, 64, H // 4, W // 4)
    assert not prob.requires_grad and not depth.requires_grad
    np.testing.assert_allclose(prob.numpy(), volume[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(depth.numpy(), volume[1], rtol=1e-5, atol=0)
    np.testing.assert_allclose(prob.sum(1).numpy(), 1.0, atol=1e-5)
    dr = ref["depth_range"][0]
    assert (depth >= dr[0]).all() and (depth <= dr[1]).all()


def test_cost_volume_init_net_matches_jax(sharp):
    ref, src = cv_scene()
    tree = sharp["params"]["init_net"]
    theirs = jax_init_net(tree, ref, src)
    prob, depth = jax_cost_volume(tree, ref, src)
    assert prob.max() > 0.04 and depth.std(axis=(1, 2)).min() > 0.05
    with torch.no_grad():
        ours = port(CV.CostVolumeInitNet(64), tree)(tt(ref), tt(src)).numpy()
    assert ours.shape == theirs.shape == (RFN, H // 4, W // 4, 32)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)


def test_init_net_magnifies_the_volume_rounding(init_tree, volume):
    """Why the port is handed JAX's volume: JAX's own G' moves by more
    than 1e-3 when its depth map moves by one f32 ulp, and the port on its
    own volume (a few ulps from JAX's) is no further from JAX than 4x
    that."""
    ref, src = cv_scene()
    prob, depth = volume
    theirs = jax_init_net(init_tree, ref, src)
    nudged = jax_init_net(init_tree, ref, src, prob,
                          np.nextafter(depth, np.float32(np.inf)))
    moved = np.abs(nudged - theirs).max()
    with torch.no_grad():
        own = port(CV.CostVolumeInitNet(64), init_tree)(tt(ref), tt(src))
    err = np.abs(own.numpy() - theirs).max()
    print(f"JAX's G' moved by {moved:.3g} for one ulp of its depth; the "
          f"port on its own volume is {err:.3g} from JAX")
    assert moved > 1e-3
    assert err <= 4 * moved


def test_initialize_ray_feats_needs_src(weights):
    renderer = port(R.NeurayRenderer(R.RenderConfig(**CFG)),
                    weights["params"])
    ref, _ = cv_scene()
    with pytest.raises(ValueError, match="src"):
        renderer.initialize_ray_feats(tt(ref))


@pytest.fixture(scope="module")
def render_inputs():
    ref, src = cv_scene()
    que = make_query(np.random.RandomState(8), H, W, 0, full_image=True)
    del que["imgs"]
    # rays through the image centre (the top rows are background)
    start = (H * W - N_RAYS) // 2
    que["coords"] = que["coords"][:, start:start + N_RAYS]
    return ref, src, que


KEEP = ("pixel_colors_nr", "pixel_colors_nr_fine", "render_depth",
        "render_depth_fine", "ray_mask")


@pytest.fixture(scope="module")
def renders(sharp, render_inputs):
    ref, src, que = render_inputs
    jr = jR.NeurayRenderer(jR.RenderConfig(**CFG))
    theirs = jR.render_full(jr, sharp, jx(ref), jx(que), jx(src), KEEP)
    renderer = port(R.NeurayRenderer(R.RenderConfig(**CFG)),
                    sharp["params"])
    ours = R.render_full(renderer, tt(ref), tt(que), KEEP, tt(src))
    return ({k: v.numpy() for k, v in ours.items()},
            {k: np.asarray(v) for k, v in theirs.items()})


@pytest.mark.parametrize("key", KEEP)
def test_cost_volume_render_full_matches_jax(renders, key):
    """Every output of the cost-volume render through ``render_full``
    with src, on ``SHARP``, at 1e-4, the ray mask exactly; the renders are
    finite and hit the sphere."""
    ours, theirs = renders
    assert ours[key].shape == theirs[key].shape
    assert ours[key].shape[:2] == (1, N_RAYS)
    if key == "ray_mask":
        np.testing.assert_array_equal(ours[key], theirs[key])
        return
    assert np.isfinite(ours[key]).all()
    np.testing.assert_allclose(ours[key], theirs[key], rtol=0, atol=1e-4)
    if key.startswith("pixel"):
        assert ours[key].max() > 0.3


# ---------------- the training forward's gradients ----------------

TRAIN_CFG = dict(
    init_net_type="cost_volume", use_hierarchical_sampling=True,
    depth_sample_num=8, fine_depth_sample_num=8, ray_batch_num=32,
    ray_mask_point_num=4, use_depth_loss=True,
    dist_decoder_cfg={"use_vis": False},
    fine_dist_decoder_cfg={"use_vis": False}, loss=["render", "depth"],
    use_nr_fine_loss=True)
TRAIN_DATA = {"rfn": RFN, "h": H, "w": W, "train_ray_num": 32,
              "depth_loss_coords_num": 8}


def train_sample():
    """A synthetic training sample with src views (the refs) and nn_ids,
    its 32 query rays moved onto the sphere (ROADMAP Queue 3, fault 3)."""
    s = jD.SyntheticRendererDataset(TRAIN_DATA, True)[0]
    del s["scene_name"]
    rng = np.random.RandomState(0)
    ys, xs = np.nonzero(s["que"]["imgs"][0].sum(-1) > 0)
    pick = rng.choice(ys.size, TRAIN_DATA["train_ray_num"], replace=False)
    s["que"]["coords"] = np.stack([xs[pick], ys[pick]], -1)[None].astype(
        np.float32)
    s["ref"]["nn_ids"] = nearest_others(s["ref"]["poses"], NN)
    s["src"] = {k: s["ref"][k] for k in ("imgs", "poses", "Ks",
                                         "depth_range")}
    return s


@pytest.fixture(scope="module")
def grads(sharp):
    """JAX's jitted value_and_grad of the training loss with src (its fine
    draws u captured inside) and the port's on the same inputs and u."""
    captured = []
    orig = jS.sample_fine_depth

    def capture(depth, hit_prob, dr, fdn, random_sample, rng=None,
                inv_mode=True):
        if random_sample:
            captured.append(jax.random.uniform(
                rng, (*hit_prob.shape[:-1], fdn)))
        return orig(depth, hit_prob, dr, fdn, random_sample, rng, inv_mode)

    jr = jR.NeurayRenderer(jR.RenderConfig.from_cfg(TRAIN_CFG))
    jloss = jL.build_losses(TRAIN_CFG)

    def total(params, batch, rng):
        captured.clear()
        out = jr.apply(params, batch["ref"], batch["que"], True,
                       batch["depth_loss_coords"], batch["src"],
                       rngs={"sample": rng})
        losses = jloss(out, batch)
        return sum(jnp.mean(v) for k, v in losses.items()
                   if k.startswith("loss")), (out, captured[-1])

    sample = train_sample()
    batch = jax.tree.map(jnp.asarray, sample)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jS, "sample_fine_depth", capture)
        (tot, (out, u)), g = jax.jit(jax.value_and_grad(
            total, has_aux=True))(sharp, batch, jax.random.PRNGKey(0))

    renderer = R.NeurayRenderer(R.RenderConfig.from_cfg(TRAIN_CFG))
    load_flax_params(renderer, sharp)
    renderer.train()
    tb = jax.tree.map(t, sample)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R.NeurayRenderer, "draw_fine_u", staticmethod(
            lambda shape, device, generator: t(u)))
        p_out = renderer(tb["ref"], tb["que"], True, tb["depth_loss_coords"],
                         None, tb["src"])
        losses = L.build_losses(TRAIN_CFG)(p_out, tb)
        p_tot = sum(v.mean() for k, v in losses.items()
                    if k.startswith("loss"))
        p_tot.backward()
    named = dict(renderer.named_parameters())
    p_grads = torch_to_flax(renderer, {
        n: torch.zeros_like(p) if p.grad is None else p.grad
        for n, p in named.items()})
    return {"jax": (float(tot), out, g), "port": (p_tot.item(), p_out,
                                                  p_grads),
            "no_grad": {n for n, p in named.items() if p.grad is None}}


def test_training_forward_matches_jax(grads):
    (tot_j, out_j, _), (tot_p, out_p, _) = grads["jax"], grads["port"]
    for k in ("pixel_colors_nr", "pixel_colors_nr_fine", "depth_mean",
              "depth_mean_fine"):
        np.testing.assert_allclose(out_p[k].detach().numpy(),
                                   np.asarray(out_j[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    assert tot_p == pytest.approx(tot_j, abs=1e-4)


def test_training_gradients_match_jax(grads):
    assert compare_grad_trees(grads["port"][2], grads["jax"][2]) == 431


def test_mvsnet_gradients_are_exactly_zero_in_both(grads):
    """MVSNet is frozen: JAX's stop_gradient gives its leaves exact zeros,
    the port builds the volume without autograd (no gradient at all);
    the rest of the init net trains."""
    for tree in (grads["jax"][2], grads["port"][2]):
        init = tree["params"]["init_net"]
        assert all(np.all(np.asarray(g) == 0)
                   for g in jax.tree.leaves(init["mvsnet"]))
        rest = {k: v for k, v in init.items() if k != "mvsnet"}
        assert any(np.abs(np.asarray(g)).max() > 0
                   for g in jax.tree.leaves(rest))
    assert grads["no_grad"] == {n for n, _ in R.NeurayRenderer(
        R.RenderConfig.from_cfg(TRAIN_CFG)).named_parameters()
        if n.startswith("init_net.mvsnet.")}


def test_trainer_passes_src_to_the_forward(monkeypatch):
    """``Trainer._losses`` hands the sample's src views to the renderer, as
    the JAX train step does."""
    from neuray_tpu_torch.train.trainer import Trainer
    seen = {}

    class Stub(torch.nn.Module):
        def forward(self, ref, que, is_train, depth_loss_coords, generator,
                    src, fine_u=None):
            seen.update(src=src, ref=ref)
            return {}

    trainer = Trainer.__new__(Trainer)
    trainer.renderer, trainer.generator = Stub(), None
    trainer.loss_fn = lambda outputs, batch: {"loss": torch.zeros(())}
    batch = {"ref": {"imgs": torch.zeros(1)}, "que": {},
             "src": {"imgs": torch.ones(1)}}
    trainer._losses(batch)
    assert seen["src"] is batch["src"]


# ---------------- bf16 + u8 ----------------

BF16_KEEP = ("pixel_colors_nr", "pixel_colors_nr_fine", "render_depth_fine")


@pytest.fixture(scope="module")
def jax_f32_render(sharp, render_inputs):
    ref, src, que = render_inputs
    jr = jR.NeurayRenderer(jR.RenderConfig(**CFG))
    return jR.render_full(jr, sharp, jx(ref), jx(que), jx(src), BF16_KEEP)


@pytest.mark.parametrize("mode", list(MODES))
def test_bf16_cost_volume_render_is_held(sharp, render_inputs,
                                         jax_f32_render, mode):
    """The cost-volume render on the bf16 (and bf16 + u8) route, on
    ``SHARP`` (with the shipped MVSNet, bf16 rounding of the flat volume
    moves JAX's own colours by up to 0.97): the port in bf16 against the
    JAX package in f32, within 1.5x of JAX bf16's own error
    (``tests/test_torch_port_bf16.py: held``)."""
    ref, src, que = render_inputs
    jr = jR.NeurayRenderer(jR.RenderConfig(**CFG, **MODES[mode]))
    theirs = jR.render_full(jr, sharp, jx(ref), jx(que), jx(src),
                            BF16_KEEP)
    renderer = port(R.NeurayRenderer(R.RenderConfig(**CFG, **MODES[mode])),
                    sharp["params"])
    ref_c = R.encode_ref(renderer, tt(ref), tt(src))
    want = torch.uint8 if mode == "bf16+u8" else torch.bfloat16
    assert ref_c["feats"].dtype == want
    ours = R.render_rays(renderer, ref_c, tt(que), BF16_KEEP)
    for k in BF16_KEEP:
        held(f"{mode} cost volume {k}", ours[k], theirs[k],
             jax_f32_render[k])
