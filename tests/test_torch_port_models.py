"""Parity of the PyTorch port's model modules (``neuray_tpu_torch.models``)
with the JAX package's flax modules, on the trained weights of
``tools/bench_weights.npz`` put through the weight bridge.

Tolerance: 1e-4 absolute (plus 1e-4 relative) on f32. The JAX side runs
un-jitted ``apply`` at "highest" matmul and conv precision, at small
spatial sizes (2-3 views, up to 64x64).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuray_tpu.data.synthetic import make_sphere_scene
from neuray_tpu.models import agg_net as jA
from neuray_tpu.models import blocks as jB
from neuray_tpu.models import dist_decoder as jD
from neuray_tpu.models import ibrnet as jR
from neuray_tpu.models import init_net as jN
from neuray_tpu.models import resunet as jU
from neuray_tpu.models import vis_encoder as jV
from neuray_tpu.utils.params_io import load_params_npz as j_load_params_npz

from neuray_tpu_torch.models import agg_net as A
from neuray_tpu_torch.models import blocks as B
from neuray_tpu_torch.models import dist_decoder as D
from neuray_tpu_torch.models import ibrnet as R
from neuray_tpu_torch.models import init_net as N
from neuray_tpu_torch.models import resunet as U
from neuray_tpu_torch.models import vis_encoder as V
from neuray_tpu_torch.models.renderer import NeurayRenderer, RenderConfig
from neuray_tpu_torch.utils.params import (
    flax_to_torch, load_flax_params, load_params_npz)

torch.set_num_threads(1)

WEIGHTS = Path(__file__).resolve().parents[1] / "tools" / "bench_weights.npz"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def W():
    return load_params_npz(str(WEIGHTS))["params"]


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(ours, theirs, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               **(tol or TOL))


def sub(tree, path):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def port(module, tree):
    load_flax_params(module, tree)
    return module.eval()


def nchw(x):
    return t(x).permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


# ---------------- weights and the bridge ----------------

def test_load_params_npz_matches_jax_loader():
    ours = load_params_npz(str(WEIGHTS))
    theirs = j_load_params_npz(str(WEIGHTS))
    leaves = dict(jax.tree_util.tree_flatten_with_path(theirs)[0])
    assert len(leaves) == 294
    for path, arr in leaves.items():
        node = ours
        for p in path:
            node = node[p.key]
        assert node.dtype == np.float32
        np.testing.assert_array_equal(node, arr)


def test_bridge_consumes_every_leaf_once(W):
    r = NeurayRenderer(RenderConfig(
        use_hierarchical_sampling=True, use_vis=False, fine_use_vis=False))
    state = flax_to_torch({"params": W})
    assert len(state) == 294
    assert len(r.state_dict()) == 294
    load_flax_params(r, {"params": W})
    for k, v in r.state_dict().items():
        assert torch.equal(v, state[k]), k
    n_params = sum(v.numel() for v in state.values())
    assert 3.0e6 < n_params < 3.2e6


def test_bridge_raises_on_extra_or_missing_leaf(W):
    enc = V.DefaultVisEncoder()
    tree = dict(W["vis_encoder"])
    with pytest.raises(ValueError, match="left over"):
        load_flax_params(enc, {**tree, "extra": {"bias": np.zeros(3)}})
    del tree["conv_out"]
    with pytest.raises(ValueError, match="missing"):
        load_flax_params(enc, tree)
    with pytest.raises(ValueError, match="unknown leaf"):
        flax_to_torch({"fc": {"kernel": np.zeros(3)}})


# ---------------- blocks ----------------

def test_instance_norm(W):
    x = np.random.RandomState(0).randn(2, 9, 11, 16).astype(np.float32) * 3
    tree = W["image_encoder"]["bn1"]
    ours = port(B.InstanceNorm(16), tree)(nchw(x))
    close(nhwc(ours), jB.InstanceNorm(16).apply({"params": tree}, x))


@pytest.mark.parametrize("path,cin,cout,k,s,pad,bias", [
    ("image_encoder/layer1/block0/conv1", 16, 32, 3, 2, None, False),
    ("image_encoder/conv1", 3, 16, 7, 2, 3, False),
    ("init_net/res_net/conv1", 12, 32, 8, 2, 2, False),    # even 8x8
    ("init_net/depth_skip_0", 1, 8, 2, 2, 0, True),        # even 2x2
])
def test_reflect_conv(W, path, cin, cout, k, s, pad, bias):
    x = np.random.RandomState(1).randn(2, 13, 11, cin).astype(np.float32)
    tree = sub(W, path)
    tree = tree.get("Conv_0", tree)
    ours = port(B.ReflectConv(cin, cout, k, s, pad, bias), tree)(nchw(x))
    theirs = jB.ReflectConv(cout, (k, k), (s, s), pad, bias).apply(
        {"params": {"Conv_0": tree}}, x)
    close(nhwc(ours), theirs)


@pytest.mark.parametrize("path,cin,planes,stride,down", [
    ("image_encoder/layer1/block0", 16, 32, 2, True),
    ("image_encoder/layer2/block1", 64, 64, 1, False),
])
def test_basic_block(W, path, cin, planes, stride, down):
    x = np.random.RandomState(2).randn(2, 9, 10, cin).astype(np.float32)
    tree = sub(W, path)
    ours = port(B.BasicBlock(cin, planes, stride, down), tree)(nchw(x))
    theirs = jB.BasicBlock(planes, stride, down).apply({"params": tree}, x)
    close(nhwc(ours), theirs)


def test_residual_block(W):
    x = np.random.RandomState(3).randn(2, 8, 7, 32).astype(np.float32)
    tree = W["vis_encoder"]["res0"]
    ours = port(B.ResidualBlock(32, 32), tree)(nchw(x))
    close(nhwc(ours), jB.ResidualBlock(32).apply({"params": tree}, x))


def test_conv_elu_and_upconv(W):
    x = np.random.RandomState(4).randn(2, 5, 6, 128).astype(np.float32)
    tree = W["image_encoder"]["iconv3"]
    ours = port(B.ConvELU(128, 64), tree)(nchw(x))
    close(nhwc(ours), jB.ConvELU(64).apply({"params": tree}, x))
    tree = W["image_encoder"]["upconv3"]
    ours = port(B.UpConv(128, 64), tree)(nchw(x))
    close(nhwc(ours), jB.UpConv(64).apply({"params": tree}, x))


def test_upsample2x_align_corners():
    x = np.random.RandomState(5).randn(2, 5, 7, 3).astype(np.float32)
    close(nhwc(B.upsample2x_align_corners(nchw(x))),
          jB.upsample2x_align_corners(jnp.asarray(x)))


# ---------------- resunet ----------------

def test_skip_pad_concat():
    rng = np.random.RandomState(6)
    up = rng.randn(1, 6, 12, 2).astype(np.float32)
    skip = rng.randn(1, 5, 9, 3).astype(np.float32)
    close(nhwc(U._skip_pad_concat(nchw(up), nchw(skip))),
          jU._skip_pad_concat(up, skip), rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(64, 64), (44, 36)])   # 44x36 pads skips
def test_resunet_light(W, hw):
    """Not at 32x32: there layer3 is 2x2, its InstanceNorm over 4 pixels
    amplifies f32 rounding, and both packages land 4.4e-4 from a float64
    run of the same net (2e-5 at 64x64)."""
    x = np.random.RandomState(7).rand(2, *hw, 3).astype(np.float32)
    tree = W["image_encoder"]
    ours = port(U.ResUNetLight(3, (1, 2, 6, 4), 32, 16), tree)(t(x))
    theirs = jU.ResUNetLight(3, (1, 2, 6, 4), 32, 16).apply(
        {"params": tree}, x)
    close(ours, theirs)


def test_res_encoder(W):
    x = np.random.RandomState(8).rand(2, 32, 32, 12).astype(np.float32)
    tree = W["init_net"]["res_net"]
    close(port(U.ResEncoder(), tree)(t(x)),
          jU.ResEncoder().apply({"params": tree}, x))


# ---------------- init net ----------------

@pytest.fixture(scope="module")
def scene():
    return make_sphere_scene(np.random.RandomState(0), 3, 32, 32)


def test_init_net_functions(scene):
    dr, depth = scene["depth_range"], scene["depth"]
    depth_n = N.extract_depth_for_init(t(dr), t(depth))
    close(depth_n, jN.extract_depth_for_init(dr, depth))
    close(N.depth2pts3d(t(depth), t(scene["Ks"]), t(scene["poses"])),
          jN.depth2pts3d(depth, scene["Ks"], scene["poses"]))
    dn = depth_n.numpy()
    ours = N.get_diff_feats(t(scene["imgs"]), depth_n, t(dr),
                            t(scene["poses"]), t(scene["Ks"]))
    theirs = jN.get_diff_feats(scene["imgs"], dn, dr, scene["poses"],
                               scene["Ks"])
    assert ours.shape == (3, 32, 32, 8)
    close(ours, theirs)


def test_depth_init_net(W, scene):
    tree = W["init_net"]
    ref_t = {k: t(v) for k, v in scene.items()}
    ours = port(N.DepthInitNet(), tree)(ref_t)
    theirs = jN.DepthInitNet({"diff_scale": 1}).apply(
        {"params": tree}, scene)
    assert ours.shape == (3, 8, 8, 32)
    close(ours, theirs)
    # diff_scale changes only the eval grid, not the parameters
    assert (N.DepthInitNet(diff_scale=2).state_dict().keys()
            == N.DepthInitNet().state_dict().keys())


# ---------------- vis encoder / dist decoder ----------------

def test_vis_encoder(W):
    rng = np.random.RandomState(9)
    ray, img = (rng.randn(2, 8, 8, 32).astype(np.float32) for _ in range(2))
    tree = W["vis_encoder"]
    close(port(V.DefaultVisEncoder(), tree)(t(ray), t(img)),
          jV.DefaultVisEncoder().apply({"params": tree}, ray, img))


@pytest.mark.parametrize("use_vis", [False, True])
def test_dist_decoder(W, use_vis):
    """use_vis=False with the trained heads; use_vis=True (a fourth,
    vis head) with the flax module's own random init."""
    feats = np.random.RandomState(10).randn(3, 1, 5, 8, 32).astype(
        np.float32)
    jmod = jD.MixtureLogisticsDistDecoder({"use_vis": use_vis})
    tree = (jmod.init(jax.random.PRNGKey(0), feats)["params"] if use_vis
            else W["dist_decoder"])
    ours = port(D.MixtureLogisticsDistDecoder(use_vis), tree)(t(feats))
    theirs = jmod.apply({"params": tree}, feats)
    for a, b in zip(ours, theirs):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == torch.float32
            close(a, b)


# ---------------- ibrnet / agg net ----------------

def test_sinusoid_pos_encoding():
    np.testing.assert_array_equal(R.sinusoid_pos_encoding(16, 64),
                                  jR.sinusoid_pos_encoding(16, 64))


def test_multi_head_attention_mask_quirk(W):
    """The [b, l, 1] mask blanks query rows; both packages agree, and a
    masked row's output differs from what masking keys would give."""
    rng = np.random.RandomState(11)
    x = rng.randn(4, 8, 16).astype(np.float32)
    mask = (rng.rand(4, 8, 1) > 0.3).astype(np.float32)
    mask[0, :2] = 0.0
    tree = W["agg_net"]["agg_impl"]["ray_attention"]
    ours = port(R.MultiHeadAttention(4, 16, 4, 4), tree)(t(x), t(mask))
    theirs, _ = jR.MultiHeadAttention(4, 16, 4, 4).apply(
        {"params": tree}, x, x, x, mask)
    close(ours, theirs)


def _agg_inputs(rng, rfn=3, b=4, dn=8):
    mask = (rng.rand(rfn, b, dn, 1) > 0.3).astype(np.float32)
    mask[:, 0, 0] = 0.0                           # no view sees it
    mask[:, 0, 1] = 0.0
    mask[0, 0, 1] = 1.0                           # exactly one view
    return mask


def test_ibrnet_with_neuray_view_major(W):
    rng = np.random.RandomState(12)
    rfn, b, dn = 3, 4, 8
    rgb_feat = rng.rand(rfn, b, dn, 35).astype(np.float32)
    neuray = rng.randn(rfn, b, dn, 32).astype(np.float32)
    ray_diff = rng.randn(rfn, b, dn, 4).astype(np.float32) * 0.3
    mask = _agg_inputs(rng, rfn, b, dn)
    tree = W["agg_net"]["agg_impl"]
    ours = port(R.IBRNetWithNeuRay(32, n_samples=64), tree)(
        t(rgb_feat), t(neuray), t(ray_diff), t(mask))
    theirs = jR.IBRNetWithNeuRay(32, n_samples=64, view_major=True).apply(
        {"params": tree}, rgb_feat, neuray, ray_diff, mask)
    assert ours.shape == (b, dn, 4)
    close(ours, theirs)


def test_aggregation_net(W):
    rng = np.random.RandomState(13)
    rfn, qn, rn, dn = 3, 1, 4, 8
    shape = (rfn, qn, rn, dn)
    prj_dir = rng.randn(*shape, 3)
    que_dir = rng.randn(qn, rn, dn, 3)
    prj = {
        "ray_feats": rng.randn(*shape, 32), "img_feats": rng.randn(*shape, 32),
        "hit_prob": rng.rand(*shape, 1), "vis": rng.rand(*shape, 1),
        "rgb": rng.rand(*shape, 3),
        "dir": prj_dir / np.linalg.norm(prj_dir, axis=-1, keepdims=True),
        "mask": _agg_inputs(rng, rfn, rn, dn)[:, None],
    }
    prj = {k: v.astype(np.float32) for k, v in prj.items()}
    que_dir = (que_dir / np.linalg.norm(que_dir, axis=-1, keepdims=True)
               ).astype(np.float32)
    close(A.get_dir_diff(t(prj["dir"]), t(que_dir)),
          jA.get_dir_diff(prj["dir"], que_dir, view_major=True))
    tree = W["agg_net"]
    density, colors = port(A.DefaultAggregationNet(32, 64), tree)(
        {k: t(v) for k, v in prj.items()}, t(que_dir))
    jdensity, jcolors = jA.DefaultAggregationNet(
        {"neuray_dim": 32, "sample_num": 64}).apply(
            {"params": tree}, prj, que_dir)
    close(density, jdensity)
    close(colors, jcolors)


# ---------------- the port's copy of the synthetic scene ----------------

@pytest.mark.parametrize("full_image", [True, False])
def test_synthetic_scene_equals_jax_packages(full_image):
    from neuray_tpu.data import synthetic as jS
    from neuray_tpu_torch.data import synthetic as S
    ours_rng, their_rng = np.random.RandomState(4), np.random.RandomState(4)
    for a, b in ((S.make_sphere_scene(ours_rng, 3, 24, 32),
                  jS.make_sphere_scene(their_rng, 3, 24, 32)),
                 (S.make_query(ours_rng, 24, 32, 50, full_image),
                  jS.make_query(their_rng, 24, 32, 50, full_image))):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
