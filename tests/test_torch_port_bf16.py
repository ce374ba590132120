"""The port's bf16 compute and u8 gather map (``use_bf16``,
``gather_quant="u8"``) against the JAX package's, module by module and
for the render slice, on the trained ``tools/bench_weights.npz``.

bf16 rounds at different places in the two libraries, so the lossy
modes are held by a rule, not a tolerance (``held``): on the same
inputs, the JAX package in bf16 is compared with the JAX package in f32
(its own error), and the port in bf16 with the same f32 result. The
port's error must be within 1.5x of JAX's own, in mean and in max abs;
the direct difference of the two bf16 results is printed and must be
within 2x of JAX's own error (two roundings of the same computation).
The u8 quantization is exact: the port's codes, scales and offsets
equal JAX's bit for bit.

Scene: the synthetic sphere, 3 reference views at 32x32, a full-image
query, 8 + 8 samples, a 4-sample probe, 6 + 6 focus samples, 64-ray
chunks. JAX runs at "highest" matmul precision.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from neuray_tpu.data.synthetic import make_query, make_sphere_scene
from neuray_tpu.models import agg_net as jA
from neuray_tpu.models import dist_decoder as jD
from neuray_tpu.models import init_net as jN
from neuray_tpu.models import renderer as jR
from neuray_tpu.models import resunet as jU
from neuray_tpu.models import vis_encoder as jV
from neuray_tpu.ops import interpolate as jI
from neuray_tpu.ops import sampling as jS

from neuray_tpu_torch.models import agg_net as A
from neuray_tpu_torch.models import dist_decoder as D
from neuray_tpu_torch.models import init_net as N
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.models import resunet as U
from neuray_tpu_torch.models import vis_encoder as V
from neuray_tpu_torch.ops import gather as GA
from neuray_tpu_torch.ops import interpolate as I
from neuray_tpu_torch.utils.params import load_flax_params, load_params_npz

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BF = torch.bfloat16
JBF = jnp.bfloat16
H = W = 32
CFG = dict(use_hierarchical_sampling=True, depth_sample_num=8,
           fine_depth_sample_num=8, ray_batch_num=64, probe_sample_num=4,
           focus_sample_num=6, focus_fine_sample_num=6, use_vis=False,
           fine_use_vis=False, ray_mask_point_num=4, render_depth=True)
MODES = {"bf16": dict(use_bf16=True),
         "bf16+u8": dict(use_bf16=True, gather_quant="u8")}
KEEP = ("pixel_colors_nr", "pixel_colors_nr_fine", "hit_prob_nr",
        "render_depth", "render_depth_fine")
TH = 0.01


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def f32(x):
    if isinstance(x, torch.Tensor):
        return R._host(x).astype(np.float32)
    return np.asarray(x, np.float32)


def held(name, port, jax_bf16, jax_f32):
    """The lossy-mode rule (module docstring); returns the direct
    difference's max."""
    p, b, f = f32(port), f32(jax_bf16), f32(jax_f32)
    assert p.shape == b.shape == f.shape, name
    ej, ep, d = np.abs(b - f), np.abs(p - f), np.abs(p - b)
    print(f"{name}: JAX bf16 vs f32 mean {ej.mean():.3g} max {ej.max():.3g}"
          f"; port bf16 vs JAX f32 mean {ep.mean():.3g} max {ep.max():.3g}"
          f"; port vs JAX bf16 mean {d.mean():.3g} max {d.max():.3g}")
    assert np.isfinite(p).all(), name
    assert ep.mean() <= 1.5 * ej.mean(), name
    assert ep.max() <= 1.5 * ej.max(), name
    assert d.mean() <= 2 * ej.mean() and d.max() <= 2 * ej.max(), name
    return d.max()


@pytest.fixture(scope="module")
def params():
    return load_params_npz(str(ROOT / "tools" / "bench_weights.npz"))


def port(module, tree):
    load_flax_params(module, tree)
    return module.eval()


# ---------------- u8 quantization and the u8 gather ----------------

def _u8_inputs():
    rng = np.random.RandomState(3)
    feats = rng.randn(3, 8, 8, 64).astype(np.float32)
    feats[..., 4] *= 1e-3                          # a narrow channel
    feats[..., 5] = 0.0                            # absmax 0: the 1e-8 floor
    feats = np.asarray(feats.astype(JBF), np.float32)   # bf16 values
    imgs = rng.rand(3, H, W, 3).astype(np.float32)
    imgs[0, 0, :4, 0] = np.asarray([0.5, 1.5, 2.5, 254.5]) / 255.0  # ties
    return feats, imgs


def test_quantize_u8_equals_jax():
    feats, imgs = _u8_inputs()
    fused, scale, offset = jI.make_fused_scene_map_u8(
        jnp.asarray(imgs), jnp.asarray(feats), H, W)
    codes, pscale, poffset = I.quantize_u8(t(feats).to(BF))
    assert codes.dtype == torch.uint8 and pscale.dtype == BF
    fused = np.asarray(fused)
    c = codes.numpy()
    quad = np.concatenate([c[:, :-1, :-1], c[:, :-1, 1:], c[:, 1:, :-1],
                           c[:, 1:, 1:]], -1)
    np.testing.assert_array_equal(fused[..., :64], c[:, :-1, :-1])
    np.testing.assert_array_equal(fused[..., :256], quad)
    np.testing.assert_array_equal(f32(pscale), np.asarray(scale, np.float32))
    np.testing.assert_array_equal(f32(poffset),
                                  np.asarray(offset, np.float32))
    # the rgb patch of every fused row, read from the port's u8 image
    rgb = I.image_to_u8(t(imgs)).numpy()
    base_x = np.asarray(jI._patch_base(jnp.arange(7), (W - 1) / 8, W, 7))
    base_y = np.asarray(jI._patch_base(jnp.arange(7), (H - 1) / 8, H, 7))
    iy = (base_y[:, None] + np.arange(7)).astype(int)       # cell, dy
    ix = (base_x[:, None] + np.arange(7)).astype(int)
    # n, ky, kx, dy, dx, 3
    patch = rgb[:, iy[:, None, :, None], ix[None, :, None, :]]
    patch = patch.transpose(0, 1, 2, 5, 3, 4).reshape(3, 7, 7, 147)
    np.testing.assert_array_equal(fused[..., 256:], patch)
    assert rgb[0, 0, :4, 0].tolist() == [0, 2, 2, 254]       # half to even


def test_gather_u8_matches_jax_fused_u8():
    """The plain u8 gather (the kernel's twin) on the port's codes
    against ``gather_bilinear_fused_u8`` on JAX's fused rows, within
    JAX's own budget (tests/test_interpolate.py): two quantization steps
    per feature channel, 1.5/255 for rgb. Both are also held to that
    budget against the f32 bilinear gathers."""
    feats, imgs = _u8_inputs()
    rng = np.random.RandomState(4)
    pts = (rng.rand(3, 500, 2) * [W + 8, H + 8] - 4).astype(np.float32)
    pts[:, :4] = [[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0]]
    fused, scale, offset = jI.make_fused_scene_map_u8(
        jnp.asarray(imgs), jnp.asarray(feats), H, W)
    jfeats, jrgb = jI.gather_bilinear_fused_u8(fused, scale, offset,
                                               jnp.asarray(pts), H, W)
    ref_c = R.NeurayRenderer.build_gather_cache(
        {"imgs": t(imgs), "ray_feats": t(feats[..., :32]),
         "img_feats": t(feats[..., 32:])}, True, "u8")
    assert ref_c["feats"].dtype == ref_c["rgb_map"].dtype == torch.uint8
    ones = torch.ones(3, 500)
    before = GA.LAUNCHES
    ours = I.interpolate_feature_map(
        ref_c["feats"], t(pts), ones, H, W,
        (ref_c["feats_scale"], ref_c["feats_offset"]))
    ours_rgb = I.interpolate_feature_map(
        ref_c["rgb_map"], t(pts), ones, H, W,
        (ref_c["rgb_scale"], ref_c["rgb_offset"]))
    assert GA.LAUNCHES == before and ours.dtype == ours_rgb.dtype == BF
    step = np.asarray(scale, np.float32)
    want = np.asarray(jI.grid_sample_nhwc(feats, pts, H, W, "border", False))
    want_rgb = np.asarray(jI.grid_sample_nhwc(
        np.round(imgs * 255) / 255, pts, H, W, "border", True))
    for got in (f32(ours), np.asarray(jfeats, np.float32)):
        assert (np.abs(got - want) <= 2 * step + 0.02).all()
    assert (np.abs(f32(ours) - np.asarray(jfeats, np.float32))
            <= 2 * step + 0.02).all()
    for got in (f32(ours_rgb), np.asarray(jrgb, np.float32)):
        np.testing.assert_allclose(got, want_rgb, rtol=0, atol=1.5 / 255)
    np.testing.assert_allclose(f32(ours_rgb), np.asarray(jrgb, np.float32),
                               rtol=0, atol=1.5 / 255)


def test_gather_u8_ref_is_the_f32_lerp_dequantized():
    rng = np.random.RandomState(5)
    codes = torch.from_numpy(
        rng.randint(0, 256, (2, 5, 7, 6)).astype(np.uint8))
    coords = t(rng.rand(2, 40, 2) * [9, 7] - 1)
    scale, offset = t(rng.rand(6) * 0.1), t(rng.rand(6))
    want = (GA.gather_bilinear_border_ref(codes.float(), coords) * scale
            - offset).to(BF)
    got = GA.gather_bilinear_border_u8(codes, coords, scale, offset)
    assert torch.equal(got, want)
    bad = [(codes.float(), coords, scale, offset),          # not u8
           (codes, coords, scale.double(), offset),         # scale dtype
           (codes, coords, scale[:5], offset),              # scale shape
           (codes, coords, scale, offset.reshape(2, 3))]     # offset shape
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            GA.gather_bilinear_border_u8(*args)
    with pytest.raises(TypeError):          # u8 needs the dequant
        GA.gather_bilinear_border(codes, coords)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gather_u8_kernel_matches_ref_on_cuda(cuda_device):
    """The kernel rounds its f32 arithmetic op for op as the plain twin
    does; the bound is one bf16 ulp of the output."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for c in (3, 64):
        codes = torch.randint(0, 256, (2, 9, 13, c), generator=g,
                              device=cuda_device, dtype=torch.uint8)
        coords = torch.rand((2, 1001, 2), generator=g, device=cuda_device)
        coords = coords * torch.tensor([19.0, 15.0], device=cuda_device) - 3
        scale = torch.rand(c, generator=g, device=cuda_device) / 127
        offset = scale * 128
        before = GA.LAUNCHES
        out = GA.gather_bilinear_border_u8(codes, coords, scale, offset)
        torch.cuda.synchronize()
        assert GA.LAUNCHES == before + 1 and out.dtype == BF
        ref = GA.gather_bilinear_border_u8_ref(codes, coords, scale, offset)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -8,
                                   atol=1e-6)


# ---------------- modules ----------------

def test_image_encoder(params):
    """At 64x64: at 32x32 layer3 is 2x2 and its InstanceNorm amplifies
    rounding (as in the f32 test)."""
    x = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32)
    tree = params["params"]["image_encoder"]
    net = jU.ResUNetLight(3, (1, 2, 6, 4), 32, 16)
    jf = net.apply({"params": tree}, x)
    jb = net.clone(dtype=JBF).apply({"params": tree}, x)
    with torch.inference_mode():
        ours = port(U.ResUNetLight(3, (1, 2, 6, 4), 32, 16, BF), tree)(t(x))
    assert ours.dtype == BF
    held("image encoder", ours, jb, jf)


@pytest.mark.parametrize("diff_scale", [1, 2])
def test_init_net(params, diff_scale):
    ref = make_sphere_scene(np.random.RandomState(0), 3, H, W)
    tree = params["params"]["init_net"]
    net = jN.DepthInitNet({"diff_scale": diff_scale})
    jf = jax.jit(net.apply)({"params": tree}, ref)
    jb = jax.jit(net.clone(dtype=JBF).apply)({"params": tree}, ref)
    with torch.inference_mode():
        ours = port(N.DepthInitNet(diff_scale, BF), tree)(
            {k: t(v) for k, v in ref.items()})
    assert ours.dtype == BF
    held(f"init net, diff_scale {diff_scale}", ours, jb, jf)


def test_vis_encoder(params):
    rng = np.random.RandomState(9)
    ray, img = (rng.randn(2, 8, 8, 32).astype(np.float32) for _ in range(2))
    tree = params["params"]["vis_encoder"]
    jf = jV.DefaultVisEncoder().apply({"params": tree}, ray, img)
    jb = jV.DefaultVisEncoder(dtype=JBF).apply({"params": tree}, ray, img)
    with torch.inference_mode():
        ours = port(V.DefaultVisEncoder(BF), tree)(t(ray), t(img))
    held("vis encoder", ours, jb, jf)


def test_dist_decoder(params):
    """On bf16 features, what the decoder sees on the bf16 route; its
    outputs are f32 in both packages."""
    feats = np.random.RandomState(10).randn(3, 1, 200, 8, 32).astype(JBF)
    tree = params["params"]["dist_decoder"]
    jf = jD.MixtureLogisticsDistDecoder({"use_vis": False}).apply(
        {"params": tree}, np.asarray(feats, np.float32))
    jb = jD.MixtureLogisticsDistDecoder({"use_vis": False}, dtype=JBF).apply(
        {"params": tree}, feats)
    with torch.inference_mode():
        ours = port(D.MixtureLogisticsDistDecoder(False, dtype=BF), tree)(
            t(np.asarray(feats, np.float32)).to(BF))
    for name, a, b, f in zip(("mean", "var", "vis", "aw"), ours, jb, jf):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == torch.float32 and b.dtype == jnp.float32
            held(f"dist decoder {name}", a, b, f)


@pytest.mark.parametrize("mode", ["pos_stride", "pos"])
def test_agg_net(params, mode):
    """The strided table (probe, exact passes: f32 attention input) and
    per-ray positions (focused passes: bf16 attention input), on bf16
    gathered features as on the bf16 route. 512 rays: on these random
    inputs most densities are 0 after the ReLU, and with 64 rays the few
    non-zero ones make the mean and max errors of either package swing
    by up to 1.9x between seeds."""
    rng = np.random.RandomState(13)
    shape = (3, 1, 512, 8)                                # rfn,qn,rn,dn
    prj_dir = rng.randn(*shape, 3)
    que_dir = rng.randn(*shape[1:], 3)
    prj = {"ray_feats": rng.randn(*shape, 32),
           "img_feats": rng.randn(*shape, 32),
           "hit_prob": rng.rand(*shape, 1), "vis": rng.rand(*shape, 1),
           "rgb": rng.rand(*shape, 3),
           "dir": prj_dir / np.linalg.norm(prj_dir, axis=-1, keepdims=True),
           "mask": rng.rand(*shape, 1) > 0.3}
    prj = {k: v.astype(np.float32) for k, v in prj.items()}
    gathered = ("ray_feats", "img_feats", "rgb")
    for k in gathered:
        prj[k] = np.asarray(prj[k].astype(JBF), np.float32)
    que_dir = (que_dir / np.linalg.norm(que_dir, axis=-1, keepdims=True)
               ).astype(np.float32)
    kw = ({"pos_stride": 4} if mode == "pos_stride" else
          {"pos": rng.uniform(0, 63, shape[1:]).astype(np.float32)})
    tree = params["params"]["agg_net"]
    jnet = jA.DefaultAggregationNet({"neuray_dim": 32, "sample_num": 64})
    jf = jax.jit(lambda p, x, d: jnet.apply(p, x, d, **kw))(
        {"params": tree}, prj, que_dir)
    jprj = {k: v.astype(JBF) if k in gathered else v for k, v in prj.items()}
    jb = jax.jit(lambda p, x, d: jnet.clone(dtype=JBF).apply(p, x, d, **kw))(
        {"params": tree}, jprj, que_dir)
    tprj = {k: t(v).to(BF) if k in gathered else t(v) for k, v in prj.items()}
    with torch.inference_mode():
        ours = port(A.DefaultAggregationNet(32, 64, BF), tree)(
            tprj, t(que_dir), **{k: t(v) if k == "pos" else v
                                 for k, v in kw.items()})
    for name, a, b, f in zip(("density", "colors"), ours, jb, jf):
        assert a.dtype == BF and b.dtype == JBF
        held(f"agg net {name} ({mode})", a, b, f)


# ---------------- the render slice ----------------

@pytest.fixture(scope="module")
def scene(params):
    rng = np.random.RandomState(7)
    ref = make_sphere_scene(rng, 3, H, W)
    que = make_query(rng, H, W, 0, full_image=True)
    del que["imgs"]
    return ref, que


class Side:
    """One mode in one package: the renderer and its own scene encode."""

    def __init__(self, pkg, params, scene, **over):
        ref, que = scene
        self.pkg, self.params = pkg, params
        cfg = {**CFG, **over}
        if pkg == "jax":
            self.r = jR.NeurayRenderer(jR.RenderConfig(**cfg))
            self.que = {k: jnp.asarray(v) for k, v in que.items()}
            self.ref_c = jR.make_scene_encode_fn(self.r)(
                params, {k: jnp.asarray(v) for k, v in ref.items()})
        else:
            self.r = R.NeurayRenderer(R.RenderConfig(**cfg))
            port(self.r, params)
            self.que = {k: torch.from_numpy(v) for k, v in que.items()}
            self.ref_c = R.encode_ref(self.r, {k: torch.from_numpy(v)
                                               for k, v in ref.items()})

    def rays(self, make_fn, port_fn, *args, keep=KEEP):
        if self.pkg == "jax":
            out = make_fn(self.r, keep)(self.params, self.ref_c, self.que,
                                        *args)
        else:
            out = port_fn(self.r, self.ref_c, self.que,
                          *(t(a) for a in args), keep)
        return {k: f32(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def sides(params, scene):
    cache = {}

    def get(pkg, mode="f32"):
        if (pkg, mode) not in cache:
            cache[pkg, mode] = Side(pkg, params, scene, **MODES.get(mode, {}))
        return cache[pkg, mode]

    return get


@pytest.mark.parametrize("mode", list(MODES))
def test_encode_maps(sides, mode):
    """The route each package takes, and the encoded maps under the
    rule."""
    jb, pb, jf = sides("jax", mode), sides("port", mode), sides("jax")
    assert ("fused_map_u8" in jb.ref_c) == (mode == "bf16+u8")
    want = torch.uint8 if mode == "bf16+u8" else BF
    assert pb.ref_c["feats"].dtype == pb.ref_c["rgb_map"].dtype == want
    for k in ("img_feats", "ray_feats"):
        held(f"{mode} encode {k}", pb.ref_c[k], jb.ref_c[k], jf.ref_c[k])


@pytest.mark.parametrize("mode", list(MODES))
def test_render_chunk(sides, mode):
    """The exact coarse + fine ray loop, each package on its own encode."""
    jf = sides("jax").rays(jR.make_ray_render_fn, R.render_rays)
    jb = sides("jax", mode).rays(jR.make_ray_render_fn, R.render_rays)
    pb = sides("port", mode).rays(jR.make_ray_render_fn, R.render_rays)
    for k in KEEP:
        held(f"{mode} render_chunk {k}", pb[k], jb[k], jf[k])


@pytest.fixture(scope="module")
def windows(sides):
    """JAX's f32 focus probe: the same windows and keep set for all."""
    jf = sides("jax")
    return tuple(np.asarray(x) for x in jR.make_focus_probe_fn(jf.r)(
        jf.params, jf.ref_c, jf.que))


@pytest.mark.parametrize("mode", list(MODES))
def test_render_chunk_focus(sides, windows, mode):
    _, near, far = windows
    args = (jR.make_focus_render_fn, R.render_focus_rays, near, far)
    jf = sides("jax").rays(*args)
    jb = sides("jax", mode).rays(*args)
    pb = sides("port", mode).rays(*args)
    for k in KEEP:
        held(f"{mode} render_chunk_focus {k}", pb[k], jb[k], jf[k])


@pytest.mark.parametrize("mode", list(MODES))
def test_render_frame_probe_focus(sides, mode):
    """``render_frame_probe_focus`` as bench.py calls it (probe stride 2,
    threshold 0.01, dilate 1), on JAX's f32 strided probe (the same keep
    set for all three)."""
    jf = sides("jax")
    probe = jR._strided_focus_probe(jR.make_focus_probe_fn(jf.r), jf.params,
                                    jf.ref_c, jf.que, TH, (H, W), 2)
    kw = dict(threshold=TH, keep_base=("pixel_colors_nr", "render_depth"),
              image_hw=(H, W), dilate=1, probe_stride=2, probe_out=probe)
    outs = {}
    for key, side in (("jf", jf), ("jb", sides("jax", mode))):
        outs[key] = jR.render_frame_probe_focus(side.r, side.params,
                                                side.ref_c, side.que, **kw)
    pb = sides("port", mode)
    outs["pb"] = R.render_frame_probe_focus(pb.r, pb.ref_c, pb.que, **kw)
    assert outs["pb"]["kept_rays"] == outs["jf"]["kept_rays"] > 0
    np.testing.assert_array_equal(outs["pb"]["keep_mask"],
                                  outs["jf"]["keep_mask"])
    for k in ("pixel_colors_nr", "pixel_colors_nr_fine", "render_depth",
              "render_depth_fine"):
        held(f"{mode} frame {k}", outs["pb"][k], outs["jb"][k],
             outs["jf"][k])
        assert (outs["pb"][k][0, ~outs["pb"]["keep_mask"]] == 0).all()


@pytest.mark.parametrize("mode", list(MODES))
def test_focus_probe(sides, mode):
    """Each package's own bf16 probe: scores under the rule (the probe
    composites in bf16 and scores in f32); keep decisions that differ
    from the f32 probe's are counted and printed, not held."""
    scores = {}
    for key, side in (("jf", sides("jax")), ("jb", sides("jax", mode))):
        scores[key] = np.asarray(jR.make_focus_probe_fn(side.r)(
            side.params, side.ref_c, side.que)[0])
    pb = sides("port", mode)
    score = R.focus_probe_rays(pb.r, pb.ref_c, pb.que)[0]
    assert score.dtype == torch.float32
    held(f"{mode} focus probe score", score, scores["jb"], scores["jf"])
    flips = {k: int(((v > TH) != (scores["jf"] > TH)).sum())
             for k, v in (("port", f32(score)), ("JAX", scores["jb"]))}
    print(f"{mode}: keep decisions differing from the f32 probe {flips}")


@pytest.mark.parametrize("mode", list(MODES))
def test_passes_on_the_same_inputs(sides, mode):
    """The coarse pass at the same depths and the fine pass at the same
    (JAX's) fine depths, from the same maps (JAX's encode; the port
    quantizes it to the same codes): the per-pass colour difference of
    two bf16 implementations of the same computation, held to the bound
    of chip_smoke.py's card-against-CPU check (``BF16_PASS_BOUND``,
    0.05; measured here 0.012-0.021 on the coarse pass, 0.025-0.039 on
    the fine pass). The end-to-end difference also carries the fine
    sampler's ill-conditioning on nearly empty rays."""
    jb = sides("jax", mode)
    jf = sides("jax")
    pb = sides("port", mode)
    encoded = ("imgs", "poses", "Ks", "depth_range", "img_feats",
               "ray_feats")
    ref_c = R.NeurayRenderer.build_gather_cache(
        {k: t(jb.ref_c[k]) for k in encoded}, **MODES[mode])
    que = {k: t(v) for k, v in jb.que.items()}
    depth, _ = jS.sample_depth(jb.que["depth_range"], 1, H * W, 8, False)

    def jax_pass(side, d, fine):
        return jax.jit(lambda p, d, q, rc: side.r.apply(
            p, d, q, rc, False, fine,
            method=jR.NeurayRenderer._render_by_depth))(
                side.params, d, side.que, side.ref_c)

    worst = {}
    coarse = jax_pass(jb, depth, False)
    fine_depth = jS.sample_fine_depth(depth, coarse["hit_prob_nr"],
                                      jb.que["depth_range"], 8, False, None)
    for name, d, fine in (("coarse", depth, False),
                          ("fine", fine_depth, True)):
        with torch.inference_mode():
            ours = pb.r._render_by_depth(t(d), que, ref_c, fine)
        theirs = jax_pass(jb, d, fine)
        ref32 = jax_pass(jf, d, fine)
        worst[name] = held(f"{mode} {name} pass pixel_colors_nr",
                           ours["pixel_colors_nr"],
                           theirs["pixel_colors_nr"],
                           ref32["pixel_colors_nr"])
    print(f"{mode}: per-pass port vs JAX bf16 max {worst}, "
          f"bound {chip_smoke.BF16_PASS_BOUND}")
    assert max(worst.values()) <= chip_smoke.BF16_PASS_BOUND
