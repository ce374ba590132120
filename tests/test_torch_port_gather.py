"""The port's gather entries (``neuray_tpu_torch/ops/gather.py``): the
fused render entry's plain version against the JAX package's
``interpolate_feature_map``, the backward's plain version against
autograd and ``jax.vjp``, the wrapper's checks, routes and gradient
rules, and the byte count behind the kernel's bound; on a card, every
kernel path (forward and backward) against its plain version.

Tolerances: f32 1e-4 against JAX. bf16 by the rule of
``tests/test_torch_port_bf16.py`` (``held``): the port's bf16 error
against JAX f32 within 1.5x of JAX bf16's own, in mean and max; JAX's
bf16 gather returns f32 (its weights promote), so its result is rounded
to bf16, the dtype the bf16 route carries. u8: the dequantized JAX
gather of the codes within one bf16 ulp.
"""
import collections

import numpy as np
import pytest
import torch

import chip_smoke
from neuray_tpu_torch.ops import gather as GA
from neuray_tpu_torch.ops import interpolate as I

torch.set_num_threads(1)

BF = torch.bfloat16
H, W = 32, 40


@pytest.fixture
def jI():
    """The JAX package's interpolate module. Imported here, not at the top:
    the card's machine has no jax, and runs this file's ``cuda`` tests
    alone (``--noconftest``, README)."""
    pytest.importorskip("jax")
    from neuray_tpu.ops import interpolate
    return interpolate


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    return torch.device("cuda")


def t(x):
    return torch.from_numpy(np.array(x))


def inputs(scale, c=16, seed=1):
    """A map at 1/scale of the (H, W) frame, 500 points a view with a
    margin outside the frame, a mask with zeros."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(3, H // scale, W // scale, c).astype(np.float32)
    pts = (rng.rand(3, 500, 2) * [W + 8, H + 8] - 4).astype(np.float32)
    pts[:, :4] = [[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0]]
    mask = (rng.rand(3, 500) > 0.3).astype(np.float32)
    return feats, pts, mask


def fused(feats, pts, mask, dequant=None):
    """The fused entry on CPU tensors: its plain version, no launch."""
    before = GA.LAUNCHES
    out = I.interpolate_feature_map(feats, t(pts), t(mask), H, W, dequant)
    assert GA.LAUNCHES == before
    ref = GA.gather_feature_map_ref(feats, t(pts), t(mask), H, W, dequant)
    assert torch.equal(out, ref)
    return out


# ---------------- the fused entry's plain version against JAX ----------------

@pytest.mark.parametrize("scale", [1, 4], ids=["align", "half-pixel"])
def test_fused_f32_equals_jax(jI, scale):
    feats, pts, mask = inputs(scale)
    out = fused(t(feats), pts, mask)
    want = np.asarray(jI.interpolate_feature_map(feats, pts, mask, H, W))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-4)
    assert (out.numpy()[mask == 0] == 0).all()


@pytest.mark.parametrize("scale", [1, 4], ids=["align", "half-pixel"])
def test_fused_bf16_held_to_jax(jI, scale):
    import jax.numpy as jnp
    feats, pts, mask = inputs(scale)
    out = fused(t(feats).to(BF), pts, mask)
    assert out.dtype == BF
    port = out.float().numpy()
    f32 = np.asarray(jI.interpolate_feature_map(feats, pts, mask, H, W))
    bf16 = np.asarray(jI.interpolate_feature_map(
        jnp.asarray(feats, jnp.bfloat16), pts, mask, H, W).astype(
            jnp.bfloat16), np.float32)
    own, ours, d = np.abs(bf16 - f32), np.abs(port - f32), np.abs(port - bf16)
    assert ours.mean() <= 1.5 * own.mean() and ours.max() <= 1.5 * own.max()
    assert d.mean() <= 2 * own.mean() and d.max() <= 2 * own.max()


@pytest.mark.parametrize("scale", [1, 4], ids=["align", "half-pixel"])
def test_fused_u8_equals_jax_dequantized(jI, scale):
    _, pts, mask = inputs(scale)
    rng = np.random.RandomState(2)
    codes = rng.randint(0, 256, (3, H // scale, W // scale, 16)).astype(
        np.uint8)
    scale_ = (rng.rand(16) / 127).astype(np.float32)
    offset = scale_ * np.float32(128)
    out = fused(t(codes), pts, mask, (t(scale_), t(offset)))
    assert out.dtype == BF
    lerp = np.asarray(jI.interpolate_feature_map(
        codes.astype(np.float32), pts, np.ones_like(mask), H, W))
    want = (lerp * scale_ - offset) * mask[..., None]
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2.0 ** -8,
                               atol=1e-6)


def test_feature_pixel_coords_divides_exactly():
    """The conversion divides in IEEE f32 (the kernel's prologue and the
    JAX package do), not by a rounded reciprocal."""
    x = torch.arange(0, 800, dtype=torch.float32)
    pix = GA.feature_pixel_coords(torch.stack([x, x], -1), 800, 800, 800,
                                  800, True)
    want = (x.double() / 799.0).float() * 2.0 - 1.0
    want = (want + 1.0) / 2.0 * 799.0
    assert torch.equal(pix[:, 0], want)


# ---------------- the backward's plain version ----------------

ROUTES = ["map pixels", "align", "half-pixel"]


def backward_inputs(route, c=16):
    """inputs() for the route (map pixels: the points as pixels of the
    (H, W) map itself) and a grad_out [3, 500, c]."""
    feats, pts, mask = inputs(4 if route == "half-pixel" else 1, c, seed=3)
    grad = np.random.RandomState(4).randn(3, 500, c).astype(np.float32)
    return feats, pts, mask, grad


def plain_backward(route, feats, pts, mask, grad):
    fh, fw = feats.shape[1:3]
    if route == "map pixels":
        return GA.gather_bilinear_border_backward_ref(t(grad), t(pts), fh, fw)
    return GA.gather_feature_map_backward_ref(t(grad), t(pts), t(mask), H, W,
                                              fh, fw)


@pytest.mark.parametrize("route", ROUTES)
def test_backward_ref_matches_autograd(route):
    """The scatter-add against torch.autograd through the forward's own
    lerp (``_lerp_f32``), points outside the map and mask zeros
    included: 1e-5 (both sum the same products in other orders)."""
    feats, pts, mask, grad = backward_inputs(route)
    f = t(feats).requires_grad_()
    fh, fw = feats.shape[1:3]
    if route == "map pixels":
        out = GA._lerp_f32(f, t(pts))
    else:
        pix = GA.feature_pixel_coords(t(pts), H, W, fh, fw, route == "align")
        out = GA._lerp_f32(f, pix) * t(mask)[..., None]
    want, = torch.autograd.grad(out, f, t(grad))
    ours = plain_backward(route, feats, pts, mask, grad)
    torch.testing.assert_close(ours, want, rtol=1e-5, atol=1e-5)
    assert ours.abs().max() > 0


@pytest.mark.parametrize("route", ROUTES)
def test_backward_ref_matches_jax_vjp(jI, route):
    """Against jax.vjp of the JAX package's gathers (what XLA transposes
    in the JAX trainer): ``interpolate_feature_map`` on the frame routes,
    ``grid_sample_nhwc`` (border, align_corners) at map pixels. 1e-5."""
    import jax
    feats, pts, mask, grad = backward_inputs(route)
    if route == "map pixels":
        def fn(f):
            return jI.grid_sample_nhwc(f, pts, padding_mode="border",
                                       align_corners=True)
    else:
        def fn(f):
            return jI.interpolate_feature_map(f, pts, mask, H, W)
    _, vjp = jax.vjp(fn, feats)
    want, = vjp(grad)
    ours = plain_backward(route, feats, pts, mask, grad)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("route", ROUTES)
def test_autograd_function_on_cpu(route):
    """An f32 map that requires grad goes through ``_GatherF32`` on the CPU
    too: its plain forward, and the plain scatter-add as its backward;
    nothing is counted as a launch."""
    feats, pts, mask, grad = backward_inputs(route)
    f = t(feats).requires_grad_()
    before = (GA.LAUNCHES, GA.BACKWARD_LAUNCHES)
    if route == "map pixels":
        out = GA.gather_bilinear_border(f, t(pts))
        assert torch.equal(out, GA.gather_bilinear_border_ref(t(feats),
                                                              t(pts)))
    else:
        out = GA.gather_feature_map(f, t(pts), t(mask), H, W)
        assert torch.equal(out, GA.gather_feature_map_ref(
            t(feats), t(pts), t(mask), H, W))
    assert type(out.grad_fn).__name__ == "_GatherF32Backward"
    out.backward(t(grad))
    assert torch.equal(f.grad, plain_backward(route, feats, pts, mask, grad))
    assert (GA.LAUNCHES, GA.BACKWARD_LAUNCHES) == before


def test_gradient_rules():
    """Gradients reach the map only: coords, a mask or a dequant that
    requires grad raises, and so does a bf16 map; outside grad mode a
    tensor's requires_grad does not matter."""
    feats, coords = torch.rand(2, 4, 4, 8), torch.rand(2, 5, 2) * 3
    mask, scale = torch.ones(2, 5), torch.ones(8)
    codes = torch.zeros(2, 4, 4, 8, dtype=torch.uint8)
    g = torch.ones(2, 5, 8)
    calls = [
        lambda: GA.gather_feature_map(feats, coords.requires_grad_(), mask,
                                      16, 16),
        lambda: GA.gather_feature_map(feats, coords, mask.requires_grad_(),
                                      16, 16),
        lambda: GA.gather_bilinear_border(feats.to(BF).requires_grad_(),
                                          coords),
        lambda: GA.gather_feature_map(feats.to(BF).requires_grad_(), coords,
                                      mask, 16, 16),
        lambda: GA.gather_bilinear_border_u8(codes, coords, scale,
                                             scale.requires_grad_()),
        lambda: GA.gather_bilinear_border(feats, coords.requires_grad_()),
        lambda: GA.gather_feature_map_backward(g, coords.requires_grad_(),
                                               mask, 16, 16, 4, 4),
    ]
    for call in calls:
        coords.requires_grad_(False), mask.requires_grad_(False)
        scale.requires_grad_(False)
        with pytest.raises(RuntimeError, match="grad"):
            call()
        with torch.no_grad():
            call()
    with pytest.raises(TypeError):
        GA.gather_bilinear_border_backward(g.double(), coords, 4, 4)
    with pytest.raises(ValueError):
        GA.gather_bilinear_border_backward(g[:, :4], coords, 4, 4)
    out = GA.gather_bilinear_border_backward(torch.zeros(2, 0, 8),
                                             torch.zeros(2, 0, 2), 4, 4)
    assert out.shape == (2, 4, 4, 8) and not out.any()


def brute_force_backward(grad_out, coords, fh, fw):
    """The map's gradient in float64, one point and tap at a time."""
    v, p, c = grad_out.shape
    out = np.zeros((v, fh, fw, c))
    for i in range(v):
        for j in range(p):
            x = min(max(float(coords[i, j, 0]), 0.0), fw - 1.0)
            y = min(max(float(coords[i, j, 1]), 0.0), fh - 1.0)
            x0, y0 = int(min(np.floor(x), fw - 2)), int(min(np.floor(y), fh - 2))
            tx, ty = x - x0, y - y0
            for dy, wy in ((0, 1 - ty), (1, ty)):
                for dx, wx in ((0, 1 - tx), (1, tx)):
                    out[i, y0 + dy, x0 + dx] += grad_out[i, j] * wy * wx
    return out


@pytest.mark.parametrize("c,misaligned,fh,fw", [
    (64, 0, 5, 6), (32, 0, 5, 6), (6, 0, 5, 6), (3, 0, 5, 6), (64, 4, 5, 6),
    (64, 8, 5, 6), (128, 0, 5, 6), (67, 4, 5, 6), (257, 4, 5, 6),
    (1, 0, 1030, 1030)])
def test_backward_route(c, misaligned, fh, fw):
    """On CPU tensors the backward entries take any channel count, any
    alignment of grad_out and any map size (also those the CUDA kernels
    refuse: more than 256 channels, more than 12288 8x8 tiles a view) and
    equal a float64 scatter. The kernels' own routes and alignments are
    held on the card (``test_backward_kernel_matches_plain_on_cuda``:
    grad_out 4 and 8 bytes off a 16-byte boundary)."""
    rng = np.random.RandomState(c + misaligned)
    grad_out = offset_view((2, 7, c), torch.float32, misaligned)
    grad_out.copy_(t(rng.randn(2, 7, c).astype(np.float32)))
    coords = t((rng.rand(2, 7, 2) * [fw + 3, fh + 2] - 1).astype(np.float32))
    want = brute_force_backward(grad_out.numpy(), coords.numpy(), fh, fw)
    np.testing.assert_allclose(
        GA.gather_bilinear_border_backward(grad_out, coords, fh, fw).numpy(),
        want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


# ---------------- the wrapper's checks and routes ----------------

def offset_view(shape, dtype, nbytes):
    """A contiguous map ``nbytes`` past a 16-byte boundary (a view with a
    storage offset)."""
    n = int(np.prod(shape))
    extra = 16 // torch.empty((), dtype=dtype).element_size()
    flat = torch.zeros(n + extra, dtype=dtype)
    skip = nbytes // flat.element_size()
    assert flat.data_ptr() % 16 == 0
    view = flat[skip:skip + n].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == nbytes
    return view


@pytest.mark.parametrize("dtype,c,misaligned,route", [
    (torch.float32, 64, 0, (4, True)), (BF, 64, 0, (8, True)),
    (torch.uint8, 64, 0, (16, True)), (torch.float32, 4, 0, (4, True)),
    (torch.float32, 3, 0, (1, False)), (BF, 4, 0, (4, True)),
    (torch.uint8, 3, 0, (1, False)), (torch.float32, 5, 0, (1, False)),
    (BF, 67, 0, (1, False)), (torch.float32, 64, 8, (2, True)),
    (torch.float32, 64, 4, (1, False)), (torch.float32, 4, 4, (1, False)),
    (torch.uint8, 16, 8, (8, True)), (torch.uint8, 4, 0, (1, False))])
def test_route(dtype, c, misaligned, route):
    assert GA._route(offset_view((2, 3, 5, c), dtype, misaligned)) == route


@pytest.mark.parametrize("c", [3, 4, 5, 64])
def test_wrapper_takes_misaligned_views_and_empty_points(c):
    rng = np.random.RandomState(c)
    feats = offset_view((2, 5, 7, c), torch.float32, 4)
    feats.copy_(t(rng.rand(2, 5, 7, c).astype(np.float32)))
    coords = t((rng.rand(2, 30, 2) * [9, 7] - 1).astype(np.float32))
    assert torch.equal(GA.gather_bilinear_border(feats, coords),
                       GA.gather_bilinear_border_ref(feats.clone(), coords))
    empty = GA.gather_bilinear_border(feats, torch.zeros(2, 0, 2))
    assert empty.shape == (2, 0, c)
    pts, mask = torch.zeros(2, 0, 2), torch.zeros(2, 0)
    assert GA.gather_feature_map(feats, pts, mask, 20, 28).shape == (2, 0, c)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    feats, coords = torch.zeros(2, 4, 4, 8), torch.zeros(2, 5, 2)
    mask = torch.ones(2, 5)
    scale = torch.ones(8)
    bad = [
        (feats, coords, mask[:, :4], None),                # mask shape
        (feats, coords, mask.bool(), None),                # mask dtype
        (feats, coords, torch.ones(5, 2).t(), None),       # not contiguous
        (feats, coords, mask, (scale, scale)),             # dequant, f32 map
        (feats.to(torch.uint8), coords, mask, None),       # u8, no dequant
        (feats.to(torch.uint8), coords, mask, (scale, scale[:4])),
        (feats.double(), coords, mask, None),
    ]
    for f, c, m, dq in bad:
        with pytest.raises((ValueError, TypeError)):
            GA.gather_feature_map(f, c, m, 16, 16, dq)
    with pytest.raises(ValueError):                        # grid y
        GA.gather_bilinear_border(torch.zeros(65536, 2, 2, 1),
                                  torch.zeros(65536, 1, 2))


# ---------------- the bound's byte count ----------------

def brute_force_taps(coords, fh, fw):
    """Per view, the taps on each pixel, one point at a time, in float64."""
    counts = []
    for view in coords.astype(np.float64):
        seen = collections.Counter()
        for x, y in view:
            x = min(max(x, 0.0), fw - 1.0)
            y = min(max(y, 0.0), fh - 1.0)
            x0 = int(min(np.floor(x), fw - 2))
            y0 = int(min(np.floor(y), fh - 2))
            seen.update([(y0 + dy, x0 + dx) for dy in (0, 1) for dx in (0, 1)])
        counts.append(seen)
    return counts


def brute_force_pixels(coords, fh, fw):
    """Distinct tap pixels, summed over the views."""
    return sum(len(seen) for seen in brute_force_taps(coords, fh, fw))


@pytest.mark.parametrize("v,fh,fw,p", [(1, 2, 2, 5), (2, 5, 7, 40),
                                       (3, 16, 9, 200), (2, 30, 30, 12)])
def test_touched_pixels_is_the_distinct_tap_count(v, fh, fw, p):
    rng = np.random.RandomState(fh * fw + p)
    coords = (rng.rand(v, p, 2) * [fw + 4, fh + 4] - 2).astype(np.float32)
    assert GA.touched_pixels(t(coords), fh, fw) == brute_force_pixels(
        coords, fh, fw)


@pytest.mark.parametrize("dtype,masked", [(torch.float32, False),
                                          (BF, True), (torch.uint8, True)])
def test_gather_bound_counts_each_byte_once(dtype, masked):
    rng = np.random.RandomState(5)
    feats = torch.zeros(2, 6, 9, 12, dtype=dtype)
    pix = t((rng.rand(2, 50, 2) * [11, 8] - 1).astype(np.float32))
    nbytes, touched, bound_ms, by = chip_smoke.gather_bound(
        GA, feats, pix, masked)
    size = feats.element_size()
    out = 2 if dtype == torch.uint8 else size
    assert touched == brute_force_pixels(pix.numpy(), 6, 9)
    assert nbytes == (touched * 12 * size + 2 * 50 * 8 + 2 * 50 * 12 * out
                      + (2 * 50 * 4 if masked else 0)
                      + (2 * 12 * 4 if dtype == torch.uint8 else 0))
    assert by == "bytes"
    assert bound_ms == pytest.approx(1e3 * nbytes / chip_smoke.HBM_BYTES_PER_S)


@pytest.mark.parametrize("masked", [False, True])
def test_gather_backward_bound_counts_each_byte_once(masked):
    """The backward's least work: grad_out, the coordinates and the mask
    read once and the whole [v, fh, fw, c] gradient written once, however
    many taps land on a pixel and whether or not a pixel is touched (no
    zero-fill counted on top); the touched pixels are reported beside
    it, and the most taps on one pixel."""
    rng = np.random.RandomState(6)
    v, p, fh, fw, c = 2, 50, 6, 9, 12
    pix = t((rng.rand(v, p, 2) * [11, 8] - 1).astype(np.float32))
    pix[1, :20] = t(np.float32([3.5, 2.5]))      # 20 points on one anchor
    nbytes, touched, bound_ms, by = chip_smoke.gather_backward_bound(
        GA, torch.zeros(v, p, c), pix, fh, fw, masked)
    assert touched == brute_force_pixels(pix.numpy(), fh, fw)
    assert nbytes == (v * p * c * 4 + v * p * 8 + (v * p * 4 if masked else 0)
                      + v * fh * fw * c * 4)
    assert by == "bytes"
    assert bound_ms == pytest.approx(1e3 * nbytes / chip_smoke.HBM_BYTES_PER_S)
    most = max(max(seen.values()) for seen in brute_force_taps(
        pix.numpy(), fh, fw))
    assert chip_smoke.most_taps(GA, pix, fh, fw) == most >= 20


# ---------------- on the card: every kernel path ----------------

def _map(g, dev, dtype, shape, misalign_bytes=0):
    """A random map of ``shape`` (u8: codes), ``misalign_bytes`` past a
    16-byte boundary."""
    n = int(np.prod(shape))
    size = torch.empty((), dtype=dtype).element_size()
    skip = misalign_bytes // size
    if dtype == torch.uint8:
        flat = torch.randint(0, 256, (n + 16,), generator=g, device=dev,
                             dtype=dtype)
    else:
        flat = torch.rand(n + 16, generator=g, device=dev).to(dtype)
    return flat[skip:skip + n].view(shape)


def _hold(out, ref, dtype):
    """f32 1e-5 (FMA contraction); bf16 and u8 one bf16 ulp of values in
    [0, 1) or of the output."""
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -8,
                                   atol=2.0 ** -8)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 4, 5, 8, 16, 64, 67])
def test_kernel_paths_match_plain_on_cuda(cuda_device, c):
    """Each instantiation at c channels, on an aligned map and one 4 bytes
    off a 16-byte boundary, at a point count no block size divides."""
    g = torch.Generator(device=cuda_device).manual_seed(c)
    p = 1001
    coords = torch.rand((3, p, 2), generator=g, device=cuda_device)
    coords = coords * torch.tensor([19.0, 15.0], device=cuda_device) - 3
    scale = torch.rand(c, generator=g, device=cuda_device) / 127
    dq = (scale, scale * 128)
    for dtype in (torch.float32, BF, torch.uint8):
        for misalign in (0, 4):
            feats = _map(g, cuda_device, dtype, (3, 9, 13, c), misalign)
            before = GA.LAUNCHES
            if dtype == torch.uint8:
                out = GA.gather_bilinear_border_u8(feats, coords, *dq)
                ref = GA.gather_bilinear_border_u8_ref(feats, coords, *dq)
            else:
                out = GA.gather_bilinear_border(feats, coords)
                ref = GA.gather_bilinear_border_ref(feats, coords)
            torch.cuda.synchronize()
            assert GA.LAUNCHES == before + 1
            if dtype == torch.uint8:
                assert torch.equal(out, ref), (c, misalign)
            else:
                _hold(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1, 4], ids=["align", "half-pixel"])
def test_fused_entry_matches_plain_on_cuda(cuda_device, scale):
    g = torch.Generator(device=cuda_device).manual_seed(scale)
    h, w, p = 48, 64, 3333
    pts = torch.rand((4, p, 2), generator=g, device=cuda_device)
    pts = pts * torch.tensor([w + 10.0, h + 10.0], device=cuda_device) - 5
    mask = (torch.rand((4, p), generator=g, device=cuda_device) > 0.3).float()
    for c in (3, 64):
        sc = torch.rand(c, generator=g, device=cuda_device) / 127
        for dtype in (torch.float32, BF, torch.uint8):
            feats = _map(g, cuda_device, dtype, (4, h // scale, w // scale, c))
            dq = (sc, sc * 128) if dtype == torch.uint8 else None
            out = GA.gather_feature_map(feats, pts, mask, h, w, dq)
            ref = GA.gather_feature_map_ref(feats, pts, mask, h, w, dq)
            torch.cuda.synchronize()
            _hold(out, ref, dtype)
            assert (out.float()[mask == 0] == 0).all()


def _edge_pixels(g, dev, v, p, fh, fw):
    """Map pixels [v, p, 2]: a quarter each on 8x8 tile seams (the taps
    straddle two or four tiles), on tile corners, on the map's last row
    and column, and anywhere with a 5-pixel margin outside the map."""
    q = -(-p // 4)

    def seams(n):
        return torch.randint(1, n // 8 + 1, (v, q, 1), generator=g,
                             device=dev) * 8 - 1

    def rand(*scale):
        return torch.rand((v, q, 2), generator=g, device=dev) * torch.tensor(
            scale, device=dev)

    seam = torch.cat([seams(fw), seams(fh)], -1).float()
    last = torch.tensor([fw - 1.0, fh - 1.0], device=dev) - rand(1.5, 1.5)
    return torch.cat([seam + rand(1, 1), seam, last,
                      rand(fw + 10.0, fh + 10.0) - 5], 1)[:, :p].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 4, 5, 8, 32, 64, 67])
def test_backward_kernel_matches_plain_on_cuda(cuda_device, c):
    """The tiled backward on each route (map pixels; the fused entry,
    align_corners and half-pixel, with mask zeros), grad_out 16-byte
    aligned and 4 and 8 bytes off (the scalar and 8-byte routes), at a
    point count no block divides, the points on 8x8 tile seams and
    corners, on the map's last row and column and outside it; then one
    view, no points, and the long bin: every point of a view on one pixel
    at a corner of four tiles, with integer grad_out (every order of the
    sums is exact). Each call into a block that held NaN
    (``chip_smoke.poisoned``: every pixel written), each element within
    1e-5 relative and 1e-6 of the largest absolute (the sums' order
    differs); one backward launch each, counted on its own."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(c)
    h, w, p = 48, 64, 3333

    def check(grad, pts, mask, fh, fw):
        if mask is None:
            args = (grad, pts, fh, fw)
            fn = GA.gather_bilinear_border_backward
            plain = GA.gather_bilinear_border_backward_ref
        else:
            args = (grad, pts, mask, h, w, fh, fw)
            fn = GA.gather_feature_map_backward
            plain = GA.gather_feature_map_backward_ref
        before, fwd = GA.BACKWARD_LAUNCHES, GA.LAUNCHES
        out = chip_smoke.poisoned(fn, *args)
        assert (GA.BACKWARD_LAUNCHES, GA.LAUNCHES) == (before + 1, fwd)
        want = plain(*args)
        torch.testing.assert_close(out, want, rtol=1e-5,
                                   atol=1e-6 * want.abs().max().item())

    for scale, fused in ((1, False), (1, True), (4, True)):
        fh, fw = h // scale, w // scale
        pix = _edge_pixels(g, dev, 4, p, fh, fw)
        # the frame points whose map pixels these are
        pts = pix if scale == 1 else ((pix + 0.5) * torch.tensor(
            [(w - 1) / fw, (h - 1) / fh], device=dev)).contiguous()
        mask = (torch.rand((4, p), generator=g, device=dev) > 0.3).float()
        for misalign in (0, 4, 8):
            grad = _map(g, dev, torch.float32, (4, p, c), misalign)
            check(grad, pts, mask if fused else None, fh, fw)
    grad = _map(g, dev, torch.float32, (4, p, c))
    check(grad[:1], pts[:1], mask[:1], fh, fw)
    check(grad[:, :0], pts[:, :0], mask[:, :0], fh, fw)
    # (7.5, 7.5) and, in the (48, 64) frame, (31.5, 23.5): pixel (31.5,
    # 23.5) of the map, anchor (31, 23); weights 0.5
    exact = torch.randint(-4, 5, (2, p, c), generator=g, device=dev).float()
    for at, m in (((7.5, 7.5), None), ((31.5, 23.5), mask[:2])):
        check(exact, torch.tensor(at, device=dev).expand(2, p, 2).contiguous(),
              m, h, w)


@pytest.mark.cuda
def test_autograd_through_the_kernels_on_cuda(cuda_device):
    """A CUDA f32 map that requires grad: one forward and one backward
    launch, and the map's gradient equals the CPU's plain one."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    h, w, p = 48, 64, 2000
    pts = torch.rand((4, p, 2), generator=g, device=cuda_device) * 60 - 5
    mask = (torch.rand((4, p), generator=g, device=cuda_device) > 0.3).float()
    feats = torch.rand((4, h // 4, w // 4, 64), generator=g,
                       device=cuda_device)
    weight = torch.randn((4, p, 64), generator=g, device=cuda_device)
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        f = feats.detach().to(dev).requires_grad_()
        fwd, bwd = GA.LAUNCHES, GA.BACKWARD_LAUNCHES
        out = GA.gather_feature_map(f, pts.to(dev), mask.to(dev), h, w)
        (out * weight.to(dev)).sum().backward()
        launched = (GA.LAUNCHES - fwd, GA.BACKWARD_LAUNCHES - bwd)
        assert launched == ((1, 1) if dev.type == "cuda" else (0, 0))
        grads.append(f.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5,
                               atol=1e-6 * grads[1].abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 4, 257), (1, 1040, 1040, 1)])
def test_backward_refuses_at_the_forward_on_cuda(cuda_device, shape):
    """A CUDA f32 map that requires grad and that the backward kernels do
    not take (more than 256 channels; more than 12288 8x8 tiles a view)
    raises at the forward, not in ``loss.backward()``; without grad the
    forward kernel takes it."""
    feats = torch.zeros(shape, device=cuda_device)
    pts = torch.zeros((1, 3, 2), device=cuda_device)
    mask = torch.ones((1, 3), device=cuda_device)
    with pytest.raises(ValueError, match="backward kernel does not take"):
        GA.gather_feature_map(feats.requires_grad_(), pts, mask, 8, 8)
    assert GA.gather_feature_map(feats.detach(), pts, mask, 8, 8).shape == (
        1, 3, shape[-1])
