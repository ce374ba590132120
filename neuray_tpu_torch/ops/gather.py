"""Border-clamped bilinear gather: the wrapper of the hand-written CUDA
kernel ``csrc/gather_bilinear_border.cu`` and its plain PyTorch twins.

Port of the Pallas TPU kernel ``neuray_tpu/ops/pallas/gather.py``
(``gather_bilinear_border``). On the TPU that kernel lost to XLA's
gather and the renderer kept jnp gathers; here the kernel serves every
border gather of the render path: the per-chunk rgb and 64-channel
feature gathers and the scene encode's cross-view diff gather.

Three entries, each one kernel launch on CUDA tensors and its plain
version on CPU tensors, and nothing else (a CUDA tensor the kernel does
not take raises):
- ``gather_bilinear_border``: an f32 or bf16 map at map-pixel coords;
- ``gather_bilinear_border_u8``: a map of u8 codes, dequantized per
  channel into bf16 (the u8 gather map of the bf16 route);
- ``gather_feature_map``: the render's gather
  (``interpolate_feature_map``): points of the (h, w) frame converted to
  map pixels as ``feature_pixel_coords`` does, the gather (u8 with a
  dequant) and the projection mask, in one launch.
An f32 map that requires grad (training) goes through ``_GatherF32``, a
``torch.autograd.Function`` whose backward is the tiled scatter-add
(``gather_bilinear_border_backward``, ``gather_feature_map_backward``:
the points binned by map tile, each tile summed in shared memory and
written to the map; on CPU tensors their plain twins). Gradients reach the map
only: the coordinates and the mask are data in training (the fine depths
come from a detached hit_prob), so a coords or mask tensor that requires
grad, or a bf16 or u8 map that does, raises.
The kernels are compiled with nvcc at first use, from the source in this
repository, into ``build/neuray_tpu_torch/`` keyed by a hash of the
source, and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from neuray_tpu_torch.utils.profiling import count, per_launch

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / \
    "gather_bilinear_border.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "neuray_tpu_torch"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

# kernel launches (never the plain versions'): the forward's in all and by
# the map's dtype ("f32", "bf16", "u8"), the backward's on their own; read
# and reset (``reset_launches``) by chip_smoke.py to prove the render and
# training paths went through the kernels. Under a profiler session each
# launch also counts its bytes (``launch_bytes``, ``backward_launch_bytes``)
# into the recorder's ``gather.bytes`` and ``gather.bwd_bytes``
# (``utils/profiling.py``). A launch captured into a CUDA graph by
# ``utils/graphs.py`` counts at each replay of its graph, not at the capture
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"f32": 0, "bf16": 0, "u8": 0}
BACKWARD_LAUNCHES = 0

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.uint8: "u8"}
# where the kernel finds a point: the map's own pixels, or a point of the
# (h, w) frame with align_corners True or False (feature_pixel_coords)
_MAP_PIXELS, _ALIGN_CORNERS, _HALF_PIXEL = 0, 1, 2
_MAX_VIEWS, _MAX_POINTS = 65535, 2 ** 30   # the grid's y; int32 point math


def reset_launches() -> None:
    global LAUNCHES, BACKWARD_LAUNCHES
    LAUNCHES = BACKWARD_LAUNCHES = 0
    for k in LAUNCHES_BY_DTYPE:
        LAUNCHES_BY_DTYPE[k] = 0


def launch_bytes(v: int, p: int, c: int, out_elem: int,
                 masked: bool) -> int:
    """The bytes a forward launch needs at v x p points: the coordinates
    (8 bytes a point), the mask (4) where given and the output (c
    channels of ``out_elem`` bytes), each once; the map's reads left out
    (only the coordinates say which pixels the taps touch)."""
    return v * p * (8 + (4 if masked else 0) + c * out_elem)


def backward_launch_bytes(v: int, p: int, c: int, fh: int, fw: int,
                          masked: bool) -> int:
    """The bytes a backward launch needs: grad_out, the coordinates and
    the mask read once, the whole [v, fh, fw, c] f32 map gradient written
    once."""
    return v * p * (c * 4 + 8 + (4 if masked else 0)) + v * fh * fw * c * 4


@per_launch
def _count(dtype_name: str, nbytes: int) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[dtype_name] += 1
    count("gather.bytes", nbytes)


# ---------------- plain versions ----------------

def feature_pixel_coords(points: torch.Tensor, h: int, w: int, fh: int,
                         fw: int, align_corners: bool) -> torch.Tensor:
    """Map (x, y) pixel coords of an (h, w) frame to pixel coords of an
    (fh, fw) feature map through the reference's normalize ->
    grid_sample-unnormalize round trip (``neuray_tpu/ops/interpolate.py:
    56-63``). points [..., 2] -> [..., 2] f32 contiguous.

    The divisor is a 0-dim tensor, not a Python number: PyTorch's CUDA
    kernel multiplies by the reciprocal of a scalar divisor, one bit off
    the IEEE division that the JAX package and the kernel's prologue do;
    a tensor divisor divides on both devices."""
    def norm(x, size):
        return x / torch.full((), size - 1.0, device=x.device) * 2.0 - 1.0

    x_norm, y_norm = norm(points[..., 0], w), norm(points[..., 1], h)
    if align_corners:
        ix = (x_norm + 1.0) / 2.0 * (fw - 1.0)
        iy = (y_norm + 1.0) / 2.0 * (fh - 1.0)
    else:
        ix = ((x_norm + 1.0) * fw - 1.0) / 2.0
        iy = ((y_norm + 1.0) * fh - 1.0) / 2.0
    return torch.stack([ix, iy], dim=-1)


def _anchor(coords: torch.Tensor, fh: int, fw: int):
    """The border clamp of map-pixel coords [v, p, 2]: the top-left tap
    (x0, y0) in [0, fw-2] x [0, fh-2] (f32 integers) and the weights
    (tx, ty) in [0, 1], each [v, p]."""
    ixc = coords[..., 0].clamp(0.0, fw - 1.0)
    iyc = coords[..., 1].clamp(0.0, fh - 1.0)
    x0 = torch.floor(ixc).clamp(0.0, fw - 2.0)
    y0 = torch.floor(iyc).clamp(0.0, fh - 2.0)
    return x0, y0, ixc - x0, iyc - y0


def _lerp_f32(feats: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The border-clamped bilinear sample of feats [v, fh, fw, c] (any
    dtype, read as f32) at coords [v, p, 2] -> [v, p, c] f32."""
    v, fh, fw, c = feats.shape
    p = coords.shape[1]
    x0, y0, tx, ty = _anchor(coords, fh, fw)
    tx, ty = tx[..., None], ty[..., None]
    idx = y0.long() * fw + x0.long()                           # v,p
    flat = feats.reshape(v, fh * fw, c).float()

    def tap(offset: int):
        return torch.gather(flat, 1, (idx + offset)[..., None].expand(v, p, c))

    top = tap(0) * (1 - tx) + tap(1) * tx
    bot = tap(fw) * (1 - tx) + tap(fw + 1) * tx
    return top * (1 - ty) + bot * ty


def touched_pixels(coords: torch.Tensor, fh: int, fw: int) -> int:
    """The distinct map pixels that the four taps of map-pixel coords
    [v, p, 2] read, summed over the views: the map bytes a gather must
    move are this times c times the element size."""
    v = coords.shape[0]
    x0, y0, _, _ = _anchor(coords, fh, fw)
    idx = y0.long() * fw + x0.long()
    seen = torch.zeros(v, fh * fw, dtype=torch.bool, device=coords.device)
    for offset in (0, 1, fw, fw + 1):
        seen.scatter_(1, idx + offset, True)
    return int(seen.sum())


def gather_bilinear_border_ref(feats: torch.Tensor,
                               coords: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.

    feats [v, fh, fw, c]; coords [v, p, 2] (x, y) feature-map pixels ->
    [v, p, c] in feats' dtype, computed in f32.
    """
    return _lerp_f32(feats, coords).to(feats.dtype)


def gather_bilinear_border_u8_ref(codes: torch.Tensor, coords: torch.Tensor,
                                  scale: torch.Tensor,
                                  offset: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the u8 kernel, on any device.

    codes [v, fh, fw, c] u8; coords [v, p, 2] f32; scale, offset [c] f32
    -> [v, p, c] bf16: the bilinear sample of the codes in f32, times
    scale minus offset per channel, rounded once to bf16.
    """
    return (_lerp_f32(codes, coords) * scale - offset).to(torch.bfloat16)


def gather_feature_map_ref(feats: torch.Tensor, points: torch.Tensor,
                           mask: torch.Tensor, h: int, w: int,
                           dequant=None) -> torch.Tensor:
    """Plain PyTorch version of ``gather_feature_map``, on any device: the
    conversion to map pixels (align_corners iff the map is (h, w)), the
    gather, then the mask in the output's dtype."""
    fh, fw = feats.shape[1:3]
    pix = feature_pixel_coords(points, h, w, fh, fw, fh == h and fw == w)
    out = (gather_bilinear_border_ref(feats, pix) if dequant is None
           else gather_bilinear_border_u8_ref(feats, pix, *dequant))
    return out * mask[..., None].to(out.dtype)


def gather_bilinear_border_backward_ref(grad_out: torch.Tensor,
                                        coords: torch.Tensor, fh: int,
                                        fw: int,
                                        mask: torch.Tensor | None = None
                                        ) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel, on any device: the
    gradient of the f32 gather at map-pixel coords [v, p, 2] with respect
    to its map, given grad_out [v, p, c] f32 and, for the fused entry, the
    mask [v, p]. Each point adds grad_out * mask * w_tap at its four taps
    (``index_put_`` with accumulate), the taps and weights from the
    forward's ``_anchor`` and each product rounded as the kernel rounds
    it -> [v, fh, fw, c] f32."""
    v, p, c = grad_out.shape
    x0, y0, tx, ty = _anchor(coords, fh, fw)
    tx, ty = tx[..., None], ty[..., None]
    g = grad_out if mask is None else grad_out * mask[..., None]
    top, bot = g * (1 - ty), g * ty
    idx = y0.long() * fw + x0.long()                           # v,p
    view = torch.arange(v, device=idx.device)[:, None].expand(v, p)
    grad = torch.zeros((v, fh * fw, c), device=grad_out.device)
    for offset, part in ((0, top * (1 - tx)), (1, top * tx),
                         (fw, bot * (1 - tx)), (fw + 1, bot * tx)):
        grad.index_put_((view, idx + offset), part, accumulate=True)
    return grad.view(v, fh, fw, c)


def gather_feature_map_backward_ref(grad_out: torch.Tensor,
                                    points: torch.Tensor, mask: torch.Tensor,
                                    h: int, w: int, fh: int,
                                    fw: int) -> torch.Tensor:
    """Plain PyTorch version of ``gather_feature_map_backward``: the
    points converted as the forward converts them, then
    ``gather_bilinear_border_backward_ref`` with the mask."""
    pix = feature_pixel_coords(points, h, w, fh, fw, fh == h and fw == w)
    return gather_bilinear_border_backward_ref(grad_out, pix, fh, fw, mask)


# ---------------- the kernel ----------------

def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build_library() -> Path:
    """Compile the kernel source (if not built yet) and return the path
    of the shared library; ptxas' register and spill report is kept
    beside it (``.log``). A failed build raises with nvcc's output."""
    source = _SOURCE.read_bytes()
    key = hashlib.sha256(
        source + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD_DIR / f"gather_bilinear_border_{key}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-Xptxas=-v", "-o", tmp, str(_SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {_SOURCE.name}:\n{proc.stdout}"
                f"{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> dict:
    """Build (at first use) and load the kernel library; returns its
    entries, bound once, by the map's dtype name."""
    lib = ctypes.CDLL(str(build_library()))
    fns = {}
    for name in (*_NAMES.values(), "f32_backward"):
        fn = getattr(lib, f"gather_border_{name}")
        # forward: map, coords, mask, scale, offset, out; backward:
        # grad_out, coords, mask, grad_map, scratch; then v, p, fh, fw, c,
        # frame, h, w and the forward's route n, vec; stream
        backward = name == "f32_backward"
        fn.argtypes = ([ctypes.c_void_p] * (5 if backward else 6)
                       + [ctypes.c_int] * (8 if backward else 10)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    # the backward's scratch in int32s for v, p, fh, fw, c (-1: not taken)
    fn = lib.gather_border_f32_backward_scratch
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int64
    fns["f32_backward_scratch"] = fn
    return fns


def _route(feats: torch.Tensor) -> tuple[int, bool]:
    """The forward kernel's path for the map: (elements a lane loads,
    whether as one vector). 16-byte vectors where a pixel's channels are a
    whole number of them and the map is aligned to one, else 8-byte
    vectors likewise, else one lane a channel with scalar loads (chosen by
    ``gather_bench.py --routes``: one thread a point for c = 3 or 4 was
    slower on the render's coords)."""
    size = feats.element_size()
    c = feats.shape[-1]
    for vec in (16, 8):
        if (c * size) % vec == 0 and feats.data_ptr() % vec == 0:
            return vec // size, True
    return 1, False


def _check_points(anchor: torch.Tensor, v: int, fh: int, fw: int, c: int,
                  coords: torch.Tensor, mask: torch.Tensor | None = None,
                  dequant=None) -> bool:
    """The checks shared by the forward and the backward entries, for a
    map [v, fh, fw, c] and the tensor ``anchor`` (the map, or the
    backward's grad_out) that sets the device. Returns True for CPU
    tensors (the plain version), False for CUDA tensors (the kernel)."""
    cshape = coords.shape
    if len(cshape) != 3 or cshape[0] != v or cshape[2] != 2:
        raise ValueError(f"coords must be [{v}, p, 2], got {tuple(cshape)}")
    if fh < 2 or fw < 2:
        raise ValueError(f"the map must be at least 2x2, got {fh}x{fw}")
    if v > _MAX_VIEWS or cshape[1] > _MAX_POINTS:
        raise ValueError(f"at most {_MAX_VIEWS} views of {_MAX_POINTS} "
                         f"points, got {v} of {cshape[1]}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    others = [coords]
    if mask is not None:
        if mask.shape != cshape[:2] or mask.dtype != torch.float32:
            raise TypeError(f"mask must be float32 {tuple(cshape[:2])}, got "
                            f"{mask.dtype} {tuple(mask.shape)}")
        others.append(mask)
    if dequant is not None:
        for name, x in zip(("scale", "offset"), dequant):
            if x.shape != (c,) or x.dtype != torch.float32:
                raise TypeError(f"{name} must be float32 [{c}], got "
                                f"{x.dtype} {tuple(x.shape)}")
            others.append(x)
    cuda, index = anchor.is_cuda, anchor.get_device()
    contiguous = anchor.is_contiguous()
    for x in others:
        if x.is_cuda != cuda or x.get_device() != index:
            raise ValueError(f"every tensor must be on {anchor.device}")
        if x.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("the gather's gradient reaches the map only; "
                               "coords, mask and dequant must not require "
                               "grad")
        contiguous = contiguous and x.is_contiguous()
    if not contiguous:
        raise ValueError("every tensor must be contiguous")
    if not cuda and anchor.device.type != "cpu":
        raise ValueError(f"no gather for device {anchor.device}")
    return not cuda


def _check(feats: torch.Tensor, coords: torch.Tensor, dtypes,
           mask: torch.Tensor | None = None, dequant=None) -> bool:
    """Check every argument of a forward entry once. Returns True for CPU
    tensors (the plain version), False for CUDA tensors (the kernel);
    raises on what the kernel does not take, and on a map that requires
    grad unless it is f32."""
    if feats.dim() != 4:
        raise ValueError(f"feats must be [v, fh, fw, c], got "
                         f"{tuple(feats.shape)}")
    if feats.dtype not in dtypes:
        raise TypeError(f"feats must be one of {dtypes}, got {feats.dtype}")
    if _needs_grad(feats) and feats.dtype != torch.float32:
        raise RuntimeError(f"only an f32 map takes a gradient, got a "
                           f"{feats.dtype} map that requires grad")
    return _check_points(feats, *feats.shape, coords, mask, dequant)


def _check_backward(grad_out: torch.Tensor, coords: torch.Tensor, fh: int,
                    fw: int, mask: torch.Tensor | None = None) -> bool:
    """``_check`` for a backward entry: grad_out [v, p, c] f32."""
    if grad_out.dim() != 3 or grad_out.shape[:2] != coords.shape[:2]:
        raise ValueError(f"grad_out must be [v, p, c] over coords "
                         f"{tuple(coords.shape)}, got {tuple(grad_out.shape)}")
    if grad_out.dtype != torch.float32:
        raise TypeError(f"grad_out must be float32, got {grad_out.dtype}")
    v, _, c = grad_out.shape
    return _check_points(grad_out, v, fh, fw, c, coords, mask)


def _backward_scratch(v: int, p: int, fh: int, fw: int, c: int) -> int:
    """The int32s of scratch the backward kernels need for a [v, fh, fw, c]
    map and v x p points; raises where the library does not take the
    shapes (``gather_border_f32_backward_scratch`` says which)."""
    n = load_library()["f32_backward_scratch"](v, p, fh, fw, c)
    if n < 0:
        raise ValueError(f"the backward kernel does not take a [{v}, {fh}, "
                         f"{fw}, {c}] map at {v} x {p} points")
    return n


def _needs_grad(feats: torch.Tensor) -> bool:
    return feats.requires_grad and torch.is_grad_enabled()


def _call(name: str, index: int, args: tuple) -> None:
    """Call a library entry on device ``index``; raises on a launch
    error."""
    fn = load_library()[name]
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"gather_border_{name} launch failed: "
                           f"cudaError {err}")


def _launch(feats: torch.Tensor, coords: torch.Tensor,
            mask: torch.Tensor | None, dequant, frame: int, h: int,
            w: int) -> torch.Tensor:
    """One launch on the current stream of feats' device, counted; raises
    on a launch error."""
    v, fh, fw, c = feats.shape
    p = coords.shape[1]
    name = _NAMES[feats.dtype]
    out = torch.empty((v, p, c), device=feats.device, dtype=(
        torch.bfloat16 if name == "u8" else feats.dtype))
    if out.numel() == 0:
        return out
    n, vec = _route(feats)
    scale, offset = (None, None) if dequant is None else (
        dequant[0].data_ptr(), dequant[1].data_ptr())
    index = feats.device.index
    _call(name, index, (
        feats.data_ptr(), coords.data_ptr(),
        None if mask is None else mask.data_ptr(), scale, offset,
        out.data_ptr(), v, p, fh, fw, c, frame, h, w, n, vec,
        torch._C._cuda_getCurrentRawStream(index)))
    _count(name, launch_bytes(v, p, c, out.element_size(),
                              mask is not None))
    return out


def _launch_backward(grad_out: torch.Tensor, coords: torch.Tensor,
                     mask: torch.Tensor | None, fh: int, fw: int, frame: int,
                     h: int, w: int) -> torch.Tensor:
    """The backward on the current stream, counted in
    ``BACKWARD_LAUNCHES``: the map's gradient from ``torch.empty`` (the
    kernels write every element, zeros included) and the bins' int32
    scratch."""
    global BACKWARD_LAUNCHES
    v, p, c = grad_out.shape
    grad_map = torch.empty((v, fh, fw, c), device=grad_out.device)
    if grad_map.numel() == 0:
        return grad_map
    scratch = torch.empty(_backward_scratch(v, p, fh, fw, c),
                          dtype=torch.int32, device=grad_out.device)
    index = grad_out.device.index
    _call("f32_backward", index, (
        grad_out.data_ptr(), coords.data_ptr(),
        None if mask is None else mask.data_ptr(), grad_map.data_ptr(),
        scratch.data_ptr(), v, p, fh, fw, c, frame, h, w,
        torch._C._cuda_getCurrentRawStream(index)))
    BACKWARD_LAUNCHES += 1
    count("gather.bwd_bytes",
          backward_launch_bytes(v, p, c, fh, fw, mask is not None))
    return grad_map


def _gather(feats: torch.Tensor, coords: torch.Tensor,
            mask: torch.Tensor | None, h: int | None, w: int | None,
            dequant, cpu: bool) -> torch.Tensor:
    """A checked forward entry on either device: the map-pixel entry
    (h None) or the fused one; the plain version on the CPU, else one
    launch."""
    if h is None:
        if cpu:
            return (gather_bilinear_border_ref(feats, coords)
                    if dequant is None
                    else gather_bilinear_border_u8_ref(feats, coords,
                                                       *dequant))
        return _launch(feats, coords, None, dequant, _MAP_PIXELS, 0, 0)
    if cpu:
        return gather_feature_map_ref(feats, coords, mask, h, w, dequant)
    return _launch(feats, coords, mask, dequant,
                   _frame(*feats.shape[1:3], h, w), h, w)


def _frame(fh: int, fw: int, h: int, w: int) -> int:
    """Where the fused entry's points live: align_corners iff the
    (fh, fw) map is the (h, w) frame."""
    return _ALIGN_CORNERS if (fh == h and fw == w) else _HALF_PIXEL


class _GatherF32(torch.autograd.Function):
    """An f32 gather whose map takes a gradient (``_gather``'s entries):
    on CUDA tensors the forward is one kernel launch and the backward the
    tiled backward (a memset and three kernels, counted once), on CPU
    tensors the plain twins. On CUDA tensors a map the backward kernels
    do not take raises here, not in ``loss.backward()``."""

    @staticmethod
    def forward(ctx, feats, coords, mask, h, w):
        if feats.is_cuda:
            _backward_scratch(feats.shape[0], coords.shape[1],
                              *feats.shape[1:])
        ctx.save_for_backward(coords, mask)
        ctx.sizes = (h, w, *feats.shape[1:3])
        return _gather(feats, coords, mask, h, w, None, not feats.is_cuda)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        coords, mask = ctx.saved_tensors
        h, w, fh, fw = ctx.sizes
        grad = grad.contiguous()
        if h is None:
            grad_map = gather_bilinear_border_backward(grad, coords, fh, fw)
        else:
            grad_map = gather_feature_map_backward(grad, coords, mask, h, w,
                                                   fh, fw)
        return grad_map, None, None, None, None


def gather_bilinear_border(feats: torch.Tensor,
                           coords: torch.Tensor) -> torch.Tensor:
    """feats [v, fh, fw, c] f32 or bf16; coords [v, p, 2] f32 (x, y)
    feature-map pixels -> [v, p, c] border-clamped bilinear samples in
    feats' dtype. CUDA tensors go through the kernel, CPU tensors
    through ``gather_bilinear_border_ref``; an f32 map that requires grad
    through ``_GatherF32``."""
    cpu = _check(feats, coords, (torch.float32, torch.bfloat16))
    if _needs_grad(feats):
        return _GatherF32.apply(feats, coords, None, None, None)
    return _gather(feats, coords, None, None, None, None, cpu)


def gather_bilinear_border_u8(codes: torch.Tensor, coords: torch.Tensor,
                              scale: torch.Tensor,
                              offset: torch.Tensor) -> torch.Tensor:
    """codes [v, fh, fw, c] u8; coords [v, p, 2] f32 (x, y) map pixels;
    scale, offset [c] f32 -> [v, p, c] bf16: the border-clamped bilinear
    sample of the codes, dequantized per channel as
    ``sample * scale - offset``. CUDA tensors go through the kernel, CPU
    tensors through ``gather_bilinear_border_u8_ref``."""
    dequant = (scale, offset)
    cpu = _check(codes, coords, (torch.uint8,), dequant=dequant)
    return _gather(codes, coords, None, None, None, dequant, cpu)


def gather_feature_map(feats: torch.Tensor, points: torch.Tensor,
                       mask: torch.Tensor, h: int, w: int,
                       dequant=None) -> torch.Tensor:
    """The render's gather in one launch. feats [v, fh, fw, c] (f32 or
    bf16; u8 with ``dequant`` = (scale, offset), each [c] f32); points
    [v, p, 2] f32 (x, y) in the (h, w) frame, converted to map pixels
    with align_corners iff the map is (h, w); mask [v, p] f32 -> [v, p, c]
    samples times the mask, in feats' dtype (u8: bf16). CUDA tensors go
    through the kernel, CPU tensors through ``gather_feature_map_ref``; an
    f32 map that requires grad through ``_GatherF32``."""
    dtypes = ((torch.float32, torch.bfloat16) if dequant is None
              else (torch.uint8,))
    cpu = _check(feats, points, dtypes, mask, dequant)
    if _needs_grad(feats):
        return _GatherF32.apply(feats, points, mask, h, w)
    return _gather(feats, points, mask, h, w, dequant, cpu)


def gather_bilinear_border_backward(grad_out: torch.Tensor,
                                    coords: torch.Tensor, fh: int,
                                    fw: int) -> torch.Tensor:
    """The gradient of ``gather_bilinear_border`` with respect to its f32
    map: grad_out [v, p, c] f32; coords [v, p, 2] f32 map pixels ->
    [v, fh, fw, c] f32. CUDA tensors: the tiled backward (one memset of
    its bins' counts and three kernels, every pixel written by them);
    CPU tensors: ``gather_bilinear_border_backward_ref``.
    """
    if _check_backward(grad_out, coords, fh, fw):
        return gather_bilinear_border_backward_ref(grad_out, coords, fh, fw)
    return _launch_backward(grad_out, coords, None, fh, fw, _MAP_PIXELS, 0, 0)


def gather_feature_map_backward(grad_out: torch.Tensor, points: torch.Tensor,
                                mask: torch.Tensor, h: int, w: int, fh: int,
                                fw: int) -> torch.Tensor:
    """The gradient of ``gather_feature_map`` with respect to its f32 map
    [v, fh, fw, c]: grad_out [v, p, c] f32; points [v, p, 2] f32 in the
    (h, w) frame; mask [v, p] f32 -> [v, fh, fw, c] f32. CUDA tensors: the
    tiled backward, as ``gather_bilinear_border_backward``; CPU tensors:
    ``gather_feature_map_backward_ref``."""
    if _check_backward(grad_out, points, fh, fw, mask):
        return gather_feature_map_backward_ref(grad_out, points, mask, h, w,
                                               fh, fw)
    return _launch_backward(grad_out, points, mask, fh, fw,
                            _frame(fh, fw, h, w), h, w)
