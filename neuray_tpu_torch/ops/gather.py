"""Border-clamped bilinear gather: the wrapper of the hand-written CUDA
kernel ``csrc/gather_bilinear_border.cu`` and its plain PyTorch twin.

Port of the Pallas TPU kernel ``neuray_tpu/ops/pallas/gather.py``
(``gather_bilinear_border``). On the TPU that kernel lost to XLA's
gather and the renderer kept jnp gathers; here the kernel serves every
border gather of the render path: the per-chunk rgb and 64-channel
feature gathers and the scene encode's cross-view diff gather.

``gather_bilinear_border`` samples an f32 or bf16 map;
``gather_bilinear_border_u8`` samples a map of u8 codes and dequantizes
each channel affinely into bf16 (the u8 gather map of the bf16 route).
Each runs its kernel on CUDA tensors and its plain version on CPU
tensors, and nothing else: a CUDA tensor the kernel does not take
raises. The kernels are compiled with nvcc at first use, from the source
in this repository, into ``build/neuray_tpu_torch/`` keyed by a hash of
the source, and loaded with ctypes.
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

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / \
    "gather_bilinear_border.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "neuray_tpu_torch"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

# kernel launches (never the plain versions'): in all, and by the map's
# dtype ("f32", "bf16", "u8"); read and reset (``reset_launches``) by
# chip_smoke.py to prove the render path went through the kernels
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"f32": 0, "bf16": 0, "u8": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for k in LAUNCHES_BY_DTYPE:
        LAUNCHES_BY_DTYPE[k] = 0


def _count(dtype_name: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[dtype_name] += 1


def _lerp_f32(feats: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The border-clamped bilinear sample of feats [v, fh, fw, c] (any
    dtype, read as f32) at coords [v, p, 2] -> [v, p, c] f32."""
    v, fh, fw, c = feats.shape
    p = coords.shape[1]
    ixc = coords[..., 0].clamp(0.0, fw - 1.0)
    iyc = coords[..., 1].clamp(0.0, fh - 1.0)
    x0 = torch.floor(ixc).clamp(0.0, fw - 2.0)
    y0 = torch.floor(iyc).clamp(0.0, fh - 2.0)
    tx = (ixc - x0)[..., None]
    ty = (iyc - y0)[..., None]
    idx = y0.long() * fw + x0.long()                           # v,p
    flat = feats.reshape(v, fh * fw, c).float()

    def tap(offset: int):
        return torch.gather(flat, 1, (idx + offset)[..., None].expand(v, p, c))

    top = tap(0) * (1 - tx) + tap(1) * tx
    bot = tap(fw) * (1 - tx) + tap(fw + 1) * tx
    return top * (1 - ty) + bot * ty


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
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(str(build_library()))
    shape = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.gather_bilinear_border_f32,
               lib.gather_bilinear_border_bf16):
        fn.argtypes = [ctypes.c_void_p] * 3 + shape
        fn.restype = ctypes.c_int
    lib.gather_bilinear_border_u8.argtypes = [ctypes.c_void_p] * 5 + shape
    lib.gather_bilinear_border_u8.restype = ctypes.c_int
    return lib


def _check_args(feats: torch.Tensor, coords: torch.Tensor,
                dtypes=(torch.float32, torch.bfloat16)) -> None:
    if feats.dim() != 4:
        raise ValueError(f"feats must be [v, fh, fw, c], got {tuple(feats.shape)}")
    v, fh, fw, c = feats.shape
    if coords.dim() != 3 or coords.shape[0] != v or coords.shape[2] != 2:
        raise ValueError(f"coords must be [{v}, p, 2], got {tuple(coords.shape)}")
    if fh < 2 or fw < 2:
        raise ValueError(f"the map must be at least 2x2, got {fh}x{fw}")
    if feats.dtype not in dtypes:
        raise TypeError(f"feats must be one of {dtypes}, got {feats.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if not (feats.is_contiguous() and coords.is_contiguous()):
        raise ValueError("feats and coords must be contiguous")
    if feats.device != coords.device:
        raise ValueError(f"feats on {feats.device}, coords on {coords.device}")


def _check_device(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (the plain version), False for CUDA tensors
    (the kernel); raises on anything else."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no gather for device {dev}")
    if dev.type == "cuda" and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "gather_bilinear_border has no backward kernel yet; it comes "
            "with training support. Run the render under "
            "torch.inference_mode().")
    return dev.type == "cpu"


def _launch(name: str, dtype_name: str, ptrs, out: torch.Tensor, shape):
    """Launch the kernel ``name`` on the current stream of out's device
    and count it; raises on a launch error."""
    if out.numel() == 0:
        return out
    fn = getattr(load_library(), name)
    with torch.cuda.device(out.device):
        err = fn(*ptrs, out.data_ptr(), *shape,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _count(dtype_name)
    return out


def gather_bilinear_border(feats: torch.Tensor,
                           coords: torch.Tensor) -> torch.Tensor:
    """feats [v, fh, fw, c] f32 or bf16; coords [v, p, 2] f32 (x, y)
    feature-map pixels -> [v, p, c] border-clamped bilinear samples in
    feats' dtype. CUDA tensors go through the kernel, CPU tensors
    through ``gather_bilinear_border_ref``."""
    _check_args(feats, coords)
    if _check_device(feats, coords):
        return gather_bilinear_border_ref(feats, coords)
    v, fh, fw, c = feats.shape
    p = coords.shape[1]
    out = torch.empty((v, p, c), dtype=feats.dtype, device=feats.device)
    name = "f32" if feats.dtype == torch.float32 else "bf16"
    return _launch(f"gather_bilinear_border_{name}", name,
                   (feats.data_ptr(), coords.data_ptr()), out,
                   (v, p, fh, fw, c))


def gather_bilinear_border_u8(codes: torch.Tensor, coords: torch.Tensor,
                              scale: torch.Tensor,
                              offset: torch.Tensor) -> torch.Tensor:
    """codes [v, fh, fw, c] u8; coords [v, p, 2] f32 (x, y) map pixels;
    scale, offset [c] f32 -> [v, p, c] bf16: the border-clamped bilinear
    sample of the codes, dequantized per channel as
    ``sample * scale - offset``. CUDA tensors go through the kernel, CPU
    tensors through ``gather_bilinear_border_u8_ref``."""
    _check_args(codes, coords, (torch.uint8,))
    c = codes.shape[-1]
    for name, x in (("scale", scale), ("offset", offset)):
        if x.shape != (c,) or x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 [{c}], got "
                            f"{x.dtype} {tuple(x.shape)}")
        if x.device != codes.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {codes.device}")
    if _check_device(codes, coords, scale, offset):
        return gather_bilinear_border_u8_ref(codes, coords, scale, offset)
    v, fh, fw, _ = codes.shape
    p = coords.shape[1]
    out = torch.empty((v, p, c), dtype=torch.bfloat16, device=codes.device)
    return _launch("gather_bilinear_border_u8", "u8",
                   (codes.data_ptr(), coords.data_ptr(), scale.data_ptr(),
                    offset.data_ptr()), out, (v, p, fh, fw, c))
