"""The C++ image helper (``csrc/imageio.cpp``): baseline JPEG reading and
writing, PNG row unfiltering and cv2's 8-bit blur and resizes, for the
port's data layer (the card's machine has no cv2 or PIL; the JAX package
reads, writes and resizes through cv2).

The helper is compiled with the system ``g++`` at first use, from the
source in this repository, into ``build/neuray_tpu_torch/`` keyed by a
hash of the source and the flags, and loaded with ctypes. A failed build
raises with the compiler's output; nothing falls back to another codec.

``read_jpeg`` decodes as ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` does
through libjpeg-turbo's default path (the islow IDCT, fancy upsampling,
the fixed-point YCbCr -> RGB tables), to the bit, and returns RGB (not
cv2's BGR) or gray. Progressive and arithmetic-coded files raise.
``write_jpeg`` writes the bytes ``cv2.imencode(".jpg", ...)`` writes
(libjpeg-turbo's compress path at cv2's defaults: baseline, 4:2:0, the
standard tables at the given quality, 95 by default).
``gaussian_blur_u8``, ``resize_area_u8`` and ``resize_linear_u8`` are
cv2's 8-bit fixed-point ``GaussianBlur`` and ``resize``, to the bit.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "imageio.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "neuray_tpu_torch"
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]


def build_library() -> Path:
    """Compile the helper (if not built yet) and return the path of the
    shared library. A failed build raises with g++'s output."""
    source = _SOURCE.read_bytes()
    key = hashlib.sha256(source + " ".join(_FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD_DIR / f"imageio_{key}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build "
                           f"{_SOURCE.name}, the port's image codec")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *_FLAGS, "-o", tmp, str(_SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SOURCE.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)      # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the helper, its entries bound."""
    lib = ctypes.CDLL(str(build_library()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.imageio_error.argtypes, lib.imageio_error.restype = [], \
        ctypes.c_char_p
    lib.jpeg_info.argtypes = [p, i64, ip, ip, ip]
    lib.jpeg_decode.argtypes = [p, i64, p]
    lib.jpeg_encode.argtypes = [p, i32, i32, i32, i32,
                                ctypes.POINTER(ctypes.c_void_p),
                                ctypes.POINTER(ctypes.c_int64)]
    lib.png_unfilter.argtypes = [p, i32, i64, i32, p]
    lib.gaussian_blur_u8.argtypes = [p, i32, i32, i32, i32, ctypes.c_double,
                                     p]
    lib.resize_area_u8.argtypes = [p, i32, i32, i32, i32, i32, p]
    lib.resize_linear_u8.argtypes = [p, i32, i32, i32, i32, i32, p]
    for fn in (lib.jpeg_info, lib.jpeg_decode, lib.jpeg_encode,
               lib.png_unfilter, lib.gaussian_blur_u8, lib.resize_area_u8,
               lib.resize_linear_u8):
        fn.restype = ctypes.c_int
    return lib


def _check(lib, code: int, what: str) -> None:
    if code:
        raise ValueError(f"{what}: {lib.imageio_error().decode()}")


def decode_jpeg(data: bytes, what: str = "JPEG data") -> np.ndarray:
    """JPEG bytes -> uint8 [h, w, 3] (RGB) or [h, w] (gray)."""
    lib = load_library()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.jpeg_info(data, len(data), ctypes.byref(h),
                              ctypes.byref(w), ctypes.byref(c)), what)
    out = np.empty((h.value, w.value, c.value), np.uint8)
    _check(lib, lib.jpeg_decode(data, len(data), out.ctypes.data), what)
    return out[:, :, 0] if c.value == 1 else out


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """uint8 [h, w, 3] (RGB) or [h, w] (gray) -> baseline JPEG bytes."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError(f"encode_jpeg takes uint8 [h, w] or [h, w, 3], got "
                         f"{img.dtype} {img.shape}")
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    lib = load_library()
    ptr, size = ctypes.c_void_p(), ctypes.c_int64()
    _check(lib, lib.jpeg_encode(img.ctypes.data, h, w, c, int(quality),
                                ctypes.byref(ptr), ctypes.byref(size)),
           "encode_jpeg")
    return ctypes.string_at(ptr, size.value)


def _u8_image(img: np.ndarray, what: str):
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"{what} takes uint8 [h, w] or [h, w, c], got "
                         f"{img.dtype} {img.shape}")
    img = np.ascontiguousarray(img)
    return img, 1 if img.ndim == 2 else img.shape[2]


def gaussian_blur_u8(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma, borderType=
    cv2.BORDER_REFLECT101)`` of uint8 [h, w] or [h, w, c], to the bit."""
    img, c = _u8_image(img, "gaussian_blur_u8")
    out = np.empty_like(img)
    lib = load_library()
    _check(lib, lib.gaussian_blur_u8(img.ctypes.data, img.shape[0],
                                     img.shape[1], c, int(ksize),
                                     float(sigma), out.ctypes.data),
           "gaussian_blur_u8")
    return out


def _resize_u8(fn: str, img: np.ndarray, dsize) -> np.ndarray:
    img, c = _u8_image(img, fn)
    w, h = int(dsize[0]), int(dsize[1])
    out = np.empty((h, w) + img.shape[2:], np.uint8)
    lib = load_library()
    _check(lib, getattr(lib, fn)(img.ctypes.data, img.shape[0], img.shape[1],
                                 c, h, w, out.ctypes.data), fn)
    return out


def resize_area_u8(img: np.ndarray, dsize) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)`` of uint8
    for a reduction, dsize (w, h), to the bit."""
    return _resize_u8("resize_area_u8", img, dsize)


def resize_linear_u8(img: np.ndarray, dsize) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR)`` of uint8,
    dsize (w, h), to the bit."""
    return _resize_u8("resize_linear_u8", img, dsize)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), str(path))


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    data = encode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)


def png_unfilter(raw: np.ndarray, h: int, stride: int,
                 bpp: int) -> np.ndarray:
    """PNG scanlines (h rows of a filter byte then stride bytes, uint8)
    -> the raw bytes [h, stride]; bpp is the bytes per pixel."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{raw.size} bytes of PNG scanlines for {h} rows "
                         f"of {stride}")
    out = np.empty((h, stride), np.uint8)
    lib = load_library()
    _check(lib, lib.png_unfilter(raw.ctypes.data, h, stride, bpp,
                                 out.ctypes.data), "PNG")
    return out


def jpeg_orientation(data: bytes) -> int:
    """The EXIF orientation tag (0x0112) of JPEG bytes, 1 without one."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (0xD9, 0xDA):
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            tiff = body[6:]
            order = "<" if tiff[:2] == b"II" else ">"
            (ifd,) = struct.unpack(order + "I", tiff[4:8])
            (count,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
            for k in range(count):
                entry = tiff[ifd + 2 + 12 * k:ifd + 14 + 12 * k]
                tag, kind = struct.unpack(order + "HH", entry[:4])
                if tag == 0x0112 and kind == 3:
                    return struct.unpack(order + "H", entry[8:10])[0]
            return 1
        pos += 2 + length
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """img turned upright for an EXIF orientation, as cv2.imread turns
    it (IMREAD_COLOR): 2 mirror, 3 rotate 180, 4 flip, 5 transpose, 6
    rotate 90 clockwise, 7 transverse, 8 rotate 90 counter-clockwise."""
    ops = {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
           6: lambda a: a.swapaxes(0, 1)[:, ::-1],
           7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
           8: lambda a: a.swapaxes(0, 1)[::-1]}
    return np.ascontiguousarray(ops.get(orientation, ops[1])(img))
