"""PNG files with zlib, numpy and the port's C++ image helper
(``utils/codec.py``): the port's PNG reader and writer (the JAX package
reads and writes through ``cv2``, which the card's machine does not have).

``read_png`` takes non-interlaced 8-bit gray, RGB and RGBA files and
16-bit gray files, with any of the five row filters (undone in C++:
Average and Paeth depend on the byte to their left), and returns uint8
[h, w] (gray), [h, w, 3] (RGB) or [h, w, 4] (RGBA), channels in file
order (RGB(A)), or uint16 [h, w] for 16-bit gray, as the JAX package's
``_imread`` (``cv2.IMREAD_UNCHANGED``) returns them.

``write_png`` writes uint8 gray, RGB or RGBA and uint16 gray, every row
unfiltered (filter None).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from neuray_tpu_torch.utils.codec import png_unfilter

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}             # color type -> channels
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}            # channels -> color type


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + length


def read_png(path: str) -> np.ndarray:
    """An 8-bit non-interlaced gray, RGB or RGBA PNG file -> uint8
    [h, w], [h, w, 3] or [h, w, 4]; raises on any other kind."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if ((depth, color) not in ((8, 0), (8, 2), (8, 6), (16, 0))
            or compression or filtering or interlace):
        raise NotImplementedError(
            f"{path}: bit depth {depth}, color type {color}, interlace "
            f"{interlace}; only non-interlaced 8-bit gray, RGB and RGBA "
            "and 16-bit gray")
    c = _CHANNELS[color]
    bpp = c * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data for "
                         f"{w}x{h}x{bpp}")
    out = png_unfilter(raw, h, w * bpp, bpp)
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(h, w)
    return out.reshape(h, w) if c == 1 else out.reshape(h, w, c)


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 img [h, w] (gray), [h, w, 3] (RGB) or [h, w, 4] (RGBA)
    as an 8-bit PNG, or uint16 img [h, w] as a 16-bit gray one, every row
    with filter None."""
    gray16 = img.dtype == np.uint16 and img.ndim == 2
    if not gray16 and (img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4)))):
        raise ValueError(f"write_png takes uint8 [h, w], [h, w, 3 or 4] or "
                         f"uint16 [h, w], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    rows = (img.astype(">u2") if gray16 else img).reshape(h, -1).view(
        np.uint8)
    body = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h,
                                             16 if gray16 else 8,
                                             _COLOR_TYPE[c], 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(body, 1))
                + chunk(b"IEND", b""))

