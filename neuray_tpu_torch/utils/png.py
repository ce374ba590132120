"""PNG files with zlib and numpy alone: the port's image reader and writer
(the JAX package reads and writes through ``cv2``, which the card's
machine does not have).

``read_png`` takes 8-bit, non-interlaced gray, RGB and RGBA files with any
of the five row filters and returns uint8 [h, w] (gray), [h, w, 3] (RGB)
or [h, w, 4] (RGBA), channels in file order (RGB(A)), as the JAX
package's ``_imread`` returns them. None, Sub (a running sum mod 256) and
Up are vectorized; Average and Paeth depend on the pixel to their left
and loop over each row's bytes in Python.

``write_png`` writes uint8 RGB or RGBA, every row unfiltered (filter
None).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}             # color type -> channels
_COLOR_TYPE = {3: 2, 4: 6}                  # channels -> color type


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


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(kind: int, row: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One filtered row (uint8, no filter byte) -> its raw bytes, given
    the previous row's raw bytes (zeros above the first row)."""
    if kind == 0:
        return row
    if kind == 1:
        return np.add.accumulate(row.reshape(-1, bpp), axis=0,
                                 dtype=np.uint8).reshape(-1)
    if kind == 2:
        return row + prior
    if kind not in (3, 4):
        raise ValueError(f"unknown PNG row filter {kind}")
    out = bytearray(row.tobytes())
    up = prior.tolist()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 3:
            pred = (left + up[i]) >> 1
        else:
            pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


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
    if (depth != 8 or color not in _CHANNELS or compression or filtering
            or interlace):
        raise NotImplementedError(
            f"{path}: bit depth {depth}, color type {color}, interlace "
            f"{interlace}; only 8-bit non-interlaced gray, RGB and RGBA")
    bpp = _CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data for "
                         f"{w}x{h}x{bpp}")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior,
                                       bpp)
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 img [h, w, 3] (RGB) or [h, w, 4] (RGBA) as an 8-bit
    PNG, every row with filter None."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"write_png takes uint8 [h, w, 3 or 4], got "
                         f"{img.dtype} {img.shape}")
    h, w, c = img.shape
    body = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], 1).tobytes()

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                             _COLOR_TYPE[c], 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(body))
                + chunk(b"IEND", b""))

