"""Image files for the port's data layer: ``imread`` and ``imwrite``, the
counterparts of the JAX package's ``_imread`` / ``_imsave``
(``neuray_tpu/data/database.py``), which call cv2.

``imread`` reads PNG (``utils/png.py``) and baseline JPEG
(``utils/codec.py``), told apart by their signatures, and returns what
``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` returns with the channels in
RGB(A) order: uint8 [h, w], [h, w, 3] or [h, w, 4], or uint16 [h, w] for
a 16-bit gray PNG. A missing file raises ``FileNotFoundError`` (cv2
returns None, on which the JAX package raises the same). ``imread_color``
reads as ``cv2.imread(path)`` (IMREAD_COLOR) does: 3 channels, a JPEG
turned upright by its EXIF orientation.

``imwrite`` writes by the extension: ``.png`` with ``write_png``,
``.jpg``/``.jpeg`` with ``write_jpeg`` at cv2's default quality 95; an
image of 3 or more channels is taken as RGB and its first three channels
are written, as the JAX package writes them (reversed to cv2's BGR).
"""
from __future__ import annotations

import os

import numpy as np

from neuray_tpu_torch.utils.codec import (
    apply_orientation, decode_jpeg, jpeg_orientation, write_jpeg)
from neuray_tpu_torch.utils.png import read_png, write_png

_PNG = b"\x89PNG\r\n\x1a\n"
_JPEG = b"\xff\xd8"


def imread(path) -> np.ndarray:
    path = str(path)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(_PNG):
        return read_png(path)
    if head.startswith(_JPEG):
        with open(path, "rb") as f:
            return decode_jpeg(f.read(), path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def imread_color(path) -> np.ndarray:
    """An image as ``cv2.imread(path)`` (IMREAD_COLOR) reads it, in RGB:
    gray repeated into 3 channels, alpha dropped, a JPEG turned upright
    by its EXIF orientation."""
    img = imread(path)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, 2)
    img = img[:, :, :3]
    with open(str(path), "rb") as f:
        head = f.read(2)
        if head == _JPEG:
            img = apply_orientation(img, jpeg_orientation(head + f.read()))
    return img


def imwrite(path, img: np.ndarray) -> None:
    path = str(path)
    ext = os.path.splitext(path)[1].lower()
    if img.ndim == 3 and img.shape[2] > 3:
        img = img[:, :, :3]
    if ext == ".png":
        write_png(path, np.ascontiguousarray(img))
    elif ext in (".jpg", ".jpeg"):
        write_jpeg(path, np.ascontiguousarray(img))
    else:
        raise ValueError(f"{path}: imwrite writes .png, .jpg and .jpeg")
