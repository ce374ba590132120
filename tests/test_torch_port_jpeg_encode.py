"""The port's JPEG encoder (``utils/codec.py: encode_jpeg``, the C++
``csrc/imageio.cpp: jpeg_encode``) against ``cv2.imencode(".jpg")``
(libjpeg-turbo), byte for byte: gray and RGB, sizes from 1x1 to 800x800
(MCU-aligned and not, odd widths and heights that leave dummy blocks in
the 4:2:0 MCU grid), qualities 50, 75, 95 and 100, on noise, smooth
ramps, saturated colours and a rendered sphere frame.
"""
import cv2
import numpy as np
import pytest
import torch

from neuray_tpu_torch.data.synthetic import look_at_camera, \
    render_spheres_view
from neuray_tpu_torch.utils import codec
from neuray_tpu_torch.utils.imageio import imwrite

torch.set_num_threads(1)

SIZES = [(1, 1), (7, 9), (8, 8), (15, 17), (16, 16), (33, 1000),
         (757, 1009), (800, 800)]
QUALITIES = [50, 75, 95, 100]


def content(kind, h, w):
    rng = np.random.RandomState(h * 7919 + w)
    y, x = np.mgrid[:h, :w]
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "ramp":
        return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                         (x + y) * 255 // max(h + w - 2, 1)],
                        -1).astype(np.uint8)
    if kind == "saturated":
        img = np.zeros((h, w, 3), np.uint8)
        img[..., 0] = 255 * ((x // 3) % 2)
        img[..., 1] = 255 * ((y // 5) % 2)
        img[..., 2] = 255
        return img
    pose, K = look_at_camera(rng, h, w)
    rgb = render_spheres_view(pose, K, h, w)[0]
    return np.clip(np.round(rgb * 255), 0, 255).astype(np.uint8)


def cv2_bytes(img, quality):
    bgr = img if img.ndim == 2 else np.ascontiguousarray(img[..., ::-1])
    ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return buf.tobytes()


def first_difference(a, b):
    n = min(len(a), len(b))
    return next((i for i in range(n) if a[i] != b[i]), n)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["noise", "ramp", "saturated", "sphere"])
def test_encode_jpeg_bytes_equal_cv2(size, kind):
    img = content(kind, *size)
    for quality in QUALITIES:
        for gray in (False, True):
            x = np.ascontiguousarray(img[..., 1]) if gray else img
            ours, theirs = codec.encode_jpeg(x, quality), cv2_bytes(x, quality)
            assert ours == theirs, (
                f"q{quality} gray={gray}: {len(ours)} vs {len(theirs)} "
                f"bytes, first difference at {first_difference(ours, theirs)}")


def test_write_jpeg_file_equals_cv2_imwrite(tmp_path):
    """imwrite's .jpg (RGB in, quality 95) is cv2.imwrite's file of the BGR
    twin; a gray [h, w, 1] image is written as gray."""
    img = content("sphere", 123, 77)
    imwrite(tmp_path / "ours.jpg", img)
    cv2.imwrite(str(tmp_path / "theirs.jpg"), img[..., ::-1])
    assert (tmp_path / "ours.jpg").read_bytes() == \
        (tmp_path / "theirs.jpg").read_bytes()
    gray = img[..., :1]
    codec.write_jpeg(str(tmp_path / "gray.jpg"), gray)
    assert (tmp_path / "gray.jpg").read_bytes() == cv2_bytes(gray[..., 0], 95)
