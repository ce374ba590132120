"""The port's image codecs (``utils/codec.py``, the C++ helper
``csrc/imageio.cpp``; ``utils/png.py``; ``utils/imageio.py``) against
cv2, which the JAX package reads and writes with.

JPEG decoding is held to ``cv2.imread(..., IMREAD_UNCHANGED)``
(libjpeg-turbo) bit for bit on cv2-written files: 4:2:0, 4:2:2, 4:4:4 and
gray, with and without restart intervals and an EXIF segment, at odd
sizes. JPEG encoding at quality 95 is held to >= 40 dB from the source
when cv2 decodes it, and the port's decoder to cv2's on those files. A
progressive file raises. PNG: 16-bit gray both ways and through every row
filter cv2 writes.
"""
import struct
import time

import cv2
import numpy as np
import pytest

from neuray_tpu_torch.utils import codec
from neuray_tpu_torch.utils.imageio import imread, imwrite
from neuray_tpu_torch.utils.png import read_png, write_png

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
SIZES = [(1, 1), (3, 2), (17, 9), (37, 53), (64, 64), (123, 201)]


def smooth_image(h, w, c=3, noise=20.0, seed=0, period=1.0):
    """Waves plus noise: every DCT band and the clamps get used."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w] / period
    img = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 11.0 - k)
                    for k in range(c)], -1) + rng.randn(h, w, c) * noise
    return np.clip(img, 0, 255).astype(np.uint8)


def with_exif(data: bytes) -> bytes:
    """data with an EXIF APP1 segment (orientation 1) after its SOI."""
    tiff = (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHII", 0x0112, 3, 1, 1) + struct.pack("<I", 0))
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + \
        body + data[2:]


def cv2_decode(data: bytes) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return img[..., ::-1] if img.ndim == 3 else img


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("exif", [False, True])
def test_jpeg_decode_equals_cv2(size, kind, restart, exif):
    """Bit-equal to libjpeg-turbo's default decode, as cv2 reads it."""
    h, w = size
    img = smooth_image(h, w)
    flags = [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL,
             restart]
    if kind == "gray":
        img = img[..., 0]
    else:
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind]]
    ok, buf = cv2.imencode(".jpg", img, flags)
    assert ok
    data = buf.tobytes()
    if exif:
        data = with_exif(data)
    ours = codec.decode_jpeg(data)
    theirs = cv2_decode(data)
    assert ours.dtype == np.uint8 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


def test_jpeg_decode_large_and_timed(tmp_path):
    """A 1008x756 4:2:0 file (LLFF's cache size) read through ``imread``
    bit-equal to cv2.imread; the seconds are printed (``pytest -s``)."""
    img = smooth_image(756, 1008)
    path = str(tmp_path / "big.jpg")
    cv2.imwrite(path, img)
    t0 = time.perf_counter()
    ours = imread(path)
    seconds = time.perf_counter() - t0
    np.testing.assert_array_equal(
        ours, cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1])
    print(f"read_jpeg 1008x756: {seconds:.4f} s")


@pytest.mark.parametrize("size", [(756, 1008), (37, 53), (8, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("gray", [False, True])
def test_jpeg_encode_quality(tmp_path, size, gray):
    """The port writes quality-95 baseline JPEG (4:2:0 in colour), as
    cv2.imwrite does: cv2 decodes it >= 40 dB from a smooth source, as
    close as cv2's own file of the same image, and the port's decoder
    gives cv2's pixels."""
    img = smooth_image(*size, noise=2.0, period=4.0)
    if gray:
        img = img[..., 0]
    path = str(tmp_path / "ours.jpg")
    imwrite(path, img)
    theirs = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if not gray:
        theirs = theirs[..., ::-1]
    assert theirs.shape == img.shape

    def psnr(a):
        mse = np.mean((a.astype(np.float64) - img) ** 2)
        return 10 * np.log10(255 ** 2 / max(mse, 1e-12))

    ok, buf = cv2.imencode(".jpg", img if gray else img[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 95])
    ref = cv2_decode(buf.tobytes())
    assert psnr(theirs) >= 40.0
    assert psnr(theirs) >= psnr(ref) - 0.5
    np.testing.assert_array_equal(imread(path), theirs)
    print(f"{size} gray={gray}: {psnr(theirs):.2f} dB (cv2's own file "
          f"{psnr(ref):.2f} dB)")


@pytest.mark.parametrize("kind", ["progressive", "arithmetic", "garbage"])
def test_jpeg_refuses_other_kinds(kind):
    img = smooth_image(16, 16)
    if kind == "progressive":
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        data, match = buf.tobytes(), "progressive"
    elif kind == "arithmetic":
        ok, buf = cv2.imencode(".jpg", img)
        data = bytearray(buf.tobytes())
        at = data.index(b"\xff\xc0")
        data[at + 1] = 0xC9                  # SOF9: arithmetic sequential
        data, match = bytes(data), "arithmetic"
    else:
        data, match = b"\xff\xd8\xff\xd9", "no frame"
    with pytest.raises(ValueError, match=match):
        codec.decode_jpeg(data)


def test_png_16bit_round_trip_and_cv2(tmp_path):
    """16-bit gray PNG (GSO's depth, mm): the port writes what cv2 reads
    and reads what cv2 writes (big-endian samples, uint16 out)."""
    depth = np.random.RandomState(0).randint(0, 65536, (23, 31)).astype(
        np.uint16)
    ours = str(tmp_path / "ours.png")
    write_png(ours, depth)
    np.testing.assert_array_equal(cv2.imread(ours, cv2.IMREAD_UNCHANGED),
                                  depth)
    back = read_png(ours)
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back, depth)
    for filt in (cv2.IMWRITE_PNG_FILTER_NONE, cv2.IMWRITE_PNG_FILTER_SUB,
                 cv2.IMWRITE_PNG_FILTER_UP, cv2.IMWRITE_PNG_FILTER_AVG,
                 cv2.IMWRITE_PNG_FILTER_PAETH, cv2.IMWRITE_PNG_ALL_FILTERS):
        theirs = str(tmp_path / f"cv2_{filt}.png")
        assert cv2.imwrite(theirs, depth, [cv2.IMWRITE_PNG_FILTER, filt])
        np.testing.assert_array_equal(imread(theirs), depth)


def test_png_gray_8bit_both_ways(tmp_path):
    mask = (np.random.RandomState(1).rand(19, 27) > 0.5).astype(np.uint8) * 255
    path = str(tmp_path / "mask.png")
    imwrite(path, mask)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  mask)
    np.testing.assert_array_equal(imread(path), mask)


def test_imwrite_takes_rgb_and_drops_alpha(tmp_path):
    """imwrite writes the first three channels as RGB, as the JAX
    package's _imsave writes them through cv2."""
    rgba = np.random.RandomState(2).randint(0, 256, (9, 11, 4)).astype(
        np.uint8)
    path = str(tmp_path / "x.png")
    imwrite(path, rgba)
    np.testing.assert_array_equal(
        cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1], rgba[..., :3])
    with pytest.raises(ValueError, match="writes"):
        imwrite(str(tmp_path / "x.bmp"), rgba)
    with pytest.raises(FileNotFoundError):
        imread(str(tmp_path / "missing.png"))
