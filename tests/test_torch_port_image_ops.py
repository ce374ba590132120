"""The port's numpy copies of the JAX data layer's cv2 calls
(``neuray_tpu_torch/data/image_ops.py``) against cv2 itself.

cv2's 8-bit paths are fixed point, so 8-bit images are held within one
level, the share of exact pixels printed (``pytest -s``); float depth
under INTER_NEAREST exactly; the decomposed K, R and camera centre within
1e-6, relative. Ratios: 0.25, 0.5, 800 -> 400 (NeRF-synthetic's
black_400) and LLFF's 4032 -> 1008 cache on a crop of an original.
"""
import cv2
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from neuray_tpu.data import database as jDB
from neuray_tpu_torch.data import image_ops as O


def image(h, w, seed=0):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 11.0 - k)
                    for k in range(3)], -1) + rng.randn(h, w, 3) * 20
    return np.clip(img, 0, 255).astype(np.uint8)


def within_one_level(name, ours, theirs):
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    diff = np.abs(ours.astype(np.int64) - theirs.astype(np.int64))
    print(f"{name}: max {diff.max()}, exact {np.mean(diff == 0):.4f}")
    assert diff.max() <= 1


RATIOS = {"0.25": (64, 96, 0.25), "0.5": (64, 96, 0.5),
          "800to400": (800, 800, 0.5), "0.78125": (64, 96, 0.78125)}


@pytest.mark.parametrize("ratio", list(RATIOS))
def test_blur_and_resizes_equal_cv2(ratio):
    h, w, r = RATIOS[ratio]
    img = image(h, w)
    within_one_level(f"blur {ratio}", O.downsample_gaussian_blur(img, r),
                     jDB.downsample_gaussian_blur(img, r))
    hn, wn = int(np.round(h * r)), int(np.round(w * r))
    within_one_level(f"linear {ratio}", O.resize_linear(img, (wn, hn)),
                     cv2.resize(img, (wn, hn),
                                interpolation=cv2.INTER_LINEAR))
    within_one_level(f"area {ratio}", O.resize_area(img, (wn, hn)),
                     cv2.resize(img, (wn, hn), interpolation=cv2.INTER_AREA))
    within_one_level(f"resize_img {ratio}", O.resize_img(img, r),
                     jDB.resize_img(img, r))


def test_llff_cache_reduction_on_a_crop():
    """LLFF's cache: the blur at ratio 1008 / 4032, then INTER_AREA by 4,
    on a 256x192 crop of a 4032x3024 original."""
    img = image(192, 256, seed=1)
    ratio = 1008 / 4032
    ours = O.resize_area(O.downsample_gaussian_blur(img, ratio), (64, 48))
    theirs = cv2.resize(jDB.downsample_gaussian_blur(img, ratio), (64, 48),
                        interpolation=cv2.INTER_AREA)
    within_one_level("llff 4032->1008 crop", ours, theirs)


@pytest.mark.parametrize("src,dst", [((720, 1280), (450, 800)),
                                     ((72, 128), (45, 80)),
                                     ((61, 83), (20, 31))])
def test_area_fractional_equals_cv2(src, dst):
    """RealEstate10K's 1280x720 frames -> 800x450, and others."""
    img = image(*src, seed=2)
    within_one_level(f"area {src}->{dst}", O.resize_area(img, dst[::-1]),
                     cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("dsize", [(40, 30), (100, 77), (83, 61), (27, 13),
                                   (400, 400)])
def test_nearest_equals_cv2_exactly(dsize):
    """Depth maps (f32) and masks (u8) under INTER_NEAREST."""
    rng = np.random.RandomState(3)
    depth = rng.rand(61, 83).astype(np.float32)
    np.testing.assert_array_equal(
        O.resize_nearest(depth, dsize),
        cv2.resize(depth, dsize, interpolation=cv2.INTER_NEAREST))
    mask = (depth > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        O.resize_nearest(mask, dsize),
        cv2.resize(mask, dsize, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("seed", range(6))
def test_decompose_projection_matrix_equals_cv2(seed):
    """K, R and the camera centre t[:3] / t[3] of P = s K [R | t], for
    either sign of s (IDR's world_mat may carry any scale)."""
    rng = np.random.RandomState(seed)
    K = np.array([[400.0 + 50 * rng.rand(), 0.3 * rng.randn(), 200],
                  [0, 410.0, 150], [0, 0, 1]])
    R = Rotation.random(random_state=seed).as_matrix()
    P = K @ np.concatenate([R, rng.randn(3, 1)], 1) * (
        [1.0, -2.5, 0.01][seed % 3])
    K0, R0, t0 = cv2.decomposeProjectionMatrix(P)[:3]
    K1, R1, t1 = O.decompose_projection_matrix(P)
    np.testing.assert_allclose(K1, K0, rtol=1e-6, atol=1e-6 * np.abs(K0).max())
    np.testing.assert_allclose(R1, R0, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t1[:3] / t1[3], t0[:3] / t0[3], rtol=1e-6,
                               atol=1e-9)
