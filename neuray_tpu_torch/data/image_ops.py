"""numpy counterparts of the cv2 calls of the JAX package's data layer
(``neuray_tpu/data/database.py``, ``train_databases.py``, ``llff.py``):
the card's machine has no cv2.

- ``downsample_gaussian_blur``: ``cv2.GaussianBlur`` with the kernel-size
  rule of the JAX package and ``BORDER_REFLECT101``;
- ``resize_linear`` / ``resize_img``: ``cv2.resize(..., INTER_LINEAR)``,
  and the blur before it;
- ``resize_area``: ``INTER_AREA``, the integer-factor box path and the
  fractional one;
- ``resize_nearest``: ``INTER_NEAREST``, source index ``floor(dst *
  src / dst)``;
- ``decompose_projection_matrix``: ``cv2.decomposeProjectionMatrix``'s
  K, R and homogeneous camera centre.

An 8-bit image goes through the C++ copies of cv2's own fixed-point code
(``utils/codec.py``: ``gaussian_blur_u8``, ``resize_linear_u8``,
``resize_area_u8``), equal to cv2's result to the bit; a float image
through the numpy code here. ``tests/test_torch_port_image_ops.py`` holds
each one to cv2.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import correlate1d

from neuray_tpu_torch.utils import codec

_COEF_BITS = 11                      # cv2's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _check_dtype(img: np.ndarray) -> bool:
    """True for uint8 (the C++ path), False for float; other types raise."""
    if img.dtype == np.uint8:
        return True
    if not np.issubdtype(img.dtype, np.floating):
        raise NotImplementedError(f"cv2's paths for {img.dtype} are not "
                                  "copied: uint8 and float only")
    return False


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)`` for sigma > 0 (double)."""
    x = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return k / k.sum()


def downsample_gaussian_blur(img: np.ndarray, ratio: float) -> np.ndarray:
    """The blur the JAX package applies before downsampling by ratio:
    sigma (1 / ratio) / 3, an odd kernel of ceil(((sigma - 0.8) / 0.3 +
    1) * 2 + 1) taps, BORDER_REFLECT101."""
    sigma = (1 / ratio) / 3
    ksize = int(np.ceil(((sigma - 0.8) / 0.3 + 1) * 2 + 1))
    ksize = ksize + 1 if ksize % 2 == 0 else ksize
    if ksize == 1:
        return img.copy()                    # cv2 copies a 1x1 kernel
    if _check_dtype(img):
        return codec.gaussian_blur_u8(img, ksize, sigma)
    kernel = gaussian_kernel(ksize, sigma)
    # scipy's 'mirror' border is BORDER_REFLECT101 (dcb|abcd|cba), as is
    # numpy's 'reflect'; down the rows, whole shifted rows are summed
    rows = correlate1d(img.astype(np.float32), kernel, 1, mode="mirror")
    r, n = ksize // 2, img.shape[0]
    padded = np.pad(rows, [(r, r)] + [(0, 0)] * (img.ndim - 1),
                    mode="reflect")
    out = np.zeros_like(rows)
    for i, k in enumerate(kernel):
        out += np.float32(k) * padded[i:i + n]
    return out.astype(img.dtype)


def _linear_taps(src: int, dst: int):
    """INTER_LINEAR's source index and 11-bit weights along one axis."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    low = s < 0
    f[low], s[low] = 0, 0
    high = s >= src - 1
    f[high], s[high] = 0, src - 1
    w0 = np.rint((np.float32(1) - f) * _COEF_SCALE).astype(np.int64)
    return s, np.minimum(s + 1, src - 1), w0, _COEF_SCALE - w0


def _is_integer_scale(src_w, src_h, dst_w, dst_h, k=None) -> bool:
    sx, sy = 1.0 / (dst_w / src_w), 1.0 / (dst_h / src_h)
    ok = sx == int(sx) and sy == int(sy) and sx >= 1 and sy >= 1
    return ok if k is None else ok and int(sx) == k and int(sy) == k


def resize_linear(img: np.ndarray, dsize) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR)``, dsize
    (w, h): half-pixel centres, edges clamped; an exact 2x reduction in
    both axes takes the area path, as cv2 does."""
    if _check_dtype(img):
        return codec.resize_linear_u8(img, dsize)
    w, h = int(dsize[0]), int(dsize[1])
    sh, sw = img.shape[:2]
    if _is_integer_scale(sw, sh, w, h, 2):
        return resize_area(img, dsize)
    xs0, xs1, ax0, ax1 = _linear_taps(sw, w)
    ys0, ys1, ay0, ay1 = _linear_taps(sh, h)
    extra = (None,) * (img.ndim - 2)
    src = img.astype(np.float32)
    fx1 = (ax1 / _COEF_SCALE).astype(np.float32)[(slice(None),) + extra]
    fy1 = (ay1 / _COEF_SCALE).astype(np.float32)[(slice(None), None) + extra]
    rows = src[:, xs0] * (1 - fx1) + src[:, xs1] * fx1
    return (rows[ys0] * (1 - fy1) + rows[ys1] * fy1).astype(img.dtype)


def resize_img(img: np.ndarray, ratio: float) -> np.ndarray:
    """The JAX package's ``resize_img``: the blur, then INTER_LINEAR to
    round(h * ratio) x round(w * ratio)."""
    h, w = img.shape[:2]
    hn, wn = int(np.round(h * ratio)), int(np.round(w * ratio))
    return resize_linear(downsample_gaussian_blur(img, ratio), (wn, hn))


def _area_taps(src: int, dst: int):
    """INTER_AREA's taps along one axis (cv2's computeResizeAreaTab): each
    output cell covers src / dst inputs, partial inputs at its ends
    weighted by the share they cover. Returns (source indices, weights),
    each [dst, taps], unused taps weighted 0."""
    scale = 1.0 / (dst / src)
    taps = int(np.ceil(scale)) + 1
    idx = np.zeros((dst, taps), np.int64)
    wts = np.zeros((dst, taps), np.float64)
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        cells = []
        if sx1 - fsx1 > 1e-3:
            cells.append((sx1 - 1, (sx1 - fsx1) / cell))
        cells += [(sx, 1 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            cells.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        for k, (sx, wt) in enumerate(cells):
            idx[dx, k], wts[dx, k] = sx, wt
    return idx, wts


def resize_area(img: np.ndarray, dsize) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)`` for a
    reduction, dsize (w, h): the box mean of each k x k block for an
    integer factor k, else each output the covered-area-weighted mean."""
    w, h = int(dsize[0]), int(dsize[1])
    sh, sw = img.shape[:2]
    if w > sw or h > sh:
        raise NotImplementedError("resize_area reduces only")
    if _check_dtype(img):
        return codec.resize_area_u8(img, dsize)
    if _is_integer_scale(sw, sh, w, h):
        kx, ky = sw // w, sh // h
        blocks = img.reshape(h, ky, w, kx, *img.shape[2:])
        s = blocks.astype(np.float64).sum((1, 3)) * np.float32(1 / (kx * ky))
        return s.astype(img.dtype)
    (iy, wy), (ix, wx) = _area_taps(sh, h), _area_taps(sw, w)
    extra = (None,) * (img.ndim - 2)
    src = img.astype(np.float64)
    rows = sum(src[iy[:, k]] * wy[(slice(None), k, None) + extra]
               for k in range(iy.shape[1]))                     # h, sw, ...
    out = sum(rows[:, ix[:, k]] * wx[(None, slice(None), k) + extra]
              for k in range(ix.shape[1]))
    return out.astype(img.dtype)


def resize_nearest(img: np.ndarray, dsize) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=cv2.INTER_NEAREST)``, dsize
    (w, h): source index min(floor(x * (1 / (w / src_w))), src_w - 1)."""
    w, h = int(dsize[0]), int(dsize[1])
    sh, sw = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(
        np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(
        np.int64), sh - 1)
    return np.ascontiguousarray(img[ys][:, xs])


def decompose_projection_matrix(P: np.ndarray):
    """``cv2.decomposeProjectionMatrix(P)[:3]`` for P [3, 4]: (K [3, 3]
    upper triangular, R [3, 3] a rotation, t [4, 1] the camera centre in
    homogeneous coordinates), P[:, :3] = K @ R. The RQ decomposition is
    unique once K[0, 0] > 0, K[1, 1] > 0 and det R = +1, which is where
    cv2's Givens rotations and their 180-degree corrections land; t is the
    unit null vector of P (its sign is arbitrary in cv2 too: callers use
    t[:3] / t[3])."""
    P = np.asarray(P, np.float64)
    M = P[:, :3]
    flip = np.eye(3)[::-1]
    q, r = np.linalg.qr((flip @ M).T)
    K = flip @ r.T @ flip
    R = flip @ q.T
    d = np.sign(np.diag(K))
    d[d == 0] = 1
    d[2] = d[0] * d[1] * np.sign(np.linalg.det(R))
    K, R = K * d[None], d[:, None] * R
    _, _, vt = np.linalg.svd(np.concatenate([P, np.zeros((1, 4))], 0))
    return K, R, vt[-1][:, None]
