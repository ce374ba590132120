"""Bilinear feature interpolation (port of ``neuray_tpu/ops/interpolate.py``,
plain versions only).

``grid_sample_nhwc`` is the oracle: written with plain tensor indexing,
never ``F.grid_sample``. The render path samples with border padding
through ``interpolate_feature_map``, which is ``ops.gather.
gather_feature_map``: on CUDA tensors one launch of the gather kernel
converts the points to feature-map pixels, samples (an f32, bf16 or u8
map) and applies the mask; on CPU tensors its plain twin composes
``feature_pixel_coords``, the plain gather and the mask. ``quantize_u8``
and ``image_to_u8`` make the u8 maps.

Maps are channels-last [n, h, w, c], points are (x, y) pixel coords.
"""
from __future__ import annotations

import torch

from neuray_tpu_torch.ops.gather import (
    feature_pixel_coords, gather_feature_map)


def grid_sample_nhwc(feats: torch.Tensor, points: torch.Tensor,
                     h: int | None = None, w: int | None = None,
                     padding_mode: str = "zeros",
                     align_corners: bool = False) -> torch.Tensor:
    """Bilinear-sample channels-last maps at pixel coordinates.

    feats [n, fh, fw, c]; points [n, pn, 2] (x, y) in an (h, w) frame
    (defaults to (fh, fw)); padding_mode 'zeros' | 'border'.
    Returns [n, pn, c].
    """
    n, fh, fw, c = feats.shape
    if h is None and w is None:
        h, w = fh, fw
    pix = feature_pixel_coords(points, h, w, fh, fw, align_corners)
    ix, iy = pix[..., 0], pix[..., 1]

    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    tx = ix - x0
    ty = iy - y0
    x0 = x0.long()
    y0 = y0.long()
    x1 = x0 + 1
    y1 = y0 + 1

    if padding_mode == "zeros":
        def tap_mask(xi, yi):
            inb = (xi >= 0) & (xi < fw) & (yi >= 0) & (yi < fh)
            return inb.to(feats.dtype)
        m00, m01 = tap_mask(x0, y0), tap_mask(x1, y0)
        m10, m11 = tap_mask(x0, y1), tap_mask(x1, y1)
    elif padding_mode == "border":
        m00 = m01 = m10 = m11 = torch.ones_like(ix, dtype=feats.dtype)
    else:
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")

    x0c, x1c = x0.clamp(0, fw - 1), x1.clamp(0, fw - 1)
    y0c, y1c = y0.clamp(0, fh - 1), y1.clamp(0, fh - 1)
    flat = feats.reshape(n, fh * fw, c)

    def tap(yi, xi):
        idx = (yi * fw + xi)[..., None].expand(n, yi.shape[1], c)
        return torch.gather(flat, 1, idx)

    w00 = ((1 - tx) * (1 - ty) * m00)[..., None]
    w01 = (tx * (1 - ty) * m01)[..., None]
    w10 = ((1 - tx) * ty * m10)[..., None]
    w11 = (tx * ty * m11)[..., None]
    return (tap(y0c, x0c) * w00 + tap(y0c, x1c) * w01
            + tap(y1c, x0c) * w10 + tap(y1c, x1c) * w11)


def interpolate_feature_map(feats, coords, mask, h: int, w: int,
                            dequant=None):
    """Border-padded bilinear gather + zero out invalid projections;
    align_corners=True iff the map is at full (h, w) resolution. The mask
    is applied in the output's dtype.

    feats [n, fh, fw, c]; coords [n, pn, 2] f32; mask [n, pn] f32 ->
    [n, pn, c]. dequant: (scale, offset), each [c] f32, for a u8 map; the
    output is then bf16 ``sample * scale - offset``.
    """
    return gather_feature_map(feats, coords, mask, h, w, dequant)


def quantize_u8(feats: torch.Tensor):
    """Per-channel symmetric u8 quantization, as the JAX package's
    ``make_fused_scene_map_u8`` quantizes its feature quad: scale =
    max(absmax over views, rows and columns, 1e-8) / 127 in f32, codes
    clip(round(x / scale) + 128, 0, 255) (round half to even), and the
    scale and the offset 128 * scale stored as bf16 (128 is a power of
    two, so the offset is exact in bf16).

    feats [n, fh, fw, c] -> (codes [n, fh, fw, c] u8, scale [c] bf16,
    offset [c] bf16)
    """
    f = feats.float()
    scale = f.abs().amax(dim=(0, 1, 2)).clamp_min(1e-8) / 127.0
    codes = (torch.round(f / scale) + 128.0).clamp(0.0, 255.0)
    scale = scale.to(torch.bfloat16)
    return codes.to(torch.uint8), scale, scale * 128.0


def image_to_u8(imgs: torch.Tensor) -> torch.Tensor:
    """Images in [0, 1] -> u8 codes clip(round(x * 255), 0, 255): exact
    for images from 8-bit sources (dequantized with scale 1/255)."""
    return (imgs.float() * 255.0).round().clamp(0.0, 255.0).to(torch.uint8)


def masked_mean_var(feats: torch.Tensor, mask: torch.Tensor, dim: int):
    """Mean/var over ``dim`` counting only mask>0 entries."""
    mask = mask.to(feats.dtype)
    mask_sum = mask.sum(dim=dim, keepdim=True).clamp_min(1e-4)
    mean = (feats * mask).sum(dim=dim, keepdim=True) / mask_sum
    var = ((feats - mean) ** 2 * mask).sum(dim=dim, keepdim=True) / mask_sum
    return mean, var
