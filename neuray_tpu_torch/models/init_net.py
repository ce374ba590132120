"""Depth init net: raw visibility features G' per reference view (port of
``neuray_tpu/models/init_net.py``).

It normalizes the estimated metric depth into [0, 1] inverse depth,
computes cross-view rgb/depth consistency features by unprojecting each
view's depth map and sampling every view at the reprojections, then
encodes [imgs(3), depth(1), diff(8)] with a ``ResEncoder`` plus a
strided depth skip path. Maps are channels-last at the public functions.
With a compute ``dtype`` (bf16) only the encoder, the skip path and the
output conv run in it: the diff features are a function of the f32
data and stay f32.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from neuray_tpu_torch.models.blocks import Conv, nchw_to_nhwc, nhwc_to_nchw
from neuray_tpu_torch.models.resunet import ResEncoder
from neuray_tpu_torch.ops.gather import gather_bilinear_border
from neuray_tpu_torch.ops.geometry import (
    apply_affine, pose_inverse, project_points_in_image)
from neuray_tpu_torch.ops.interpolate import masked_mean_var


def extract_depth_for_init(depth_range: torch.Tensor,
                           depth: torch.Tensor) -> torch.Tensor:
    """Metric depth -> [0, 1] inverse depth.

    depth_range [rfn, 2]; depth [rfn, h, w, 1] -> [rfn, h, w, 1]
    """
    near = depth_range[:, 0][:, None, None, None]
    far = depth_range[:, 1][:, None, None, None]
    near_inv, far_inv = -1.0 / near, -1.0 / far
    depth = -1.0 / depth.clamp_min(1e-5)
    depth = (depth - near_inv) / (far_inv - near_inv)
    return depth.clamp(0.0, 1.0)


def depth2pts3d(depth: torch.Tensor, Ks: torch.Tensor,
                poses: torch.Tensor) -> torch.Tensor:
    """Unproject per-pixel depth to world points.

    depth [rfn, h, w, 1]; Ks [rfn, 3, 3]; poses [rfn, 3, 4]
    -> [rfn, h*w, 3]
    """
    rfn, h, w, _ = depth.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=depth.device),
        torch.arange(w, dtype=torch.float32, device=depth.device),
        indexing="ij")
    homog = torch.stack([xs, ys, torch.ones_like(xs)], -1)   # h,w,3
    pts = (depth * homog).reshape(rfn, h * w, 3)
    inv = pose_inverse(poses)                                 # rfn,3,4
    # K^-1 then the cam->world rigid transform, as one affine map
    m = torch.matmul(inv[:, :, :3], torch.linalg.inv_ex(Ks).inverse)
    m = torch.cat([m, inv[:, :, 3:]], dim=-1)                 # rfn,3,4
    return apply_affine(m[:, None], pts)


def get_diff_feats(imgs: torch.Tensor, depth_norm: torch.Tensor,
                   depth_range: torch.Tensor, poses: torch.Tensor,
                   Ks: torch.Tensor) -> torch.Tensor:
    """Cross-view rgb/depth consistency features.

    Every view's pixels are unprojected with its own depth and sampled
    in every view: rfn^2*h*w border gathers (align_corners=True at full
    resolution, so the projected pixel coords are the map's own), which
    go through the gather kernel on a CUDA tensor.

    imgs [rfn, h, w, 3]; depth_norm [rfn, h, w, 1]; depth_range
    [rfn, 2]; poses [rfn, 3, 4]; Ks [rfn, 3, 3] -> [rfn, h, w, 8]
    """
    rfn, h, w, _ = imgs.shape
    near = depth_range[:, 0][:, None, None, None]
    far = depth_range[:, 1][:, None, None, None]
    near_inv, far_inv = -1.0 / near, -1.0 / far
    depth = -1.0 / (depth_norm * (far_inv - near_inv) + near_inv)

    pts3d = depth2pts3d(depth, Ks, poses)                     # rfn,h*w,3
    pts2d, pts_dpt_prj, valid_mask = project_points_in_image(
        poses, Ks, h, w, pts3d.reshape(-1, 3))                # rfn,rfn*h*w
    tap = gather_bilinear_border(
        torch.cat([depth, imgs], dim=-1).contiguous(), pts2d.contiguous())
    pts_dpt_int, pts_rgb_int = tap[..., :1], tap[..., 1:]

    rgb_diff = (pts_rgb_int - imgs.reshape(1, rfn * h * w, 3)).abs()
    dpt_diff = (-1.0 / pts_dpt_int.clamp_min(1e-5)
                + 1.0 / pts_dpt_prj.clamp_min(1e-5)).abs()
    dpt_diff = dpt_diff / (far_inv - near_inv)[:, 0]          # rfn,1,1
    dpt_diff = dpt_diff.clamp_max(1.5)

    vm = valid_mask.to(torch.float32)[..., None]
    dpt_mean, dpt_var = masked_mean_var(dpt_diff, vm, 0)      # 1,rfn*h*w,1
    rgb_mean, rgb_var = masked_mean_var(rgb_diff, vm, 0)      # 1,rfn*h*w,3
    out = torch.cat([rgb_mean, rgb_var, dpt_mean, dpt_var], -1)
    return out.reshape(rfn, h, w, 8)


def upsample_half_pixel(x: torch.Tensor, s: int, h: int,
                        w: int) -> torch.Tensor:
    """Bilinear upsample of x [v, h', w', c] by s to [v, h, w, c] (h <= s*h',
    w <= s*w') with half-pixel centres: output o samples input
    (o + 0.5) / s - 0.5, clamped to the map at both ends. This is what
    ``jax.image.scale_and_translate(scale=s, translation=0,
    method="linear")`` computes in the JAX package (its comment there
    calls it corner-aligned; the arithmetic is half-pixel)."""
    up = F.interpolate(nhwc_to_nchw(x), scale_factor=s, mode="bilinear",
                       align_corners=False, recompute_scale_factor=False)
    return nchw_to_nhwc(up[..., :h, :w])


def get_diff_feats_subgrid(imgs: torch.Tensor, depth_norm: torch.Tensor,
                           depth_range: torch.Tensor, poses: torch.Tensor,
                           Ks: torch.Tensor, s: int) -> torch.Tensor:
    """``get_diff_feats`` on the 1/s pixel subgrid, rfn^2*h*w/s^2 gathers
    instead of rfn^2*h*w, upsampled back to [rfn, h, w, 8] by
    ``upsample_half_pixel``. Subgrid pixel i is original pixel s*i, so
    K' = diag(1/s, 1/s, 1) K."""
    scale = torch.full((3,), 1.0 / s, device=Ks.device)
    scale[2].fill_(1.0)     # on the device: a recorded step cannot copy
    diff = get_diff_feats(imgs[:, ::s, ::s], depth_norm[:, ::s, ::s],
                          depth_range, poses, Ks * scale[:, None])
    return upsample_half_pixel(diff, s, *imgs.shape[1:3])


class DepthInitNet(nn.Module):
    """ref imgs [rfn, h, w, 3] + estimated metric depth [rfn, h, w, 1]
    -> G' [rfn, h/4, w/4, 32].

    diff_scale s > 1 computes the cross-view diff features on the 1/s
    pixel subgrid (``get_diff_feats_subgrid``), an eval-time saving of
    the encode; s = 1 is exact."""

    def __init__(self, diff_scale: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.diff_scale = diff_scale
        self.res_net = ResEncoder(dtype)
        self.depth_skip_0 = Conv(1, 8, 2, 2, dtype=dtype)
        self.depth_skip_1 = Conv(8, 16, 2, 2, dtype=dtype)
        self.conv_out = Conv(48, 32, 1, dtype=dtype)

    def forward(self, ref: Dict[str, torch.Tensor]) -> torch.Tensor:
        imgs, depth = ref["imgs"], ref["depth"]
        depth_range, poses, Ks = ref["depth_range"], ref["poses"], ref["Ks"]
        depth_n = extract_depth_for_init(depth_range, depth)
        if self.diff_scale > 1:
            diff = get_diff_feats_subgrid(imgs, depth_n, depth_range, poses,
                                          Ks, self.diff_scale)
        else:
            diff = get_diff_feats(imgs, depth_n, depth_range, poses, Ks)
        feats = nhwc_to_nchw(self.res_net(
            torch.cat([imgs, depth_n, diff], dim=-1)))
        skip = F.relu(self.depth_skip_0(nhwc_to_nchw(depth_n)))
        skip = self.depth_skip_1(skip)
        return nchw_to_nhwc(self.conv_out(torch.cat([skip, feats], dim=1)))
