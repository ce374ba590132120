"""Cost-volume init net: raw visibility features G' from a frozen MVSNet
plane-sweep cost volume (port of ``neuray_tpu/models/cost_volume.py``;
reference network/init_net.py:103-254).

Per reference view, MVSNet builds the cost logits over ``sn``
inverse-depth planes from the view and its ``nn_ids`` source views; a
softmax makes them a probability volume and its expectation a depth map.
Both are encoded with the image features of a ``ResUNetLight`` into
G' [rfn, h/4, w/4, 32]. MVSNet is frozen: the volume is built without
autograd, as the JAX package's ``stop_gradient`` gives MVSNet exactly
zero gradients. At eval time, 1024x768 and 800x800 views go through
MVSNet at 768x576 and 640x640 and the logits are resized back.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from neuray_tpu_torch.models.blocks import (
    Conv, ReflectConv, ResidualBlock, nchw_to_nhwc, nhwc_to_nchw)
from neuray_tpu_torch.models.init_net import extract_depth_for_init
from neuray_tpu_torch.models.mvsnet import MVSNet, depth_regression
from neuray_tpu_torch.models.resunet import ResUNetLight

Tensors = Dict[str, torch.Tensor]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# eval-time MVSNet input size by view size (reference init_net.py:127-139)
EVAL_RESIZE = {(768, 1024): (576, 768), (800, 800): (640, 640)}


@functools.lru_cache(maxsize=None)
def _imagenet_norm(device: torch.device):
    """ImageNet's mean and std on ``device``, made once: a recorded
    training step (CUDA graphs) cannot copy from the host."""
    with torch.inference_mode(False):
        return tuple(torch.tensor(v, device=device)
                     for v in (IMAGENET_MEAN, IMAGENET_STD))


def construct_project_matrix(x_ratio: float, y_ratio: float,
                             Ks: torch.Tensor,
                             poses: torch.Tensor) -> torch.Tensor:
    """diag(x_ratio, y_ratio, 1) @ K @ pose, as [n, 4, 4] with the row
    (0, 0, 0, 1) (reference :103-111). The diagonal scales K's rows, the
    product with a diagonal matrix exactly."""
    # made on the device: a recorded training step (CUDA graphs) cannot
    # copy from the host
    scale = torch.ones(3, device=Ks.device)
    scale[0].fill_(x_ratio)
    scale[1].fill_(y_ratio)
    prj = torch.matmul(Ks * scale[:, None], poses)          # n,3,4
    pad = torch.zeros(Ks.shape[0], 1, 4, device=Ks.device)
    pad[:, :, 3] = 1.0
    return torch.cat([prj, pad], dim=1)


def get_depth_vals(depth_range: torch.Tensor, dn: int) -> torch.Tensor:
    """dn planes evenly spaced in inverse depth from near to far, the far
    plane pinned to far itself (reference :162-168) -> [n, dn]."""
    near, far = depth_range[:, 0], depth_range[:, 1]
    interval = (1 / far - 1 / near) / (dn - 1)
    ticks = torch.arange(0, dn - 1, dtype=torch.float32,
                         device=depth_range.device)
    vals = 1.0 / (1.0 / near[:, None] + ticks[None] * interval[:, None])
    return torch.cat([vals, far[:, None]], dim=1)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW x resized to (h, w) as the JAX package's ``jax.image.resize(
    ..., "bilinear")``: a triangle filter at half-pixel centres, widened
    by the scale where it downsamples (antialiased). That is
    ``F.interpolate(antialias=True)`` on a downsample and the plain
    bilinear ``F.interpolate`` on an upsample (the same filter; the plain
    kernel rounds closer to JAX's). Computed in f32, returned in x's
    dtype. (The JAX package's comment calls it ``F.interpolate(
    align_corners=False)``, which does not antialias: ROADMAP Queue 3,
    fault 7.)"""
    down = h < x.shape[-2] or w < x.shape[-1]
    y = F.interpolate(x.float(), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=down)
    return y.to(x.dtype)


class CostVolumeInitNet(nn.Module):
    """ref imgs [rfn, h, w, 3] (with ``nn_ids`` [rfn, nn] into src) and
    the src views -> G' [rfn, h/4, w/4, 32]."""

    def __init__(self, sn: int = 64, dtype: torch.dtype | None = None):
        super().__init__()
        self.sn = sn
        self.mvsnet = MVSNet(dtype)
        self.res_net = ResUNetLight(3, (2, 3, 6, 3), 32, 32, dtype)
        for name, cin in (("volume", sn), ("depth", 1), ("out", 96)):
            self.add_module(f"{name}_conv_in",
                            ReflectConv(cin, 32, 3, dtype=dtype))
            self.add_module(f"{name}_res", ResidualBlock(32, 32, dtype=dtype))
            self.add_module(f"{name}_conv_out",
                            Conv(32, 32, 1, bias=False, dtype=dtype))

    def _branch(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, f"{name}_conv_in")(x)
        return getattr(self, f"{name}_conv_out")(
            getattr(self, f"{name}_res")(x))

    @torch.no_grad()
    def build_cost_volume(self, ref: Tensors, src: Tensors,
                          is_train: bool = False):
        """(reference :113-160) -> (probability volume [rfn, sn, h/4,
        w/4] in the compute dtype, depth [rfn, h/4, w/4] f32), without
        autograd."""
        ref_imgs, src_imgs = ref["imgs"], src["imgs"]
        rfn, h, w, _ = ref_imgs.shape
        ratio, ref_, src_ = 1.0, ref_imgs, src_imgs
        if not is_train and (h, w) in EVAL_RESIZE:
            rh, rw = EVAL_RESIZE[(h, w)]
            ref_, src_ = (nchw_to_nhwc(resize_bilinear(
                nhwc_to_nchw(x), rh, rw)) for x in (ref_imgs, src_imgs))
            ratio = rh / h

        mean, std = _imagenet_norm(ref_imgs.device)
        ref_prj = construct_project_matrix(
            0.25 * ratio, 0.25 * ratio, ref["Ks"], ref["poses"])
        src_prj = construct_project_matrix(
            0.25 * ratio, 0.25 * ratio, src["Ks"], src["poses"])
        depth_vals = get_depth_vals(ref["depth_range"], self.sn)

        cost_reg = self.mvsnet((ref_ - mean) / std, (src_ - mean) / std,
                               ref["nn_ids"], ref_prj, src_prj, depth_vals)
        cost_reg = torch.nan_to_num(cost_reg, nan=0.0)
        if ratio != 1.0:
            cost_reg = resize_bilinear(cost_reg, h // 4, w // 4)
        prob = torch.softmax(cost_reg, dim=1)
        return prob, depth_regression(prob.float(), depth_vals)

    def forward(self, ref: Tensors, src: Tensors,
                is_train: bool = False) -> torch.Tensor:
        """ref / src imgs_info dicts (ref carries ``nn_ids``) -> G'
        (reference :247-254)."""
        prob, depth = self.build_cost_volume(ref, src, is_train)
        ref_feats = nhwc_to_nchw(self.res_net(ref["imgs"]))
        volume = self._branch("volume", prob)
        depth_n = extract_depth_for_init(ref["depth_range"], depth[..., None])
        depth_feats = self._branch("depth", depth_n.permute(0, 3, 1, 2))
        x = torch.cat([ref_feats, volume, depth_feats], dim=1)
        return nchw_to_nhwc(self._branch("out", x))
