"""MVSNet, the plane-sweep stereo net of the cost-volume init net (port of
``neuray_tpu/models/mvsnet.py``; reference network/mvsnet/mvsnet.py and
modules.py).

``FeatureNet`` maps images to 32-channel features at 1/4 resolution;
for each reference view ``MVSNet`` warps its source views' features onto
``dn`` fronto-parallel planes (``homo_warp``), takes the variance over
the views, and ``CostRegNet`` (a 3-D conv U-Net) regularizes it into
[dn, h/4, w/4] cost logits. The reference's InPlaceABN is frozen
(``FrozenBN``: running statistics, then leaky_relu(0.01)).

``MVSNet`` takes the JAX package's channels-last images; inside, the 2-D
features are NCHW and the volumes NCDHW, PyTorch's conv layouts, so the
warp writes the volume in the layout ``nn.Conv3d`` reads. One reference
view's volume lives at a time, as in the JAX package's loop. With a
compute ``dtype`` (bf16) the convs run in it and return it; the frozen
norms, the warp and the variance are f32, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from neuray_tpu_torch.models.blocks import Conv, Conv3d, ConvTranspose3d


class FrozenBN(nn.Module):
    """Inference-mode BatchNorm, then leaky_relu(0.01): (x - mean) *
    rsqrt(var + 1e-5) * weight + bias over dim 1, in f32. ``mean`` and
    ``var`` are parameters that take no gradient (the flax tree holds
    them as params)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.var = nn.Parameter(torch.ones(features), requires_grad=False)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (x.dim() - 2)
        y = ((x.float() - self.mean.view(shape))
             * torch.rsqrt(self.var + self.eps).view(shape)
             * self.weight.view(shape) + self.bias.view(shape))
        return F.leaky_relu(y, 0.01)


class ConvBnReLU(nn.Module):
    """Conv2d (zero padding, no bias) + FrozenBN on NCHW."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, pad: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = Conv(in_ch, features, kernel, stride, bias=False,
                         dtype=dtype, padding=pad)
        self.bn = FrozenBN(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class ConvBnReLU3D(nn.Module):
    """Conv3d (k3, zero padding 1, no bias) + FrozenBN on NCDHW."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = Conv3d(in_ch, features, 3, stride, 1, dtype=dtype)
        self.bn = FrozenBN(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class _DeconvBn(nn.Module):
    """ConvTranspose3d(k3, s2, p1, output_padding=1) + FrozenBN."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = ConvTranspose3d(in_ch, features, dtype)
        self.bn = FrozenBN(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class FeatureNet(nn.Module):
    """NCHW images [n, 3, h, w] -> 32-ch features [n, 32, h/4, w/4]."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        for i, (cin, cout, k, s, p) in enumerate(
                [(3, 8, 3, 1, 1), (8, 8, 3, 1, 1), (8, 16, 5, 2, 2),
                 (16, 16, 3, 1, 1), (16, 16, 3, 1, 1), (16, 32, 5, 2, 2),
                 (32, 32, 3, 1, 1)]):
            self.add_module(f"conv{i}", ConvBnReLU(cin, cout, k, s, p, dtype))
        self.feature = Conv(32, 32, 3, dtype=dtype, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(7):
            x = getattr(self, f"conv{i}")(x)
        return self.feature(x)


class CostRegNet(nn.Module):
    """3-D conv U-Net: NCDHW volumes [n, 32, dn, h, w] (dn, h and w
    multiples of 8) -> 1-channel logits [n, 1, dn, h, w]."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        dt = dtype
        self.conv0 = ConvBnReLU3D(32, 8, dtype=dt)
        self.conv1 = ConvBnReLU3D(8, 16, 2, dt)
        self.conv2 = ConvBnReLU3D(16, 16, dtype=dt)
        self.conv3 = ConvBnReLU3D(16, 32, 2, dt)
        self.conv4 = ConvBnReLU3D(32, 32, dtype=dt)
        self.conv5 = ConvBnReLU3D(32, 64, 2, dt)
        self.conv6 = ConvBnReLU3D(64, 64, dtype=dt)
        self.conv7 = _DeconvBn(64, 32, dt)
        self.conv9 = _DeconvBn(32, 16, dt)
        self.conv11 = _DeconvBn(16, 8, dt)
        self.prob = Conv3d(8, 1, 3, 1, 1, bias=True, dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return self.prob(x)


def homo_warp(src_feat: torch.Tensor, src_proj: torch.Tensor,
              ref_proj_inv: torch.Tensor,
              depth_values: torch.Tensor) -> torch.Tensor:
    """Warp source features onto the reference view's depth planes, the
    NCDHW counterpart of the JAX package's ``homo_warp``.

    src_feat [n, c, h, w]; src_proj, ref_proj_inv [n, 4, 4]; depth_values
    [n, dn] -> [n, c, dn, h, w] in f32. Each reference pixel (x, y) at
    depth d maps to src_proj @ ref_proj_inv @ (x d, y d, d, 1); z is
    clamped from below at 1e-4 (unsigned, as the reference does: a point
    behind the source camera projects through at a large coordinate) and
    the features are sampled bilinearly with zeros outside the map,
    align_corners=True (``F.grid_sample``). Pixel coordinates more than a
    pixel outside the map are clamped there first: every tap stays
    outside, and the int32 index of the CUDA sampler cannot overflow."""
    n, c, h, w = src_feat.shape
    dn = depth_values.shape[1]
    transform = torch.matmul(src_proj, ref_proj_inv)
    rot = transform[:, :3, :3]
    trans = transform[:, :3, 3:]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=src_feat.device),
        torch.arange(w, dtype=torch.float32, device=src_feat.device),
        indexing="ij")
    grid = torch.stack([xs, ys, torch.ones_like(xs)], 0).reshape(3, h * w)
    grid_d = grid[None, :, None, :] * depth_values[:, None, :, None]
    src = torch.einsum("nij,njdp->nidp", rot, grid_d) + trans[..., None]
    z = src[:, 2].clamp_min(1e-4)
    px = (src[:, 0] / z).clamp(-2.0, w + 1.0)
    py = (src[:, 1] / z).clamp(-2.0, h + 1.0)
    grid_n = torch.stack([px / (w - 1.0) * 2.0 - 1.0,
                          py / (h - 1.0) * 2.0 - 1.0], -1)  # n,dn,h*w,2
    warped = F.grid_sample(src_feat.float(), grid_n, mode="bilinear",
                           padding_mode="zeros", align_corners=True)
    return warped.reshape(n, c, dn, h, w)


def depth_regression(prob: torch.Tensor,
                     depth_values: torch.Tensor) -> torch.Tensor:
    """prob [n, dn, h, w]; depth_values [n, dn] -> [n, h, w]."""
    return torch.sum(prob * depth_values[:, :, None, None], dim=1)


class MVSNet(nn.Module):
    """Feature extraction + per-reference-view cost volume
    regularization (reference mvsnet.py:160-188)."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.feature = FeatureNet(dtype)
        self.cost_regularization = CostRegNet(dtype)

    def forward(self, ref_imgs: torch.Tensor, src_imgs: torch.Tensor,
                nn_ids: torch.Tensor, ref_prjs: torch.Tensor,
                src_prjs: torch.Tensor,
                depth_values: torch.Tensor) -> torch.Tensor:
        """ref_imgs [rfn, h, w, 3], src_imgs [srn, h, w, 3] (channels-last,
        imagenet-normalized); nn_ids [rfn, nn] (indices into the src
        arrays); ref_prjs, src_prjs [., 4, 4] (scaled to the 1/4 maps);
        depth_values [rfn, dn] -> cost logits [rfn, dn, h/4, w/4]."""
        ref_feats = self.feature(ref_imgs.permute(0, 3, 1, 2))
        src_feats = self.feature(src_imgs.permute(0, 3, 1, 2))
        ref_prjs_inv = torch.linalg.inv(ref_prjs)
        n_num = nn_ids.shape[1]
        costs = []
        for i in range(ref_feats.shape[0]):
            ref = ref_feats[i]                               # c,h4,w4
            vol_sum = ref.float()[:, None]
            vol_sq = (ref * ref).float()[:, None]
            for ni in range(n_num):
                j = nn_ids[i, ni:ni + 1]
                warp = homo_warp(src_feats.index_select(0, j),
                                 src_prjs.index_select(0, j),
                                 ref_prjs_inv[i:i + 1],
                                 depth_values[i:i + 1])[0]   # c,dn,h4,w4
                vol_sum = vol_sum + warp
                vol_sq = vol_sq + warp * warp
            var = vol_sq / (n_num + 1) - (vol_sum / (n_num + 1)) ** 2
            del vol_sum, vol_sq
            costs.append(self.cost_regularization(var[None])[0, 0])
        return torch.stack(costs)
