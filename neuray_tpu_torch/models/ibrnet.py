"""Cross-view aggregation MLP + along-ray attention (port of
``neuray_tpu/models/ibrnet.py``, ``IBRNetWithNeuRay(view_major=True)``,
and the plain ``IBRNet``, which no config uses).

``IBRNetWithNeuRay``'s inputs stay view-major, [rfn, b, dn, f], the
layout the projection and gather stage produces; views are reduced over
dim 0. ``IBRNet`` takes the JAX module's [b, dn, rfn, f].

With a compute ``dtype`` (bf16) the dense layers run in it and the rest
follows the JAX package's type promotion op for op: a bf16 tensor with
an f32 tensor of one or more dims gives f32 in both libraries. So the
view weights (from the f32 mask) make the pooled statistics f32, the
f32 position table makes the strided and exact passes' attention input
f32 while the focused pass's fractional positions are cast to bf16,
and LayerNorm, whose parameters are f32, returns f32.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from neuray_tpu_torch.models.blocks import Dense


def sinusoid_pos_encoding(d_hid: int, n_samples: int) -> np.ndarray:
    """Sinusoidal table [1, n_samples, d_hid]."""
    pos = np.arange(n_samples)[:, None]
    hid = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (hid // 2) / d_hid)
    table = np.zeros_like(angle)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pos_table(n_samples: int, dn: int, stride: int,
               device: torch.device) -> torch.Tensor:
    """Rows 0, stride, ... of the [1, max(n_samples, dn * stride), 16]
    sinusoid table, dn of them, f32 on ``device``; made once, so a pass
    adds it without a copy from the host (which a CUDA graph cannot
    capture)."""
    table = sinusoid_pos_encoding(16, max(n_samples, dn * stride))
    with torch.inference_mode(False):
        return torch.from_numpy(
            np.ascontiguousarray(table[:, ::stride][:, :dn])).to(device)


def sinusoid_pos_at(d_hid: int, pos: torch.Tensor) -> torch.Tensor:
    """The sinusoid table's formula at fractional positions: pos [..., dn]
    -> [..., dn, d_hid]; integer positions give the table's rows."""
    hid = torch.arange(d_hid, device=pos.device)
    denom = torch.pow(10000.0, (2 * (hid // 2) / d_hid).float())
    angle = pos[..., None] / denom
    return torch.where(hid % 2 == 0, torch.sin(angle), torch.cos(angle))


class MultiHeadAttention(nn.Module):
    """Post-LN multi-head self-attention with residual (LayerNorm eps
    1e-6). Q, K and V come from one packed projection of the input.
    With a compute ``dtype`` the projections, scores, softmax and ``fc``
    run in it; the residual keeps the input's dtype and LayerNorm
    computes in f32."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.dtype = dtype
        self.w_qs = Dense(d_model, n_head * d_k, bias=False, dtype=dtype)
        self.w_ks = Dense(d_model, n_head * d_k, bias=False, dtype=dtype)
        self.w_vs = Dense(d_model, n_head * d_v, bias=False, dtype=dtype)
        self.fc = Dense(n_head * d_v, d_model, bias=False, dtype=dtype)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        """x [b, l, d_model]; mask [b, l, 1] or None -> [b, l, d_model].

        The mask broadcasts to [b, 1, l, 1], so it blanks whole query
        ROWS of the score matrix (every key of a masked position gets
        -1e9 and the row's softmax turns uniform), not key columns.
        This reproduces the reference network's behaviour and is kept
        on purpose: the trained weights expect it.
        """
        b, l, _ = x.shape
        nk = self.n_head * self.d_k
        w = torch.cat([m.cast_param("weight")
                       for m in (self.w_qs, self.w_ks, self.w_vs)], dim=0)
        qkv = F.linear(x if self.dtype is None else x.to(self.dtype), w)
        q = qkv[..., :nk].reshape(b, l, self.n_head, self.d_k).transpose(1, 2)
        k = qkv[..., nk:2 * nk].reshape(
            b, l, self.n_head, self.d_k).transpose(1, 2)
        v = qkv[..., 2 * nk:].reshape(
            b, l, self.n_head, self.d_v).transpose(1, 2)
        attn = torch.matmul(q / (self.d_k ** 0.5), k.transpose(-1, -2))
        if mask is not None:
            attn = attn.masked_fill(mask[:, None] == 0, -1e9)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, l, -1)
        return self.layer_norm((self.fc(out) + x).float())


def fused_mean_variance(x: torch.Tensor, weight: torch.Tensor, dim: int = 0):
    """Weighted mean/var over the view dim."""
    mean = (x * weight).sum(dim=dim, keepdim=True)
    var = (weight * (x - mean) ** 2).sum(dim=dim, keepdim=True)
    return mean, var


_FINALS = {"elu": F.elu, "sigmoid": torch.sigmoid, "relu": F.relu,
           "none": lambda x: x}


class _Seq(nn.Module):
    """Linear ``fc0..`` chain with ELU between layers and ``final`` after
    the last."""

    def __init__(self, in_dim: int, widths: Sequence[int], final: str = "elu",
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.n = len(widths)
        for i, wd in enumerate(widths):
            self.add_module(f"fc{i}", Dense(in_dim, wd, dtype=dtype))
            in_dim = wd
        self.final = _FINALS[final]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            x = F.elu(x) if i < self.n - 1 else self.final(x)
        return x


class _SplitSeq(nn.Module):
    """``_Seq((w0, w1), 'elu')`` over concat([broadcast(shared),
    per_view]) with fc0's weight split at ``split``: the shared part is
    contracted once per point instead of once per (point, view)."""

    def __init__(self, split: int, per_view: int, widths: Sequence[int],
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.split = split
        self.fc0 = Dense(split + per_view, widths[0], dtype=dtype)
        self.fc1 = Dense(widths[0], widths[1], dtype=dtype)

    def forward(self, shared: torch.Tensor,
                per_view: torch.Tensor) -> torch.Tensor:
        w = self.fc0.cast_param("weight")
        dt = self.fc0.compute_dtype
        if dt is not None:
            shared, per_view = shared.to(dt), per_view.to(dt)
        x = (F.linear(shared, w[:, :self.split])
             + F.linear(per_view, w[:, self.split:],
                        self.fc0.cast_param("bias")))
        return F.elu(self.fc1(F.elu(x)))


class IBRNetWithNeuRay(nn.Module):
    """View-major inputs:
      rgb_feat    [rfn, b, dn, 3 + in_feat_ch]   (rgb + image features)
      neuray_feat [rfn, b, dn, neuray_in_dim]    (prob embedding)
      ray_diff    [rfn, b, dn, 4]                (dir diff + dot)
      mask        [rfn, b, dn, 1]
    Output: [b, dn, 4] (rgb, sigma).
    """

    def __init__(self, neuray_in_dim: int = 32, in_feat_ch: int = 32,
                 n_samples: int = 64, dtype: torch.dtype | None = None):
        super().__init__()
        c = in_feat_ch + 3
        self.n_samples = n_samples
        self.ray_dir_fc = _Seq(4, (16, c), "elu", dtype)
        self.neuray_fc = _Seq(neuray_in_dim, (8, 1), "none", dtype)
        self.base_fc = _SplitSeq(4 * c, c + neuray_in_dim, (64, 32), dtype)
        self.vis_fc = _Seq(32, (32, 33), "elu", dtype)
        self.vis_fc2 = _Seq(32, (32, 1), "sigmoid", dtype)
        self.geometry_fc = _Seq(32 * 2 + 1, (64, 16), "elu", dtype)
        self.ray_attention = MultiHeadAttention(4, 16, 4, 4, dtype)
        self.out_geometry_fc = _Seq(16, (16, 1), "relu", dtype)
        self.rgb_fc = _Seq(32 + 1 + 4, (16, 8, 1), "none", dtype)

    def forward(self, rgb_feat, neuray_feat, ray_diff, mask,
                pos_stride: int = 1, pos: torch.Tensor | None = None):
        """pos_stride: a dn-sample call takes the attention positions a
        (dn * pos_stride)-sample call gives its every pos_stride-th
        sample (the reduced-sample probe). pos: explicit per-ray
        fractional positions [b, dn] (the focused render); overrides
        pos_stride."""
        rgb_in = rgb_feat[..., :3]
        rgb_feat = rgb_feat + self.ray_dir_fc(ray_diff)

        weight = mask / (mask.sum(dim=0, keepdim=True) + 1e-8)
        weight0 = torch.sigmoid(self.neuray_fc(neuray_feat)) * weight
        mean0, var0 = fused_mean_variance(rgb_feat, weight0)
        mean1, var1 = fused_mean_variance(rgb_feat, weight)
        globalfeat = torch.cat([mean0, var0, mean1, var1], dim=-1)

        x = self.base_fc(globalfeat, torch.cat([rgb_feat, neuray_feat], -1))

        x_vis = self.vis_fc(x * weight)
        x_res, vis = x_vis[..., :-1], x_vis[..., -1:]
        vis = torch.sigmoid(vis) * mask
        x = x + x_res
        vis = self.vis_fc2(x * vis) * mask
        weight = vis / (vis.sum(dim=0, keepdim=True) + 1e-8)

        mean, var = fused_mean_variance(x, weight)
        globalfeat = torch.cat([mean[0], var[0], weight.mean(dim=0)], -1)
        globalfeat = self.geometry_fc(globalfeat)              # b,dn,16
        num_valid_obs = mask.sum(dim=0)                        # b,dn,1

        if pos is not None:
            globalfeat = globalfeat + sinusoid_pos_at(16, pos).to(globalfeat)
        else:
            globalfeat = globalfeat + _pos_table(
                self.n_samples, globalfeat.shape[1], pos_stride,
                globalfeat.device)
        attn_mask = (num_valid_obs > 1).to(globalfeat.dtype)
        globalfeat = self.ray_attention(globalfeat, mask=attn_mask)
        sigma = self.out_geometry_fc(globalfeat)
        sigma_out = torch.where(num_valid_obs < 1,
                                torch.zeros_like(sigma), sigma)

        x = self.rgb_fc(torch.cat([x, vis, ray_diff], dim=-1))
        x = x.masked_fill(mask == 0, -1e9)
        blending_weights = torch.softmax(x, dim=0)
        rgb_out = (rgb_in * blending_weights).sum(dim=0)       # b,dn,3
        return torch.cat([rgb_out, sigma_out], dim=-1)


class IBRNet(nn.Module):
    """The plain IBRNet aggregator, without NeuRay's visibility weighting
    (port of ``neuray_tpu/models/ibrnet.py: IBRNet``; the reference's
    unused alternative, kept for ablations). Inputs in the JAX module's
    layout, views on dim 2:
      rgb_feat [b, dn, rfn, 3 + in_feat_ch], ray_diff [b, dn, rfn, 4],
      mask [b, dn, rfn, 1].
    Output: [b, dn, 4] (rgb, sigma). Its ray attention keeps the
    reference's mask quirk (``MultiHeadAttention.forward``)."""

    def __init__(self, in_feat_ch: int = 32, n_samples: int = 64,
                 dtype: torch.dtype | None = None):
        super().__init__()
        c = in_feat_ch + 3
        self.n_samples = n_samples
        self.ray_dir_fc = _Seq(4, (16, c), "elu", dtype)
        self.base_fc = _Seq(3 * c, (64, 32), "elu", dtype)
        self.vis_fc = _Seq(32, (32, 33), "elu", dtype)
        self.vis_fc2 = _Seq(32, (32, 1), "sigmoid", dtype)
        self.geometry_fc = _Seq(32 * 2 + 1, (64, 16), "elu", dtype)
        self.ray_attention = MultiHeadAttention(4, 16, 4, 4, dtype)
        self.out_geometry_fc = _Seq(16, (16, 1), "relu", dtype)
        self.rgb_fc = _Seq(32 + 1 + 4, (16, 8, 1), "none", dtype)

    def forward(self, rgb_feat, ray_diff, mask):
        num_views = rgb_feat.shape[2]
        rgb_in = rgb_feat[..., :3]
        rgb_feat = rgb_feat + self.ray_dir_fc(ray_diff)
        weight = mask / (mask.sum(dim=2, keepdim=True) + 1e-8)

        mean, var = fused_mean_variance(rgb_feat, weight, 2)
        globalfeat = torch.cat([mean, var], dim=-1)
        x = torch.cat([globalfeat.expand(-1, -1, num_views, -1), rgb_feat],
                      dim=-1)
        x = self.base_fc(x)

        x_vis = self.vis_fc(x * weight)
        x_res, vis = x_vis[..., :-1], x_vis[..., -1:]
        vis = torch.sigmoid(vis) * mask
        x = x + x_res
        vis = self.vis_fc2(x * vis) * mask
        weight = vis / (vis.sum(dim=2, keepdim=True) + 1e-8)

        mean, var = fused_mean_variance(x, weight, 2)
        globalfeat = torch.cat([mean[:, :, 0], var[:, :, 0],
                                weight.mean(dim=2)], -1)
        globalfeat = self.geometry_fc(globalfeat)              # b,dn,16
        num_valid_obs = mask.sum(dim=2)                        # b,dn,1
        globalfeat = globalfeat + _pos_table(
            self.n_samples, globalfeat.shape[1], 1, globalfeat.device)
        attn_mask = (num_valid_obs > 1).to(globalfeat.dtype)
        globalfeat = self.ray_attention(globalfeat, mask=attn_mask)
        sigma = self.out_geometry_fc(globalfeat)
        sigma_out = torch.where(num_valid_obs < 1,
                                torch.zeros_like(sigma), sigma)

        x = self.rgb_fc(torch.cat([x, vis, ray_diff], dim=-1))
        x = x.masked_fill(mask == 0, -1e9)
        blending_weights = torch.softmax(x, dim=2)
        rgb_out = (rgb_in * blending_weights).sum(dim=2)       # b,dn,3
        return torch.cat([rgb_out, sigma_out], dim=-1)
