"""Mixture-of-logistics distribution decoder (port of
``neuray_tpu/models/dist_decoder.py``).

Three small MLP heads (four with ``use_vis``) decode a 32-d per-point
ray feature into mixture parameters: mean [.., 2] (softplus), var
[.., 2] (softplus + 0.05), aw [.., 1] (sigmoid) and vis [.., 1]
(sigmoid). The heads run one after another; the JAX package packs them
into one block-diagonal MLP for the TPU's matrix unit, which changes
only the summation order. With a compute ``dtype`` (bf16) the heads,
their finals and the added constant run in it, and every output is
cast to f32 (the mixture's CDF math needs f32).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from neuray_tpu_torch.models.blocks import Dense
from neuray_tpu_torch.ops import mixture


class _Head(nn.Module):
    """Linear-ELU-Linear-ELU-Linear, then softplus or sigmoid, plus a
    constant."""

    def __init__(self, out_dim: int, final: str, bias_val: float = 0.0,
                 width: int = 32, dtype: torch.dtype | None = None):
        super().__init__()
        self.fc0 = Dense(width, width, dtype=dtype)
        self.fc1 = Dense(width, width, dtype=dtype)
        self.fc2 = Dense(width, out_dim, dtype=dtype)
        self.final = {"softplus": F.softplus, "sigmoid": torch.sigmoid}[final]
        self.bias_val = bias_val

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.elu(self.fc1(F.elu(self.fc0(x))))
        return self.final(self.fc2(x)) + self.bias_val


class MixtureLogisticsDistDecoder(nn.Module):

    def __init__(self, use_vis: bool = True, width: int = 32,
                 bias_val: float = 0.05, dtype: torch.dtype | None = None):
        super().__init__()
        self.use_vis = use_vis
        self.dtype = dtype
        self.mean_decoder = _Head(2, "softplus", width=width, dtype=dtype)
        self.var_decoder = _Head(2, "softplus", bias_val, width, dtype)
        self.aw_decoder = _Head(1, "sigmoid", width=width, dtype=dtype)
        if use_vis:
            self.vis_decoder = _Head(1, "sigmoid", width=width, dtype=dtype)

    def forward(self, feats: torch.Tensor):
        """feats [..., 32] -> (mean [.., 2], var [.., 2], vis [.., 1] or
        None, aw [.., 1]), all f32."""
        if self.dtype is None:
            feats = feats.float()
        vis = self.vis_decoder(feats).float() if self.use_vis else None
        return (self.mean_decoder(feats).float(),
                self.var_decoder(feats).float(), vis,
                self.aw_decoder(feats).float())

    def predict_mean(self, feats: torch.Tensor) -> torch.Tensor:
        """The mean head alone (the depth-loss head): feats [..., 32] ->
        mean [..., 2] in the compute dtype."""
        return self.mean_decoder(feats)

    def compute_prob(self, depth, interval, mean, var, vis, aw, is_ref,
                     depth_range):
        return mixture.compute_prob(depth, interval, mean, var, vis, aw,
                                    is_ref, depth_range, self.use_vis)
