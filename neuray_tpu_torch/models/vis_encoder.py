"""Visibility-feature encoder G' -> G (port of
``neuray_tpu/models/vis_encoder.py``): a conv stack over
concat(img_feats 32, ray_feats 32) giving the refined 32-ch map, in
the compute ``dtype`` when one is given."""
from __future__ import annotations

import torch
import torch.nn as nn

from neuray_tpu_torch.models.blocks import (
    Conv, ReflectConv, ResidualBlock, nchw_to_nhwc, nhwc_to_nchw)


class DefaultVisEncoder(nn.Module):

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.conv_in = ReflectConv(64, 32, 3, dtype=dtype)
        self.res0 = ResidualBlock(32, 32, dtype=dtype)
        self.res1 = ResidualBlock(32, 32, dtype=dtype)
        self.conv_out = Conv(32, 32, 1, bias=False, dtype=dtype)

    def forward(self, ray_feats: torch.Tensor,
                img_feats: torch.Tensor) -> torch.Tensor:
        """ray_feats, img_feats: [rfn, h, w, 32] -> [rfn, h, w, 32]."""
        x = nhwc_to_nchw(torch.cat([img_feats, ray_feats], dim=-1))
        x = self.res1(self.res0(self.conv_in(x)))
        return nchw_to_nhwc(self.conv_out(x))
