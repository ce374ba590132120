"""Image / init feature encoders (port of ``neuray_tpu/models/resunet.py``).

``ResUNetLight`` is the per-reference-view image encoder (32-ch features
at 1/4 input resolution); ``ResEncoder`` is the 12-channel input encoder
of the depth init net. Both take and return channels-last maps; with
a compute ``dtype`` (bf16) the output is in that dtype.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from neuray_tpu_torch.models.blocks import (
    InstanceNorm, ReflectConv, BasicBlock, Conv, ConvELU, UpConv,
    nhwc_to_nchw, nchw_to_nhwc)


def _skip_pad_concat(x_up: torch.Tensor, x_skip: torch.Tensor) -> torch.Tensor:
    """Zero-pad the SKIP map (NCHW) to the upsampled map's spatial size,
    then concat [upsampled, skip] on channels. Pad target and channel
    order both matter for weight parity."""
    dy = x_up.shape[2] - x_skip.shape[2]
    dx = x_up.shape[3] - x_skip.shape[3]
    if dy or dx:
        x_skip = F.pad(x_skip, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return torch.cat([x_up, x_skip], dim=1)


class _ResLayer(nn.Module):
    """A stack of BasicBlocks ``block0..``; the first may stride/downsample."""

    def __init__(self, in_planes: int, planes: int, blocks: int,
                 stride: int = 1, dtype: torch.dtype | None = None):
        super().__init__()
        needs_down = stride != 1 or in_planes != planes
        self.block0 = BasicBlock(in_planes, planes, stride, needs_down, dtype)
        for i in range(1, blocks):
            self.add_module(f"block{i}",
                            BasicBlock(planes, planes, dtype=dtype))
        self.blocks = blocks

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class _ResUNet(nn.Module):
    """Stem (conv1, bn1) and layer1..3 from the subclass, then the shared
    decoder: upconv3 -> skip concat x2 -> iconv3 -> upconv2 -> skip
    concat x1 -> iconv2 -> out_conv."""

    def __init__(self, out_dim: int, dtype: torch.dtype | None):
        super().__init__()
        self.upconv3 = UpConv(128, 64, 3, dtype)
        self.iconv3 = ConvELU(128, 64, 3, 1, dtype)
        self.upconv2 = UpConv(64, 32, 3, dtype)
        self.iconv2 = ConvELU(64, 32, 3, 1, dtype)
        self.out_conv = Conv(32, out_dim, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [n, h, w, c_in] -> [n, ~h/4, ~w/4, out_dim]."""
        x = F.relu(self.bn1(self.conv1(nhwc_to_nchw(x))))
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        y = self.iconv3(_skip_pad_concat(self.upconv3(x3), x2))
        y = self.iconv2(_skip_pad_concat(self.upconv2(y), x1))
        return nchw_to_nhwc(self.out_conv(y))


class ResUNetLight(_ResUNet):
    """ResNet encoder + light upconv decoder; output at 1/4 input res.
    The renderer's image encoder uses layers=(1,2,6,4), out_dim=32,
    inplanes=16."""

    def __init__(self, in_dim: int = 3, layers: Sequence[int] = (2, 3, 6, 3),
                 out_dim: int = 32, inplanes: int = 32,
                 dtype: torch.dtype | None = None):
        super().__init__(out_dim, dtype)
        self.conv1 = ReflectConv(in_dim, inplanes, 7, 2, padding=3,
                                 dtype=dtype)
        self.bn1 = InstanceNorm(inplanes)
        self.layer1 = _ResLayer(inplanes, 32, layers[0], 2, dtype)
        self.layer2 = _ResLayer(32, 64, layers[1], 2, dtype)
        self.layer3 = _ResLayer(64, 128, layers[2], 2, dtype)


class ResEncoder(_ResUNet):
    """12-channel input encoder for the depth init net (conv1 8x8 stride
    2 pad 2, layers (2,2,2), 32-ch output at 1/4 input resolution)."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__(32, dtype)
        self.conv1 = ReflectConv(12, 32, 8, 2, padding=2, dtype=dtype)
        self.bn1 = InstanceNorm(32)
        self.layer1 = _ResLayer(32, 32, 2, 2, dtype)
        self.layer2 = _ResLayer(32, 64, 2, 2, dtype)
        self.layer3 = _ResLayer(64, 128, 2, 2, dtype)
