"""CNN building blocks (port of ``neuray_tpu/models/blocks.py``).

The blocks work on NCHW tensors, PyTorch's conv layout; the encoders
that hold them (resunet, init_net, vis_encoder) take and return the JAX
package's channels-last maps and convert once at their boundary.

Submodule names follow the flax parameter tree so that the weight
bridge (``utils/params.py``) maps each leaf by one rule per leaf kind.
A ``ReflectConv`` is itself the conv (its weight sits where flax keeps
``<name>/Conv_0/kernel``).

``dtype`` is flax's ``dtype=``: the compute dtype of the convs and
dense layers (``Conv``, ``Dense``), None for the input's. Parameters
stay f32; a layer with a compute dtype casts its input, weight and bias
to it and returns it (``ComputeCast``). Normalization statistics are
always f32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class ComputeCast:
    """Mixin of a layer whose f32 parameters compute in ``compute_dtype``
    (None: in the input's dtype, with the parameters as they are).

    ``cast_param`` gives a parameter in the compute dtype. The copy is
    made at the first call after the parameter was created, loaded or
    moved (its device, storage or version changed) and reused after
    that, so a call adds no cast kernel for its weights. (A parameter
    made under ``torch.inference_mode`` has no version counter: writing
    it in place there is not seen.) The copies are detached: the
    reduced-precision route renders; it does not train.
    """
    compute_dtype: torch.dtype | None = None

    def cast_param(self, name: str) -> torch.Tensor | None:
        p = getattr(self, name)
        if p is None or self.compute_dtype is None:
            return p
        casts = self.__dict__.setdefault("_param_casts", {})
        key = (p.device, p.data_ptr(),
               None if p.is_inference() else p._version)
        hit = casts.get(name)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = casts[name] = (key, p.detach().to(self.compute_dtype))
        return hit[1]


class Dense(ComputeCast, nn.Linear):
    """``nn.Linear`` with a compute dtype (flax ``nn.Dense(dtype=)``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        return F.linear(x.to(self.compute_dtype), self.cast_param("weight"),
                        self.cast_param("bias"))


class Conv(ComputeCast, nn.Conv2d):
    """``nn.Conv2d`` (zero padding ``padding``, none by default) with a
    compute dtype (flax ``nn.Conv(dtype=)``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, bias: bool = True,
                 dtype: torch.dtype | None = None, padding: int = 0):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding,
                         bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            self.padding)
        return F.conv2d(x.to(self.compute_dtype), self.cast_param("weight"),
                        self.cast_param("bias"), self.stride, self.padding)


class Conv3d(ComputeCast, nn.Conv3d):
    """``nn.Conv3d`` (NCDHW, zero padding) with a compute dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, bias: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding,
                         bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        return F.conv3d(x.to(self.compute_dtype), self.cast_param("weight"),
                        self.cast_param("bias"), self.stride, self.padding)


class ConvTranspose3d(ComputeCast, nn.ConvTranspose3d):
    """``nn.ConvTranspose3d(k3, s2, p1, output_padding=1)``, no bias, with
    a compute dtype: each spatial size doubles. It is the JAX package's
    VALID ``nn.ConvTranspose(transpose_kernel=True)`` cropped to
    [1 : 2i + 1] (``neuray_tpu/models/mvsnet.py: _DeconvBn``)."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype | None = None):
        super().__init__(in_ch, out_ch, 3, 2, 1, output_padding=1,
                         bias=False)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        return F.conv_transpose3d(x.to(self.compute_dtype),
                                  self.cast_param("weight"), None,
                                  self.stride, self.padding,
                                  self.output_padding)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True, track_running_stats=False): each
    (sample, channel) plane normalized over H, W with biased variance,
    eps 1e-5, statistics in f32."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.instance_norm(x.float(), weight=self.weight, bias=self.bias,
                            eps=self.eps)
        return y.to(x.dtype)


class ReflectConv(Conv):
    """Reflect padding (explicit ``F.pad``) then a VALID conv; the
    padding defaults to (k-1)//2 and may be set for even kernels."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int | None = None,
                 bias: bool = False, dtype: torch.dtype | None = None):
        super().__init__(in_ch, out_ch, kernel_size, stride, bias, dtype)
        self.pad = (kernel_size - 1) // 2 if padding is None else padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad:
            x = F.pad(x, (self.pad,) * 4, mode="reflect")
        return super().forward(x)


class BasicBlock(nn.Module):
    """ResNet BasicBlock with InstanceNorm."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 use_downsample: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv1 = ReflectConv(in_planes, planes, 3, stride, dtype=dtype)
        self.bn1 = InstanceNorm(planes)
        self.conv2 = ReflectConv(planes, planes, 3, dtype=dtype)
        self.bn2 = InstanceNorm(planes)
        if use_downsample:
            self.down_conv = Conv(in_planes, planes, 1, stride, bias=False,
                                  dtype=dtype)
            self.down_norm = InstanceNorm(planes)
        else:
            self.down_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x
        if self.down_conv is not None:
            identity = self.down_norm(self.down_conv(x))
        return F.relu(out + identity)


class ResidualBlock(nn.Module):
    """Pre-activation residual block with InstanceNorm."""

    def __init__(self, dim_in: int, dim_out: int, dim_inter: int | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        dim_inter = dim_inter or dim_out
        self.norm1 = InstanceNorm(dim_in)
        self.conv1 = ReflectConv(dim_in, dim_inter, 3, padding=1, dtype=dtype)
        self.norm2 = InstanceNorm(dim_inter)
        self.conv2 = ReflectConv(dim_inter, dim_out, 3, padding=1,
                                 dtype=dtype)
        self.short_cut = (Conv(dim_in, dim_out, 1, dtype=dtype)
                          if dim_in != dim_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.norm1(x)))
        h = self.conv2(F.relu(self.norm2(h)))
        if self.short_cut is not None:
            x = self.short_cut(x)
        return x + h


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample with align_corners=True semantics on NCHW:
    output i samples input i*(n-1)/(2n-1), written out as two gathers and
    a lerp per axis (the same arithmetic as the JAX version)."""

    def upsample_axis(arr: torch.Tensor, dim: int) -> torch.Tensor:
        size_in = arr.shape[dim]
        size_out = size_in * 2
        pos = torch.arange(size_out, dtype=torch.float32, device=arr.device)
        src = pos * (size_in - 1) / (size_out - 1)
        i0 = torch.floor(src).long()
        i1 = (i0 + 1).clamp_max(size_in - 1)
        shape = [1] * arr.dim()
        shape[dim] = size_out
        t = (src - i0).to(arr.dtype).reshape(shape)
        a0 = arr.index_select(dim, i0)
        a1 = arr.index_select(dim, i1)
        return a0 * (1 - t) + a1 * t

    return upsample_axis(upsample_axis(x, 2), 3)


class ConvELU(nn.Module):
    """Reflect conv (with bias) + InstanceNorm + ELU."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = ReflectConv(in_ch, features, kernel_size, stride,
                                padding=(kernel_size - 1) // 2, bias=True,
                                dtype=dtype)
        self.bn = InstanceNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.bn(self.conv(x)))


class UpConv(nn.Module):
    """2x align-corners bilinear upsample + ConvELU."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = ConvELU(in_ch, features, kernel_size, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample2x_align_corners(x))


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()
