"""Spherical-harmonics weighted least-squares colour fit, the direct
rendering branch's colours (port of ``neuray_tpu/ops/sh.py``; reference
network/sph_solver.py).

Per query point, a degree <= 4 SH expansion of the reference views'
colours is fitted by the regularized normal equations and evaluated along
the query direction. The solve keeps the JAX package's explicit batched
inverse, ``inv(lhs) @ rhs`` (the reference's ``torch.inverse``), not a
``solve``; it is ``torch.linalg.inv_ex`` without the error check that
``inv`` adds, which would wait on the device (a CUDA graph cannot
capture that): ``lhs`` is positive definite, since every point's weights
sum to at least ``eps`` and the regularizers are >= 0. It is precision-sensitive (regularizers down to 1e-3), so
every contraction runs in f32: colours of another dtype (bf16 gathers)
are promoted, as JAX promotes them, and the matmuls take PyTorch's
default full-f32 cuBLAS path (TF32 stays off; ``utils/device.py:
full_f32``).
"""
from __future__ import annotations

import numpy as np
import torch

_DEFAULT_REGS = (0.001, 0.005, 0.05, 0.1)


def sh_regs(degree: int = 3, init_regs=_DEFAULT_REGS) -> np.ndarray:
    """Per-coefficient Tikhonov regularizers [(degree + 1)^2] f32: 0 for
    the constant, ``init_regs[l - 1]`` for each coefficient of degree l
    (reference sph_solver.py:10-12)."""
    regs = [np.zeros([1])]
    for lvl in range(1, degree + 1):
        regs.append(np.ones([lvl * 2 + 1]) * init_regs[lvl - 1])
    return np.concatenate(regs, 0).astype(np.float32)


def sh_basis(directions: torch.Tensor, degree: int = 3) -> torch.Tensor:
    """The unnormalized SH basis of the reference's convention:
    directions [..., 3] -> [..., (degree + 1)^2]."""
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    cols = [torch.ones_like(x)]
    if degree >= 1:
        cols += [x, y, z]
    if degree >= 2:
        cols += [x * y, y * z, -x**2 - y**2 + 2 * z**2, z * x, x**2 - y**2]
    if degree >= 3:
        cols += [(3 * x**2 - y**2) * y, x * y * z,
                 y * (4 * z**2 - x**2 - y**2),
                 z * (2 * z**2 - 3 * x**2 - 3 * y**2),
                 x * (4 * z**2 - x**2 - y**2),
                 (x**2 - y**2) * z, (x**2 - 3 * y**2) * x]
    if degree >= 4:
        cols += [x * y * (x**2 - y**2), (3 * x**2 - y**2) * y * z,
                 x * y * (7 * z**2 - 1), y * z * (7 * z**2 - 3),
                 35 * z**4 - 30 * z**2 + 3, x * z * (7 * z**2 - 3),
                 (x**2 - y**2) * (7 * z**2 - 1), (x**2 - 3 * y**2) * x * z,
                 x**2 * (x**2 - 3 * y**2) - y**2 * (3 * x**2 - y**2)]
    return torch.stack(cols, dim=-1)


def sh_fit(directions: torch.Tensor, colors: torch.Tensor,
           weights: torch.Tensor, degree: int = 3,
           regs: torch.Tensor | None = None,
           eps: float = 1e-4) -> torch.Tensor:
    """Weighted regularized least-squares SH coefficients: directions
    [b, n, 3], colors [b, n, 3], weights [b, n] -> theta [b, k, 3]. A
    point whose weights sum below ``eps`` gets ``eps`` added to each
    (its fit is then the regularized unweighted one)."""
    if regs is None:
        regs = torch.from_numpy(sh_regs(degree))
    A = sh_basis(directions, degree)                              # b,n,k
    insufficient = weights.sum(dim=1, keepdim=True) < eps
    weights = weights + insufficient.to(weights.dtype) * eps
    Aw = (A * weights[..., None]).transpose(-1, -2)               # b,k,n
    lhs = Aw @ A + torch.diag(regs.to(A))[None]                   # b,k,k
    rhs = Aw @ colors.to(Aw.dtype)                                # b,k,3
    return torch.linalg.inv_ex(lhs).inverse @ rhs


def sh_predict(directions: torch.Tensor, theta: torch.Tensor,
               degree: int = 3) -> torch.Tensor:
    """Evaluate fitted SH: directions [b, n, 3], theta [b, k, 3] ->
    [b, n, 3]."""
    return sh_basis(directions, degree) @ theta
