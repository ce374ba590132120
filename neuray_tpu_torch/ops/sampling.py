"""Depth sampling along rays: coarse uniform-in-inverse-depth ticks and
the fine inverse-CDF resampling (stratified ``u`` in eval, the caller's
random ``u`` in training).

Port of ``neuray_tpu/ops/sampling.py``. The JAX version builds the CDF
with a triangular matmul and inverts it with masked min/max reductions
(TPU workarounds); here ``torch.cumsum`` and
``torch.searchsorted(right=True)`` do the same job. Training draws no
coarse jitter: the JAX trainer samples coarse depths deterministically
(``neuray_tpu/models/renderer.py:410-411``).
"""
from __future__ import annotations

import torch


def depth2dists(depth: torch.Tensor) -> torch.Tensor:
    """Forward differences with a 1e6 sentinel tail. depth [..., dn]."""
    dists = depth[..., 1:] - depth[..., :-1]
    tail = torch.full_like(depth[..., :1], 1e6)
    return torch.cat([dists, tail], dim=-1)


def depth2inv_dists(depth: torch.Tensor,
                    depth_range: torch.Tensor) -> torch.Tensor:
    """Interval lengths in the normalized inverse-depth domain.

    depth [qn, rn, dn]; depth_range [qn, 2] -> dists [qn, rn, dn]
    """
    near = (-1.0 / depth_range[:, 0])[:, None, None]
    far = (-1.0 / depth_range[:, 1])[:, None, None]
    depth_inv = -1.0 / depth
    depth_inv = (depth_inv - near) / (far - near)
    return depth2dists(depth_inv)


def sample_depth(depth_range: torch.Tensor, qn: int, rn: int, dn: int):
    """Coarse depth samples, uniform in inverse depth, endpoints pinned.

    depth_range [qn, 2] -> (que_depth [qn, rn, dn], que_dists [qn, rn, dn]).
    """
    return sample_depth_ranged(depth_range[:, 0:1].expand(qn, rn),
                               depth_range[:, 1:2].expand(qn, rn), dn)


def sample_depth_ranged(near: torch.Tensor, far: torch.Tensor, dn: int):
    """``sample_depth`` with a per-ray window: dn depths uniform in
    inverse depth across [near, far], endpoints pinned.

    near, far [qn, rn] -> (que_depth [qn, rn, dn], que_dists [qn, rn, dn])
    """
    interval = (1.0 / far - 1.0 / near) / (dn - 1)                 # qn,rn
    val = torch.arange(1, dn - 1, dtype=torch.float32, device=near.device)
    ticks = interval[..., None] * val
    diff = (1.0 / far - 1.0 / near)[..., None]                     # qn,rn,1
    ticks = torch.cat([torch.zeros_like(diff), ticks, diff], dim=-1)
    que_depth = 1.0 / (1.0 / near[..., None] + ticks)
    return que_depth, depth2dists(que_depth)


def sample_fine_depth(depth: torch.Tensor, hit_prob: torch.Tensor,
                      depth_range: torch.Tensor, fdn: int,
                      u: torch.Tensor | None = None) -> torch.Tensor:
    """Importance-resample depths from the coarse hit-prob PDF: inverse
    CDF with right=True searchsorted over midpoint-extended bins, in the
    inverse-depth domain. With ``u`` None the CDF is read at fixed
    stratified points (eval) and the output is monotone, so no sort is
    needed; training passes its random draws ``u`` [qn, rn, fdn] in
    [0, 1) and sorts the result.

    Like the JAX version it normalizes with ``depth_range[0]`` for every
    query view (the two differ only when qn > 1). A bf16 hit_prob keeps
    the JAX version's rounding: the pdf and the CDF are bf16, the CDF
    summed in f32 and rounded once (JAX's bf16 triangular dot), and the
    bin width ``cdf_above - cdf_below`` is rounded to bf16 before the
    f32 interpolation.

    depth, hit_prob: [qn, rn, dn]; depth_range [qn, 2] -> [qn, rn, fdn]
    """
    near = -1.0 / depth_range[0, 0]
    far = -1.0 / depth_range[0, 1]
    depth = -1.0 / depth
    depth = (depth - near) / (far - near)

    depth_center = (depth[..., 1:] + depth[..., :-1]) / 2
    depth_center = torch.cat(
        [depth[..., 0:1], depth_center, depth[..., -1:]], dim=-1)  # *,dn+1

    hit_prob = hit_prob + 1e-5
    pdf = hit_prob / hit_prob.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf.float(), dim=-1).to(pdf.dtype)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # *,dn+1

    if u is None:
        interval = 1.0 / fdn
        u = 0.5 * interval + torch.arange(
            fdn, dtype=torch.float32, device=cdf.device) * interval
    u = u.expand(*cdf.shape[:-1], fdn).contiguous()

    # first index with cdf > u; cdf[0] = 0 < u, so ``above`` >= 1
    above = torch.searchsorted(cdf.float().contiguous(), u, right=True)
    below = above - 1
    above = above.clamp_max(cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(depth_center, -1, below)
    bins_above = torch.gather(depth_center, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    fine_depth = bins_below + t * (bins_above - bins_below)

    fine_depth = fine_depth * (far - near) + near
    return -1.0 / fine_depth
