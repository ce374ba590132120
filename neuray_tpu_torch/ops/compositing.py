"""Volume-rendering compositing (port of
``neuray_tpu/ops/compositing.py``)."""
from __future__ import annotations

import torch


def alpha_values2hit_prob(alpha_values: torch.Tensor) -> torch.Tensor:
    """hit_prob[i] = alpha[i] * prod_{j<i} (1 - alpha[j] + 1e-10), the
    exclusive cumulative product of the no-hit density with a leading 1.
    (The JAX version takes it in log space as a triangular matmul, a TPU
    workaround; ``torch.cumprod`` is the plain form.)

    A bf16 input follows the JAX version's rounding instead: there the
    log, the exp and the product run in bf16 and the prefix sum of the
    logs is a bf16 dot, which accumulates in f32 and rounds once. So
    here the logs are summed in f32 and rounded once to bf16.

    alpha_values [..., dn] -> [..., dn]
    """
    no_hit = 1.0 - alpha_values + 1e-10
    if alpha_values.dtype == torch.bfloat16:
        log_t = torch.cumsum(torch.log(no_hit).float(), dim=-1)
        log_t = torch.cat([torch.zeros_like(log_t[..., :1]), log_t[..., :-1]],
                          dim=-1)
        return alpha_values * torch.exp(log_t.to(torch.bfloat16))
    trans = torch.cumprod(no_hit, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)
    return alpha_values * trans


def composite_colors(hit_prob: torch.Tensor,
                     colors: torch.Tensor) -> torch.Tensor:
    """Sum_i hit_prob[i] * color[i]. hit_prob [...,dn], colors [...,dn,3]."""
    return (hit_prob[..., None] * colors).sum(dim=-2)
