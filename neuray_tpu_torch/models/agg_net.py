"""Aggregation network: embeds the visibility probabilities and runs
``IBRNetWithNeuRay`` (port of ``neuray_tpu/models/agg_net.py``).

The projection dict arrives as [rfn, qn, rn, dn, f] tensors and stays
view-major, [rfn, qn*rn, dn, f], through the aggregation. With a
compute ``dtype`` (bf16) the prob embedding and the aggregation's dense
layers run in it, and density and colours come out in it.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from neuray_tpu_torch.models.blocks import Dense
from neuray_tpu_torch.models.ibrnet import IBRNetWithNeuRay


def get_dir_diff(prj_dir: torch.Tensor, que_dir: torch.Tensor) -> torch.Tensor:
    """prj_dir [rfn, qn, rn, dn, 3]; que_dir [qn, rn, dn, 3]
    -> [rfn, qn*rn, dn, 4] (direction difference and dot product)."""
    rfn, qn, rn, dn, _ = prj_dir.shape
    dir_diff = prj_dir - que_dir[None]
    dir_dot = (prj_dir * que_dir[None]).sum(dim=-1, keepdim=True)
    return torch.cat([dir_diff, dir_dot], dim=-1).reshape(rfn, qn * rn, dn, 4)


class DefaultAggregationNet(nn.Module):

    def __init__(self, neuray_dim: int = 32, sample_num: int = 64,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.prob_embed_0 = Dense(neuray_dim + 2, neuray_dim, dtype=dtype)
        self.prob_embed_1 = Dense(neuray_dim, neuray_dim, dtype=dtype)
        self.agg_impl = IBRNetWithNeuRay(neuray_dim, n_samples=sample_num,
                                         dtype=dtype)

    def forward(self, prj: Dict[str, torch.Tensor], que_dir: torch.Tensor,
                pos_stride: int = 1, pos: torch.Tensor | None = None):
        """prj fields [rfn, qn, rn, dn, *]: ray_feats, hit_prob, vis, rgb,
        dir, mask, img_feats; que_dir [qn, rn, dn, 3]; pos_stride and
        pos [qn, rn, dn]: the attention positions (``IBRNetWithNeuRay``).
        Returns density [qn, rn, dn], colors [qn, rn, dn, 3]."""
        hit_prob_val = (prj["hit_prob"] - 0.5) * 2
        vis_val = (prj["vis"] - 0.5) * 2
        rfn, qn, rn, dn, _ = hit_prob_val.shape

        emb = F.relu(self.prob_embed_0(
            torch.cat([prj["ray_feats"], hit_prob_val, vis_val], dim=-1)))
        emb = self.prob_embed_1(emb).reshape(rfn, qn * rn, dn, -1)

        dir_diff = get_dir_diff(prj["dir"], que_dir)
        valid_mask = prj["mask"].reshape(rfn, qn * rn, dn, -1)
        img_feats = torch.cat([prj["rgb"], prj["img_feats"]], dim=-1)
        img_feats = img_feats.reshape(rfn, qn * rn, dn, -1)

        if pos is not None:
            pos = pos.reshape(qn * rn, dn)
        outs = self.agg_impl(img_feats, emb, dir_diff, valid_mask,
                             pos_stride, pos)
        return (outs[..., 3].reshape(qn, rn, dn),
                outs[..., :3].reshape(qn, rn, dn, 3))
