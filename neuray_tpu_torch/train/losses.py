"""Training losses over the renderer's output dicts (port of
``neuray_tpu/train/losses.py``; the loss registry keeps the reference
names 'render', 'depth', 'consist').

``group`` stands where the JAX package takes ``axis_name``: a
``parallel.sharding.Mesh`` whose ranks each hold a slice of one ray
batch (ray-sharded finetuning, ``models/ft.py``). The render and
consistency losses then sum their ray-axis numerators and counts over
the ranks with the differentiable ``all_reduce_sum``, so every rank holds
the whole batch's loss; ``depth_loss`` reads the (replicated) reference
views and takes no group, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from neuray_tpu_torch.ops.interpolate import grid_sample_nhwc
from neuray_tpu_torch.parallel.sharding import all_reduce_sum

Tensors = Dict[str, torch.Tensor]


def _ray_mean(x: torch.Tensor, group=None,
              weight: torch.Tensor | None = None):
    """Mean over the ray axis (1). ``weight`` [qn, rn] in {0, 1} drops
    rays from both the numerator and the count (padded rays). With a
    ``group`` the ray axis is sharded over its ranks: numerator and count
    are summed over them, and every rank holds the whole batch's mean."""
    if weight is None and group is None:
        return x.mean(1)
    w = torch.ones_like(x) if weight is None else weight
    return (all_reduce_sum((x * w).sum(1), group)
            / all_reduce_sum(w.sum(1), group))


def render_loss(cfg: Dict[str, Any], group=None):
    use_ray_mask = cfg.get("use_ray_mask", True)
    use_dr = cfg.get("use_dr_loss", False)
    use_dr_fine = cfg.get("use_dr_fine_loss", False)
    use_nr_fine = cfg.get("use_nr_fine_loss", False)

    def fn(data_pr: Tensors, data_gt: Dict) -> Tensors:
        rgb_gt = data_pr["pixel_colors_gt"]
        weight = data_pr.get("ray_weight")                   # qn,rn or None

        def compute(rgb_pr):
            loss = ((rgb_pr - rgb_gt) ** 2).sum(-1)          # qn,rn
            if use_ray_mask:
                rm = data_pr["ray_mask"].float()
                if weight is not None:
                    rm = rm * weight
                return (all_reduce_sum((loss * rm).sum(1), group)
                        / (all_reduce_sum(rm.sum(1), group) + 1e-3))
            return _ray_mean(loss, group, weight)

        out = {"loss_rgb_nr": compute(data_pr["pixel_colors_nr"])}
        if use_dr:
            out["loss_rgb_dr"] = compute(data_pr["pixel_colors_dr"])
        if use_dr_fine:
            out["loss_rgb_dr_fine"] = compute(data_pr["pixel_colors_dr_fine"])
        if use_nr_fine:
            out["loss_rgb_nr_fine"] = compute(data_pr["pixel_colors_nr_fine"])
        return out

    return fn


def depth_loss(cfg: Dict[str, Any]):
    loss_type = cfg.get("depth_loss_type", "l2")
    beta = cfg.get("depth_loss_l1_beta", 0.05)
    correct_thresh = cfg.get("depth_correct_thresh", 0.02)

    def fn(data_pr: Tensors, data_gt: Dict) -> Tensors:
        ref = data_gt["ref"]
        if ref.get("true_depth") is None:
            device = next(iter(data_pr.values())).device
            return {"loss_depth": torch.zeros(1, device=device)}
        coords = data_pr["depth_coords"]                     # rfn,pn,2
        depth_maps = ref["true_depth"]                       # rfn,h,w,1
        h, w = depth_maps.shape[1:3]
        depth_range = ref["depth_range"]
        near = -1.0 / depth_range[:, 0:1]
        far = -1.0 / depth_range[:, 1:2]

        def sample(maps):
            return grid_sample_nhwc(maps, coords, h, w, "border", True)[..., 0]

        def process(d):
            d = -1.0 / d.clamp_min(1e-5)
            return ((d - near) / (far - near)).clamp(0.0, 1.0)

        depth_gt = process(sample(depth_maps))
        # gso scenes supervise only where the augmented depth stayed close
        # to the ground truth, signalled per sample by the is_gso flag
        is_gso = data_gt.get("is_gso")

        def compute(depth_pr):
            if loss_type == "l2":
                loss = (depth_gt - depth_pr) ** 2
            elif loss_type == "smooth_l1":
                diff = (depth_gt - depth_pr).abs()
                loss = torch.where(diff < beta, 0.5 * diff ** 2 / beta,
                                   diff - 0.5 * beta)
            else:
                raise NotImplementedError(loss_type)
            if is_gso is not None and ref.get("depth") is not None:
                depth_aug = process(sample(ref["depth"]))
                mask = ((depth_aug - depth_gt).abs() < correct_thresh).float()
                masked = (loss * mask).sum(1) / (mask.sum(1) + 1e-4)
                gso = torch.as_tensor(is_gso, device=loss.device).bool()
                return torch.where(gso, masked, loss.mean(1))
            return loss.mean(1)

        out = {"loss_depth": compute(data_pr["depth_mean"])}
        if "depth_mean_fine" in data_pr:
            out["loss_depth_fine"] = compute(data_pr["depth_mean_fine"])
        return out

    return fn


def consistency_loss(cfg: Dict[str, Any], group=None):
    def fn(data_pr: Tensors, data_gt: Dict) -> Tensors:
        if "hit_prob_self" not in data_pr:
            return {}
        weight = data_pr.get("ray_weight")

        def ce_loss(p0, p1):
            ce = (-p0 * torch.log(p1 + 1e-5)
                  - (1 - p0) * torch.log(1 - p1 + 1e-5))
            return _ray_mean(ce.mean(-1), group, weight)

        out = {"loss_prob": ce_loss(data_pr["hit_prob_nr"].detach(),
                                    data_pr["hit_prob_self"])}
        if "hit_prob_nr_fine" in data_pr:
            out["loss_prob_fine"] = ce_loss(
                data_pr["hit_prob_nr_fine"].detach(),
                data_pr["hit_prob_self_fine"])
        return out

    return fn


name2loss = {
    "render": render_loss,
    "depth": depth_loss,
    "consist": consistency_loss,
}

# every value each loss can report (which of them it does depends on the
# config and the outputs)
name2values = {
    "render": ("loss_rgb_nr", "loss_rgb_dr", "loss_rgb_dr_fine",
               "loss_rgb_nr_fine"),
    "depth": ("loss_depth", "loss_depth_fine"),
    "consist": ("loss_prob", "loss_prob_fine"),
}


def build_losses(cfg: Dict[str, Any], group=None):
    """The configured losses (``cfg["loss"]``, default ['render']) as one
    fn(outputs, batch) -> {name: per-view or per-query loss}; a trainer
    sums the means of the ``loss*`` entries. ``group``: the mesh the ray
    axis is sharded over (the render and consistency losses' reductions
    sum over its ranks, so each rank's values are the whole batch's).
    ``fn.names``: every name fn can report, the keys a data-parallel step
    averages over the ranks (``parallel.sharding.average_gradients``)."""
    losses = cfg.get("loss", ["render"])
    fns = [name2loss[name](cfg, group) if name in ("render", "consist")
           else name2loss[name](cfg) for name in losses]

    def fn(data_pr: Tensors, data_gt: Dict) -> Tensors:
        out = {}
        for f in fns:
            out.update(f(data_pr, data_gt))
        return out

    fn.names = tuple(v for name in losses for v in name2values[name])
    return fn
