"""The plain reference of a generalization training step of
``configs/train/gen/neuray_gen_depth_train.yaml``: the training forward
(the encode with autograd, the coarse pass at fixed depths, the fine pass
at the given uniform draws, sorted), the render loss of the coarse and
fine colours on the rays the ray mask keeps, the L2 depth loss of both
dist decoders' means against the true depth in normalized inverse depth,
and ``torch.optim.Adam`` (optax's defaults) at the schedule's rate."""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from reference import model as M


def sample_image(img, coords, padding):
    """img [n, h, w, c] at pixel coords [n, p, 2] (align_corners) ->
    [n, p, c]."""
    n, h, w, _ = img.shape
    g = torch.stack([coords[..., 0] / (w - 1) * 2 - 1,
                     coords[..., 1] / (h - 1) * 2 - 1], -1)[:, None]
    out = F.grid_sample(img.permute(0, 3, 1, 2), g, mode="bilinear",
                        padding_mode=padding, align_corners=True)
    return out[:, :, 0].transpose(1, 2)


def ray_mask(ec, que, depth, min_views=2, min_points=8):
    """Rays with more than min_points coarse samples that more than
    min_views views see."""
    qn, rn, dn = depth.shape
    v, h, w, _ = ec["imgs"].shape
    pts, _ = M.ray_points(que, depth)
    uv, _, ok = M.project(ec["poses"], ec["Ks"], pts.reshape(-1, 3))
    inside = (ok & (uv[..., 0] >= -0.5) & (uv[..., 0] < w - 0.5)
              & (uv[..., 1] >= -0.5) & (uv[..., 1] < h - 0.5))
    seen = inside.reshape(v, qn, rn, dn).sum(0) > min_views
    return seen.sum(-1) > min_points


def losses(W, batch, u, keep_rays=None, pr=M.F32):
    """The step's loss terms (each a mean) -> {name: scalar}.
    ``keep_rays``: the first half of the rays only (a planted fault)."""
    ref, que = batch["ref"], batch["que"]
    if keep_rays is not None:
        que = dict(que, coords=que["coords"][:, :keep_rays])
        u = u[:, :keep_rays]
    ec = M.encode(W, ref, None, pr)
    qn, rn, _ = que["coords"].shape
    depth = M.coarse_depths(que["depth_range"], qn, rn, 64)
    pos = M.grid_positions(qn, rn, 64, depth.device)
    col, hit, _ = M.render_pass(W, ec, que, depth, False, pos, pr)
    fd = M.fine_depths(depth, hit.detach(), que["depth_range"], 64, u)
    col_f, _, _ = M.render_pass(W, ec, que, fd, True, pos, pr)
    gt = sample_image(que["imgs"], que["coords"], "zeros")
    rm = ray_mask(ec, que, depth).float()
    out = {}
    for name, c in (("loss_rgb_nr", col), ("loss_rgb_nr_fine", col_f)):
        err = ((c - gt) ** 2).sum(-1)
        out[name] = ((err * rm).sum(1) / (rm.sum(1) + 1e-3)).mean()
    coords = batch["depth_loss_coords"]
    h, w = ref["imgs"].shape[1:3]
    fh, fw = ec["ray_feats"].shape[1:3]
    feats = M.bilinear_border(ec["ray_feats"],
                              M.frame_to_map(coords, h, w, fh, fw))
    dr = ref["depth_range"]
    near, far = -1.0 / dr[:, 0:1], -1.0 / dr[:, 1:2]
    d = sample_image(ref["true_depth"], coords, "border")[..., 0]
    d_gt = ((-1.0 / d.clamp_min(1e-5) - near) / (far - near)).clamp(0, 1)
    for name, dec in (("loss_depth", "dist_decoder"),
                      ("loss_depth_fine", "fine_dist_decoder")):
        mean = M.head(W, f"params/{dec}/mean_decoder", feats, F.softplus, pr)
        out[name] = ((d_gt - mean[..., 0]) ** 2).mean(1).mean()
    return out


def train(W: Dict[str, torch.Tensor], batches, draws, lr: float,
          steps: int = 3, keep_rays=None, pr=M.F32):
    """``steps`` Adam updates of the weights W (copied) on batches with
    the fine sampler's draws. Returns (each step's total loss, the first
    step's gradients, the weights' change after the last step), the last
    two by leaf."""
    params = {k: v.clone().requires_grad_(True) for k, v in W.items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)
    totals: List[float] = []
    first = None
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        total = sum(losses(params, batches[i], draws[i], keep_rays,
                           pr).values())
        total.backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if first is None:
            first = {k: p.grad.detach().clone() for k, p in params.items()}
        totals.append(float(total.detach()))
        opt.step()
    change = {k: (p.detach() - W[k]) for k, p in params.items()}
    return totals, first, change
