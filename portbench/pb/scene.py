"""The benchmark's inputs, made from the seed on the device: the analytic
sphere scene that NeuRay's bench renders (a diffuse unit sphere seen from
cameras on a radius-4 shell looking at the origin, depths in [2.5, 5.5]),
its query poses, and the reference views each frame takes (the nearest
by camera centre, as the render CLI chooses them).

The camera and shading formulas are those of the repository's synthetic
scene (``look_at_camera``, ``render_spheres_view``), evaluated here in
torch so that a set-up renders its views in a few large calls.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

RADIUS = 4.0
DEPTH_RANGE = (2.5, 5.5)
PALETTE = (1.0, 0.5, 1.0)
LIGHT = (0.5, 0.5, 0.7)


def cameras(rng: np.random.Generator, n: int, h: int, w: int):
    """n random cameras on the radius-4 shell looking at the origin ->
    (poses [n, 3, 4] world->camera, Ks [n, 3, 3]) float32 numpy."""
    poses, Ks = [], []
    for _ in range(n):
        d = rng.standard_normal(3)
        d /= np.linalg.norm(d)
        z = -d
        up = np.array([0.0, 0.0, 1.0])
        if abs(np.dot(up, z)) > 0.98:
            up = np.array([0.0, 1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        rot = np.stack([x, y, z])
        poses.append(np.concatenate([rot, (-rot @ (d * RADIUS))[:, None]], 1))
        Ks.append([[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]])
    return (np.asarray(poses, np.float32), np.asarray(Ks, np.float32))


def render_views(poses: torch.Tensor, Ks: torch.Tensor, h: int, w: int):
    """The unit sphere seen by each camera: (rgb [n, h, w, 3] in [0, 1],
    z-depth [n, h, w, 1], 0 off the sphere), computed in float64."""
    dev = poses.device
    P, K = poses.double(), Ks.double()
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float64),
                            torch.arange(w, device=dev, dtype=torch.float64),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1)           # h,w,3
    rot, t = P[:, :, :3], P[:, :, 3]
    cam = -torch.einsum("nji,nj->ni", rot, t)                      # n,3
    dirs = torch.einsum("nij,hwj->nhwi", torch.linalg.inv(K), pix)
    dirs = torch.einsum("nji,nhwj->nhwi", rot, dirs)               # world
    a = (dirs * dirs).sum(-1)
    b = 2 * (dirs * cam[:, None, None]).sum(-1)
    c = (cam * cam).sum(-1)[:, None, None] - 1.0
    disc = b * b - 4 * a * c
    sq = torch.sqrt(disc.clamp_min(0))
    t0, t1 = (-b - sq) / (2 * a), (-b + sq) / (2 * a)
    tt = torch.where(t0 > 1e-3, t0, t1)
    hit = (disc > 0) & (tt > 1e-3)
    tt = torch.where(hit, tt, torch.zeros_like(tt))
    pts = cam[:, None, None] + dirs * tt[..., None]
    shade = (pts @ torch.tensor(LIGHT, device=dev, dtype=torch.float64)
             ).clamp(0, 1)
    col = torch.stack([shade * PALETTE[0], shade * PALETTE[1],
                       (1 - shade) * PALETTE[2]], -1).clamp(0, 1)
    rgb = torch.where(hit[..., None], col, torch.zeros_like(col))
    z = torch.einsum("nhwi,ni->nhw", pts, rot[:, 2]) + t[:, 2, None, None]
    z = torch.where(hit, z, torch.zeros_like(z))
    return rgb.float(), z.float()[..., None]


def make_views(rng: np.random.Generator, n: int, h: int, w: int,
               device) -> Dict[str, torch.Tensor]:
    """n reference views of the sphere on ``device``: imgs, poses, Ks,
    depth_range [n, 2] and depth (the exact z-depth, the depth init
    net's estimate)."""
    poses, Ks = (torch.from_numpy(x).to(device)
                 for x in cameras(rng, n, h, w))
    imgs, depth = render_views(poses, Ks, h, w)
    return {"imgs": imgs, "poses": poses, "Ks": Ks, "depth": depth,
            "depth_range": torch.tensor([DEPTH_RANGE] * n, device=device)}


def make_queries(rng: np.random.Generator, n: int, h: int, w: int,
                 device):
    """n query cameras of an h x w frame and the frame's every pixel:
    (poses [n, 3, 4], Ks [n, 3, 3], coords [1, h*w, 2]) on ``device``."""
    poses, Ks = (torch.from_numpy(x).to(device)
                 for x in cameras(rng, n, h, w))
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    coords = torch.stack([xs, ys], -1).reshape(1, -1, 2).float()
    return poses, Ks, coords


def centers(poses: torch.Tensor) -> torch.Tensor:
    return -torch.einsum("nji,nj->ni", poses[:, :, :3], poses[:, :, 3])


def nearest(view_poses: torch.Tensor, pose: torch.Tensor, k: int):
    """Indices of the k views whose camera centres lie nearest the
    pose's, nearest first (numpy, on the host)."""
    c = centers(view_poses).cpu().numpy()
    q = centers(pose[None]).cpu().numpy()[0]
    return np.argsort(np.linalg.norm(c - q, axis=1), kind="stable")[:k]


def frame_inputs(views: Dict[str, torch.Tensor], pose, K, coords,
                 k: int, nn: int = 0):
    """A frame's inputs: the k views nearest the query pose (``ref``);
    with nn > 0, each ref's nn nearest other refs as its source views
    (``nn_ids`` into the refs, which are also ``src``: the cost-volume
    layout); the query dict ``que``."""
    idx = torch.from_numpy(nearest(views["poses"], pose, k)).to(
        views["poses"].device)
    ref = {key: v.index_select(0, idx) for key, v in views.items()}
    src = None
    if nn:
        c = centers(ref["poses"]).cpu().numpy()
        ids = np.stack([np.argsort(np.linalg.norm(c - ci, axis=1),
                                   kind="stable")[1:nn + 1] for ci in c])
        ref["nn_ids"] = torch.from_numpy(ids).to(idx.device)
        src = {key: ref[key] for key in ("imgs", "poses", "Ks",
                                         "depth_range")}
    que = {"coords": coords, "poses": pose[None], "Ks": K[None],
           "depth_range": torch.tensor([DEPTH_RANGE], device=coords.device)}
    return ref, src, que
