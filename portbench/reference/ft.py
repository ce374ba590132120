"""The plain reference of a per-scene finetuning step of
``configs/train/ft/neuray_ft_depth_lego.yaml`` (NeuRay's third mode,
NeuralRayFtRenderer): each reference view's raw visibility features G'
are a trainable ``ray_feats`` row [fh, fw, 32], first drawn from the
generalization model's depth init net (on the view and its nearest), and
a step renders a query view's rays from its reference views' rows with
the renderer of ``reference/model.py``, adds the query's own hit
probability decoded from its own row (the self-hit path), and takes one
Adam step over every leaf on the render and consistency losses.

The scene is read from its files here (``Scene``: NeRF-synthetic
``transforms_train.json``, RGBA PNGs, ``colmap_depth`` maps), with the
loader's conversions written out: OpenGL camera-to-world -> OpenCV
world-to-camera, the focal length from ``camera_angle_x``, colours times
alpha (black background) rounded down to bytes and then divided by 255,
the depth range (2, 6) of every NeRF-synthetic view.

Departures from the published description, each changing rounding only
or the layout of the state, not the step:
- only the rows of ``ray_feats`` that the steps touch are held, stacked,
  and taken by index; the published dense gradient is zero on every other
  row, so its Adam moments stay zero and those rows never move;
- the PNG reader takes unfiltered rows only (the scene's writer filters
  none) and refuses others;
- the published step draws its query, views and rays itself; here they
  are inputs (``batch``), with the fine sampler's uniform draws;
- the fine pass may be given the fine depths to render (``losses``:
  ``fine``), the reference's own still returned beside them.
"""
from __future__ import annotations

import json
import zlib
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from reference import model as M
from reference import train as T

Tensors = Dict[str, torch.Tensor]
DEPTH_RANGE = (2.0, 6.0)          # every NeRF-synthetic view's
INIT_NET = "params/init_net/"


# ---------------- the scene ----------------

def read_png_rgba(path) -> np.ndarray:
    """An 8-bit RGBA PNG of unfiltered rows -> uint8 [h, w, 4]."""
    data = Path(path).read_bytes()
    pos, idat, header = 8, [], None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h = (int.from_bytes(header[i:i + 4], "big") for i in (0, 4))
    if header[8:10] != bytes([8, 6]) or header[12] != 0:
        raise ValueError(f"{path}: not an 8-bit RGBA non-interlaced PNG")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, w * 4 + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows")
    return rows[:, 1:].reshape(h, w, 4)


def read_depth(path) -> np.ndarray:
    """A COLMAP dense map (``w&h&c&`` then f32 in column order) ->
    [h, w]."""
    w, h, c, body = Path(path).read_bytes().split(b"&", 3)
    arr = np.frombuffer(body, np.float32).reshape(
        (int(w), int(h), int(c)), order="F").transpose(1, 0, 2)
    return np.array(arr[..., 0])


class Scene:
    """The train views of ``{root}/nerf_synthetic/{name}``, in the order
    of ``transforms_train.json``, on ``device``: their cameras at once,
    their images and depths when ``take`` asks for them."""

    def __init__(self, root, name: str, device):
        self.dir = Path(root) / "nerf_synthetic" / name
        self.device = device
        info = json.loads((self.dir / "transforms_train.json").read_text())
        self.files, poses = [], []
        flip = np.diag(np.asarray([1, -1, -1], np.float32))
        for frame in info["frames"]:
            self.files.append(frame["file_path"])
            c2w = np.asarray(frame["transform_matrix"], np.float32)
            rot = c2w[:3, :3].T
            poses.append(np.concatenate(
                [flip @ rot, flip @ (-rot @ c2w[:3, 3:])], 1))
        self.poses = np.asarray(poses, np.float32)
        h, w = read_png_rgba(self.path(0)).shape[:2]
        focal = 0.5 * w / np.tan(0.5 * float(info["camera_angle_x"]))
        self.K = np.asarray([[focal, 0, w / 2], [0, focal, h / 2],
                             [0, 0, 1]], np.float32)
        self.views: Dict[int, Tensors] = {}

    def __len__(self):
        return len(self.files)

    def path(self, i: int) -> Path:
        return self.dir / f"{self.files[i]}.png"

    def view(self, i: int) -> Tensors:
        if i not in self.views:
            rgba = read_png_rgba(self.path(i))
            alpha = rgba[..., 3:].astype(np.float32) / 255.0
            img = rgba[..., :3].astype(np.float32) / 255.0 * alpha
            img = np.clip(img * 255, 0, 255).astype(np.uint8)
            name = self.files[i].split("/")
            depth = read_depth(self.dir / "colmap_depth"
                               / f"{name[1]}-{name[2]}.png.geometric.bin")
            dev = self.device
            self.views[i] = {
                "imgs": torch.from_numpy(img.astype(np.float32) / 255).to(dev),
                "depth": torch.from_numpy(depth[..., None]).to(dev),
                "poses": torch.from_numpy(self.poses[i]).to(dev),
                "Ks": torch.from_numpy(self.K).to(dev),
                "depth_range": torch.tensor(DEPTH_RANGE, device=dev)}
        return self.views[i]

    def take(self, idx: Sequence[int]) -> Tensors:
        """The views idx stacked: imgs, depth, poses, Ks, depth_range."""
        views = [self.view(int(i)) for i in idx]
        return {k: torch.stack([v[k] for v in views]) for k in views[0]}

    def nearest(self) -> np.ndarray:
        """[N, N]: each view's views by camera-centre distance, itself
        first."""
        c = np.asarray([-p[:, :3].T @ p[:, 3] for p in self.poses])
        return np.argsort(np.linalg.norm(c[None] - c[:, None], 2, 2), 1)


# ---------------- the initial state ----------------

@torch.no_grad()
def init_ray_feats(W: Tensors, scene: Scene, views: Sequence[int],
                   init_view_num: int = 8, pr=M.F32) -> Tensors:
    """Each view's G' from the depth init net on the view and its
    ``init_view_num - 1`` nearest (itself first), keeping its own map ->
    {view: [fh, fw, 32]}."""
    order = scene.nearest()
    out = {}
    for v in views:
        ref = scene.take(order[v][:init_view_num])
        out[int(v)] = M.depth_init_net(W, ref, pr)[0]
    return out


# ---------------- the step ----------------

def self_hit(W: Tensors, dec: str, own: torch.Tensor, que: Tensors,
             depth: torch.Tensor, pr=M.F32) -> torch.Tensor:
    """The query view's own hit probability along its rays: its
    vis-encoded ray features ``own`` [1, fh, fw, 32] sampled at the query
    pixels, decoded by ``dec``'s heads, its mixture read over the
    intervals between the midpoints of the rays' depths [1, rn, dn]."""
    h, w = que["imgs"].shape[1:3]
    fh, fw = own.shape[1:3]
    feats = M.bilinear_border(own, M.frame_to_map(que["coords"], h, w, fh,
                                                  fw))
    mean = M.head(W, f"{dec}/mean_decoder", feats, F.softplus, pr)
    var = M.head(W, f"{dec}/var_decoder", feats, F.softplus, pr) + 0.05
    aw = M.head(W, f"{dec}/aw_decoder", feats, torch.sigmoid, pr)
    dr = que["depth_range"]
    x = M.inv_depth_norm(depth.clamp_min(1e-5), dr[:, 0][:, None, None],
                         dr[:, 1][:, None, None])
    half = M.inv_dists(depth, dr) / 2
    edges = torch.cat([x[..., :1] - half[..., :1],
                       (x[..., :-1] + x[..., 1:]) / 2,
                       x[..., -1:] + half[..., -1:]], -1)
    lo, hi = edges[..., :-1, None], edges[..., 1:, None]
    mean, var, aw = mean[:, :, None], var[:, :, None], aw[:, :, None]
    c0 = 0.5 + 0.5 * torch.tanh((lo - mean) * var)
    c1 = 0.5 + 0.5 * torch.tanh((hi - mean) * var)
    return ((c1 - c0) * torch.cat([aw, 1 - aw], -1)).sum(-1)


def cross_entropy(p0, p1):
    """The consistency loss: p1 against the detached p0 [qn, rn, dn]."""
    ce = -p0 * torch.log(p1 + 1e-5) - (1 - p0) * torch.log(1 - p1 + 1e-5)
    return ce.mean(-1).mean(1).mean()


def losses(W: Tensors, take, scene: Scene, batch, u: torch.Tensor,
           dn: int = 64, fdn: int = 64, pr=M.F32, consist: bool = True,
           fine: torch.Tensor | None = None) -> Tensors:
    """A step's loss terms (each a mean, named ``loss*``) and
    ``fine_depth``, the fine depths [1, rn, fdn] its own coarse pass
    draws. ``take``: views -> their ``ray_feats`` rows; ``batch``:
    ``ref_idx``, ``que_i``, ``coords`` [1, rn, 2]; u [1, rn, fdn] the fine
    sampler's draws; ``fine``: fine depths to render in place of its own
    (where the coarse hit probability of a nearly empty ray is flat, its
    rounding alone moves the fine samples); ``consist`` False leaves the
    consistency loss out (a planted fault)."""
    ref_idx, que_i = [int(i) for i in batch["ref_idx"]], int(batch["que_i"])
    ref = scene.take(ref_idx)
    img = M.res_unet(W, "params/image_encoder", ref["imgs"], 3, pr)
    ec = dict(ref, img_feats=img,
              ray_feats=M.vis_encoder(W, take(ref_idx), img, pr))
    que = {k: v for k, v in scene.take([que_i]).items()
           if k in ("imgs", "poses", "Ks", "depth_range")}
    que["coords"] = batch["coords"]
    q_img = M.res_unet(W, "params/image_encoder", que["imgs"], 3, pr)
    own = M.vis_encoder(W, take([que_i]), q_img, pr)
    qn, rn, _ = que["coords"].shape
    dev = que["coords"].device
    depth = M.coarse_depths(que["depth_range"], qn, rn, dn)
    col, hit, _ = M.render_pass(W, ec, que, depth, False,
                                M.grid_positions(qn, rn, dn, dev), pr)
    hit_self = self_hit(W, "params/dist_decoder", own, que, depth, pr)
    drawn = M.fine_depths(depth, hit.detach(), que["depth_range"], fdn, u)
    fd = drawn if fine is None else fine
    col_f, hit_f, _ = M.render_pass(W, ec, que, fd, True,
                                    M.grid_positions(qn, rn, fdn, dev), pr)
    hit_self_f = self_hit(W, "params/fine_dist_decoder", own, que, fd, pr)
    gt = T.sample_image(que["imgs"], que["coords"], "zeros")
    rm = T.ray_mask(ec, que, depth).float()
    out = {"fine_depth": drawn}
    for name, c in (("loss_rgb_nr", col), ("loss_rgb_nr_fine", col_f)):
        err = ((c - gt) ** 2).sum(-1)
        out[name] = ((err * rm).sum(1) / (rm.sum(1) + 1e-3)).mean()
    if consist:
        out["loss_prob"] = cross_entropy(hit.detach(), hit_self)
        out["loss_prob_fine"] = cross_entropy(hit_f.detach(), hit_self_f)
    return out


def schedule(lr_cfg: Dict, step: int) -> float:
    """exp_decay: lr_init * decay_rate^(step // decay_step), at least
    lr_min (1e-5 unless given)."""
    return max(lr_cfg["lr_init"] * lr_cfg["decay_rate"]
               ** (step // lr_cfg["decay_step"]), lr_cfg.get("lr_min", 1e-5))


def train(W: Tensors, rows0: Tensors, scene: Scene, batches: List[Dict],
          draws: List[torch.Tensor], lr_cfg: Dict, steps: int = 3,
          dn: int = 64, fdn: int = 64, pr=M.F32, consist: bool = True,
          frozen_ray_feats: bool = False, fine=None):
    """``steps`` Adam updates (optax's defaults) of the network leaves of
    W (the init net's left out) and the ``ray_feats`` rows ``rows0``
    {view: [fh, fw, 32]} (copied) on batches with the fine draws, each
    step's fine pass at ``fine[i]`` where given (``losses``).
    ``frozen_ray_feats``: Adam skips the rows (a planted fault).
    Returns (each step's total loss, the first step's gradients by leaf,
    the leaves' change after the last step, the rows' first gradient and
    change by view, each step's own fine depths). A row outside Adam
    reads a zero gradient, as its moment would."""
    net = {k: v.clone().requires_grad_(True) for k, v in W.items()
           if not k.startswith(INIT_NET)}
    views = sorted(rows0)
    at = {v: i for i, v in enumerate(views)}
    rows = torch.stack([rows0[v] for v in views]).clone().requires_grad_(True)
    dev = rows.device

    def take(idx):
        return rows.index_select(
            0, torch.tensor([at[int(i)] for i in idx], device=dev))

    params = list(net.values()) + ([] if frozen_ray_feats else [rows])
    opt = torch.optim.Adam(params, lr=schedule(lr_cfg, 0),
                           betas=(0.9, 0.999), eps=1e-8)
    totals, first, first_rows, own = [], None, None, []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        rows.grad = None
        terms = losses(net, take, scene, batches[i], draws[i], dn, fdn, pr,
                       consist, None if fine is None else fine[i])
        own.append(terms["fine_depth"])
        total = sum(v for k, v in terms.items() if k.startswith("loss"))
        total.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if first is None:
            first = {k: p.grad.detach().clone() for k, p in net.items()}
            first_rows = (torch.zeros_like(rows) if frozen_ray_feats
                          else rows.grad.detach().clone())
        totals.append(float(total.detach()))
        for group in opt.param_groups:
            group["lr"] = schedule(lr_cfg, i)
        opt.step()
    change = {k: p.detach() - W[k] for k, p in net.items()}
    moved = rows.detach() - torch.stack([rows0[v] for v in views])
    return (totals, first, change,
            {v: first_rows[at[v]] for v in views},
            {v: moved[at[v]] for v in views}, own)
