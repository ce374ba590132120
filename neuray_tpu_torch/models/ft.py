"""Per-scene finetuning (port of ``neuray_tpu/models/ft.py``; reference
network/renderer.py:331-547, NeuralRayFtRenderer): the per-view raw
visibility features G' become trainable, initialized from a
generalization model's init net, depth or cost volume (or drawn at
random), and the renderer's modules are finetuned with them on one
scene.

``FtRenderer`` is an ``nn.Module`` holding the renderer ``net`` (no init
net) and one parameter ``ray_feats`` [N, fh, fw, c] for the scene's N
reference views. A training step selects its views with ``index_select``
(its backward adds into a dense gradient, so Adam moves every view's
moments as optax does on the JAX package's ``jnp.take``), encodes them,
and renders its rays; with ``use_self_hit_prob`` it also encodes the
query view (a ninth image-encoder pass) for the consistency loss. The
scene's images, poses, Ks and depth ranges live on the device.

``render_video_ft`` is the render CLI's ``--render_type ft``: the
finetuned scene's frames along a trajectory.

On a mesh of more than one rank (``parallel/sharding.py``) the training
forward is ray-sharded, the counterpart of the JAX package's
``FtRenderer.make_sharded_train_step``: every rank encodes the scene,
the ray batch is padded to a multiple of the ranks with copies of the
last ray (weighted 0 in ``ray_weight``), and each rank renders its
contiguous slice; the losses sum their ray reductions over the ranks
(``build_losses(cfg, group=mesh)``) and the trainer averages the
gradients (``average_gradients``), which gives the one-process step's
full-batch gradient. The fine sampler's draws are made for the whole
batch from the trainer's CPU generator (the pad rays copy the last ray's)
and sliced, so a sharded step equals the one-process step on the same
batch, draws included; the JAX package folds the device index into its
key instead, a different stream from the same distribution.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterable

import numpy as np
import torch
import torch.nn as nn

from neuray_tpu_torch.data.database import (
    get_database_split, parse_database_name)
from neuray_tpu_torch.data.imgs_info import build_imgs_info, get_coords_mask
from neuray_tpu_torch.data.view_select import (
    compute_nearest_camera_indices, select_working_views)
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.models.renderer import NeurayRenderer, RenderConfig
from neuray_tpu_torch.parallel import sharding as P
from neuray_tpu_torch.utils.config import load_cfg
from neuray_tpu_torch.utils.device import resolve_device
from neuray_tpu_torch.utils.params import init_like_flax
from neuray_tpu_torch.utils.profiling import span

Tensors = Dict[str, torch.Tensor]

FT_DEFAULT_CFG = {
    "database_name": "nerf_synthetic/lego/black_400",
    "database_split": "val_all",
    "ref_pad_interval": 16,
    "use_consistent_depth_range": True,
    "gen_cfg": None,
    "use_validation": True,
    "validate_initialization": True,
    "init_view_num": 8,
    "init_src_view_num": 3,
    "include_self_prob": 0.01,
    "neighbor_view_num": 8,
    "neighbor_pool_ratio": 2,
    "train_ray_num": 512,
    "foreground_ratio": 0.5,
    "ray_feats_res": [200, 200],
    "ray_feats_dim": 32,
    "output_root": "data/model",
}

# the scene store on the device (the masks stay on the host)
_STORE = ("imgs", "poses", "Ks", "depth_range")


def load_gen_state(output_root: str, name: str) -> Tensors:
    """The parameters of the model ``name`` (generalization or
    finetuned), as the port's trainers save them:
    ``{output_root}/{name}/ckpt_best.pt``, else ``ckpt.pt``."""
    for fn in ("ckpt_best.pt", "ckpt.pt"):
        path = f"{output_root}/{name}/{fn}"
        if os.path.exists(path):
            return torch.load(path, map_location="cpu",
                              weights_only=True)["params"]
    raise FileNotFoundError(f"no checkpoint of {name} under {output_root}")


class FtRenderer(nn.Module):
    """The finetuning model of one scene (``cfg``: ``FT_DEFAULT_CFG``'s
    fields and the renderer's) on ``device``: CUDA unless the caller
    passes ``device="cpu"``. ``ray_feats`` is set by ``init_params`` or
    ``set_ray_feats``."""

    def __init__(self, cfg: Dict[str, Any], device=None):
        super().__init__()
        self.cfg = {**FT_DEFAULT_CFG, **cfg}
        self.device = resolve_device(device)
        # the FT renderer itself has no init net
        self.render_cfg = RenderConfig.from_cfg({**cfg, "init_net_type": ""})
        if self.render_cfg.use_bf16:
            raise NotImplementedError("finetuning runs in f32 only "
                                      "(use_bf16=True)")
        with torch.random.fork_rng(devices=[]):
            self.net = NeurayRenderer(self.render_cfg)
        self.net.to(self.device).train()
        self.register_parameter("ray_feats", None)

        self.database = parse_database_name(self.cfg["database_name"])
        ref_ids, self.val_ids = get_database_split(
            self.database, self.cfg["database_split"])
        self.ref_ids = np.asarray(ref_ids)
        self.ref_dist_idx = compute_nearest_camera_indices(
            self.database, list(self.ref_ids))
        ref_info = build_imgs_info(
            self.database, list(self.ref_ids), self.cfg["ref_pad_interval"],
            True, replace_none_depth=True)
        if self.cfg["use_consistent_depth_range"]:
            ref_info["depth_range"][:, 0] = np.min(ref_info["depth_range"])
            ref_info["depth_range"][:, 1] = np.max(ref_info["depth_range"])
        self.ref_info = ref_info
        self.ref_store = {k: torch.from_numpy(ref_info[k]).to(self.device)
                          for k in _STORE}

        if self.cfg["use_validation"]:
            self.val_dist_idx = compute_nearest_camera_indices(
                self.database, list(self.val_ids), list(self.ref_ids))
            self.val_info = build_imgs_info(
                self.database, list(self.val_ids), -1, True, has_depth=False)

    # ---------------- initialization ----------------

    def set_ray_feats(self, ray_feats: torch.Tensor) -> None:
        """Make ray_feats [N, fh, fw, c] (a copy on the device, f32) the
        trainable ``ray_feats``."""
        if ray_feats.shape[0] != len(self.ref_ids):
            raise ValueError(f"ray_feats for {ray_feats.shape[0]} views, the "
                             f"scene has {len(self.ref_ids)}")
        self.ray_feats = nn.Parameter(
            ray_feats.detach().to(self.device, torch.float32).clone())

    def init_params(self, seed: int = 0) -> None:
        """Set the trainable state. With ``gen_cfg`` (the generalization
        config as a dict, or the path of its YAML file): every
        module but the init net from that model's checkpoint
        (``load_gen_state`` under ``output_root``), ray_feats from its
        init net, depth or cost volume (``init_ray_feats_from_gen``).
        Without: ray_feats [N, *ray_feats_res, ray_feats_dim] normal from
        a generator seeded ``seed`` and the modules from flax's
        initializers (``init_like_flax``) under the same seed."""
        gen_cfg = self.cfg["gen_cfg"]
        if gen_cfg is None:
            fh, fw = self.cfg["ray_feats_res"]
            g = torch.Generator().manual_seed(seed)
            self.set_ray_feats(torch.randn(
                (len(self.ref_ids), fh, fw, self.cfg["ray_feats_dim"]),
                generator=g))
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                init_like_flax(self.net)
            return
        if not isinstance(gen_cfg, dict):
            gen_cfg = load_cfg(gen_cfg)
        state = load_gen_state(self.cfg["output_root"], gen_cfg["name"])
        with torch.random.fork_rng(devices=[]):
            gen = NeurayRenderer(RenderConfig.from_cfg(gen_cfg))
        gen.load_state_dict(state)
        self.set_ray_feats(self.init_ray_feats_from_gen(gen.to(self.device)))
        self.net.load_state_dict({k: v for k, v in state.items()
                                  if not k.startswith("init_net.")})

    @torch.no_grad()
    def init_ray_feats_from_gen(self, gen: NeurayRenderer) -> torch.Tensor:
        """Each view's raw visibility features G' from the gen model's
        init net (reference renderer.py:401-434, 446-450) -> [N, h/4,
        w/4, 32]: the depth init net on the view's ``init_view_num``
        nearest views, itself first, keeping the first map; or the
        cost-volume init net on the view alone, its
        ``init_src_view_num`` nearest other views the source views
        (``nn_ids`` = arange), at eval size (800x800 views through
        MVSNet at 640x640)."""
        by_cv = gen.cfg.init_net_type == "cost_volume"
        if not by_cv:
            depth = torch.from_numpy(self.ref_info["depth"]).to(self.device)
        src_num = self.cfg["init_src_view_num"]
        nn_ids = torch.arange(src_num, device=self.device)[None]
        feats = []
        for i, ref_id in enumerate(self.ref_ids):
            nearest = self.ref_dist_idx[i]
            assert self.ref_ids[nearest[0]] == ref_id
            if by_cv:
                ref = self._slice_ref(torch.tensor([i], device=self.device))
                ref["nn_ids"] = nn_ids
                src = self._slice_ref(torch.from_numpy(
                    nearest[1:1 + src_num]).to(self.device))
                feats.append(gen.initialize_ray_feats(ref, src)[0])
                continue
            sel = torch.from_numpy(
                nearest[:self.cfg["init_view_num"]]).to(self.device)
            ref = self._slice_ref(sel)
            ref["depth"] = depth.index_select(0, sel)
            feats.append(gen.initialize_ray_feats(ref)[0])
        return torch.stack(feats)

    # ---------------- per-step host logic ----------------

    def _slice_ref(self, idx: torch.Tensor) -> Tensors:
        return {k: v.index_select(0, idx) for k, v in self.ref_store.items()}

    def sample_train_indices(self, rng: np.random.RandomState):
        """A query view and its reference views: ``neighbor_view_num``
        drawn from the query's ``neighbor_view_num * neighbor_pool_ratio``
        nearest, itself left out unless a draw below
        ``include_self_prob``. Returns (que_i, ref_idx)."""
        c = self.cfg
        que_i = rng.randint(0, len(self.ref_ids))
        ref_idx = self.ref_dist_idx[que_i]
        if rng.random() > c["include_self_prob"]:
            ref_idx = ref_idx[1:]
        ref_idx = ref_idx[:c["neighbor_view_num"] * c["neighbor_pool_ratio"]]
        ref_idx = np.array(ref_idx)
        rng.shuffle(ref_idx)
        return que_i, ref_idx[:c["neighbor_view_num"]]

    def _build_que_train(self, ref_idx, que_i: int,
                         rng: np.random.RandomState) -> Tensors:
        """The query of a step: ``train_ray_num`` pixels of view que_i
        (``get_coords_mask``), its camera and its image."""
        mask = self.ref_info["masks"][que_i, :, :, 0] > 0
        coords = get_coords_mask(
            mask, self.cfg["train_ray_num"], self.cfg["foreground_ratio"],
            rng).reshape(1, -1, 2)
        que = {k: v[que_i:que_i + 1] for k, v in self.ref_store.items()}
        que["coords"] = torch.from_numpy(coords).to(self.device)
        return que

    # ---------------- the training forward ----------------

    def forward(self, ref_idx, que: Tensors, que_i: int,
                generator: torch.Generator | None = None,
                mesh: P.Mesh | None = None) -> Tensors:
        """The training forward of one step, with autograd: the ref views
        ref_idx's ray_feats through the encoders, the gather maps, and
        ``render_chunk(is_train=True)`` of que (fine draws from
        ``generator``); with ``use_self_hit_prob`` the query view's own
        ray_feats (view que_i) encoded with its image for the
        consistency path. On a ``mesh`` of more than one rank, this
        rank's slice of the rays (``_render_shard``). The encodes (the ref
        views' and the query's own) are the span ``ft.encode``
        (``utils/profiling.py``)."""
        dev = self.ray_feats.device
        idx = torch.from_numpy(np.asarray(ref_idx, np.int64)).to(dev)
        ref = self._slice_ref(idx)
        with span("ft.encode"):
            img_feats, ray_feats = self.net.encode_scene(
                ref, self.ray_feats.index_select(0, idx))
            ref_c = self.net.build_gather_cache(
                dict(ref, img_feats=img_feats, ray_feats=ray_feats))
            que_c = dict(que)
            if self.render_cfg.use_self_hit_prob:
                que_raw = self.ray_feats.index_select(
                    0, torch.tensor([int(que_i)], device=dev))
                _, que_c["ray_feats"] = self.net.encode_scene(
                    {"imgs": que["imgs"]}, que_raw)
        if mesh is None or mesh.size == 1:
            return self.net.render_chunk(ref_c, que_c, True, generator)
        return self._render_shard(ref_c, que_c, generator, mesh)

    def _render_shard(self, ref_c: Tensors, que: Tensors,
                      generator: torch.Generator | None,
                      mesh: P.Mesh) -> Tensors:
        """This rank's part of a ray-sharded training render: the rays
        padded to a multiple of the ranks with copies of the last one,
        the contiguous slice of rank r (``parallel.sharding.rank_part``),
        and its ``ray_weight`` (0 on the padding). The fine draws are made for the unpadded batch, as the
        one-process step makes them, and padded and sliced alike."""
        coords = que["coords"]
        qn, rn, _ = coords.shape
        u = None
        if self.render_cfg.use_hierarchical_sampling:
            u = P.rank_part(self.net.draw_fine_u(
                (qn, rn, self.render_cfg.fine_depth_sample_num),
                coords.device, generator), mesh)
        out = self.net.render_chunk(
            ref_c, dict(que, coords=P.rank_part(coords, mesh)), True,
            generator, u)
        lo, per = P.rank_span(rn, mesh)
        out["ray_weight"] = (torch.arange(lo, lo + per, device=coords.device)
                             < rn).float().expand(qn, per)
        return out

    # ---------------- validation ----------------

    def validate_view(self, render_fn, vi: int):
        """Full-image render of held-out view vi from its
        ``neighbor_view_num`` nearest reference views. Returns (outputs,
        the ground-truth image [h, w, 3], (h, w))."""
        ref_idx = self.val_dist_idx[vi][:self.cfg["neighbor_view_num"]]
        idx = torch.from_numpy(ref_idx).to(self.device)
        ref = self._slice_ref(idx)
        ref["ray_feats_raw"] = self.ray_feats.detach().index_select(0, idx)
        h, w = self.val_info["imgs"].shape[1:3]
        xs, ys = np.meshgrid(np.arange(w), np.arange(h))
        coords = np.stack([xs, ys], -1).reshape(1, -1, 2).astype(np.float32)
        que = {"coords": coords}
        for k in ("poses", "Ks", "depth_range"):
            que[k] = self.val_info[k][vi:vi + 1]
        que = {k: torch.from_numpy(v).to(self.device) for k, v in que.items()}
        return render_fn(ref, que), self.val_info["imgs"][vi], (h, w)


def make_ft_encode_fn(ft: FtRenderer):
    """The FT scene encode: ref (with ``ray_feats_raw``) -> the encoded
    ref (img and ray feats and the gather maps), which the chunk loops and
    frame functions of ``models/renderer.py`` take unchanged: FT and gen
    differ only in where ray_feats_raw comes from."""
    net = ft.net

    @torch.inference_mode()
    def encode(ref: Tensors) -> Tensors:
        ref = dict(ref)
        img_feats, ray_feats = net.encode_scene(ref, ref.pop("ray_feats_raw"))
        return net.build_gather_cache(
            dict(ref, img_feats=img_feats, ray_feats=ray_feats),
            net.cfg.use_bf16, net.cfg.gather_quant)

    return encode


def make_ft_render_fn(ft: FtRenderer,
                      keep_keys: Iterable[str] = ("pixel_colors_nr",
                                                  "pixel_colors_nr_fine"),
                      mesh: P.Mesh | None = None):
    """Full-image render for FT: (ref with ``ray_feats_raw``, que) -> the
    kept outputs [qn, rn, ...] of ``render_rays`` over the encoded ref
    (on a mesh, ray-sharded: ``make_sharded_render_fn``)."""
    encode = make_ft_encode_fn(ft)
    rays = P.make_sharded_render_fn(ft.net, mesh, keep_keys,
                                    pre_encoded=True)

    def render(ref: Tensors, que: Tensors) -> Tensors:
        return rays(encode(ref), que)

    return render


def render_video_ft(database_name, cfg_fn, pose_type, pose_fn,
                    render_depth, ray_num, rb, re, device=None, mesh=None):
    """The render CLI's ``--render_type ft``: frames rb..re of the
    trajectory pose_type (``get_render_poses``) of the finetuned model of
    the config cfg_fn, read from its checkpoint (``load_gen_state`` under
    ``output_root``: ``{"ray_feats": ..., "net.*": ...}`` as
    ``FtTrainer`` saves it). Each pose renders from its
    ``neighbor_view_num`` nearest reference views (the nearest left
    out), their ray_feats sliced from the trained ones, at the first
    image's K and size and the scene's depth range. With
    ``skip_empty_rays`` the frame goes through the driver of
    ``skip_mode`` as the gen CLI's does (the auto modes starting from the
    config's probe size on every frame), else through ``render_rays``.
    ``{qi}-nr.jpg`` and ``{qi}-nr_fine.jpg`` go to
    ``data/render/<db>/<name>-<pose_type>``; a frame whose
    ``nr_fine.jpg`` exists is skipped. render_depth is not used: the FT
    render writes colours only, as the JAX package's does. On a ``mesh``
    of more than one rank (the CLI under ``torchrun``) every rank encodes
    and the ray phases shard; rank 0 alone writes."""
    from pathlib import Path

    from neuray_tpu_torch.data.render_poses import get_render_poses
    from neuray_tpu_torch.render import save_renderings

    if mesh is None:
        mesh = P.make_mesh(resolve_device(device))
    cfg = load_cfg(cfg_fn)
    cfg["ray_batch_num"] = ray_num
    ft = FtRenderer(cfg, mesh.device)
    params = load_gen_state(ft.cfg["output_root"], cfg["name"])
    ft.set_ray_feats(params["ray_feats"])
    ft.load_state_dict(params)

    database = ft.database
    que_poses = get_render_poses(database, pose_type, pose_fn)
    use_skip = (cfg.get("skip_empty_rays", False)
                and ft.render_cfg.use_hierarchical_sampling)
    encode = make_ft_encode_fn(ft)
    output_dir = (f'data/render/{database_name.replace("/", "_")}/'
                  f'{cfg["name"]}-{pose_type}')
    if mesh.is_main:
        Path(output_dir).mkdir(exist_ok=True, parents=True)
    k0 = database.get_img_ids()[0]
    h, w = database.get_image(k0).shape[:2]
    K = database.get_K(k0)
    dr = ft.ref_info["depth_range"][0]
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    coords = np.stack([xs, ys], -1).reshape(1, -1, 2).astype(np.float32)

    re = len(que_poses) if re == -1 else min(re, len(que_poses))
    # rank 0's list of the frames to render (a frame already written is
    # skipped), the same on every rank
    todo = mesh.broadcast_object(
        [qi for qi in range(rb, re)
         if not os.path.exists(f"{output_dir}/{qi}-nr_fine.jpg")])
    for qi in todo:
        ref_idx = select_working_views(
            np.asarray(ft.ref_info["poses"]), que_poses[qi:qi + 1],
            ft.cfg["neighbor_view_num"], True)[0]
        idx = torch.from_numpy(ref_idx).to(ft.device)
        ref = ft._slice_ref(idx)
        ref["ray_feats_raw"] = ft.ray_feats.detach().index_select(0, idx)
        que = {k: torch.from_numpy(v).to(ft.device) for k, v in {
            "coords": coords, "poses": que_poses[qi][None],
            "Ks": K[None].astype(np.float32),
            "depth_range": dr[None]}.items()}
        ref_c = encode(ref)
        if use_skip:
            out = _ft_skip_frame(ft, cfg, ref_c, que, (h, w), mesh)
        else:
            out = P.make_sharded_render_fn(
                ft.net, mesh, ("pixel_colors_nr", "pixel_colors_nr_fine"),
                pre_encoded=True)(ref_c, que)
        if mesh.is_main:
            save_renderings(output_dir, qi, out, h, w)
            print(f"rendered {qi + 1}/{re}", flush=True)


def _ft_skip_frame(ft: FtRenderer, cfg, ref_c: Tensors, que: Tensors, hw,
                   mesh: P.Mesh | None = None):
    """One FT frame through the frame driver of ``skip_mode``."""
    mode = cfg.get("skip_mode", "two_phase")
    kw = dict(threshold=cfg.get("skip_empty_threshold", 0.05),
              keep_base=("pixel_colors_nr",), mesh=mesh)
    dilate, stride = cfg.get("probe_dilate", 1), cfg.get("probe_stride", 1)
    if mode in ("auto", "auto_focus"):
        return R.render_frame_probe_auto(
            ft.net, ref_c, que, image_hw=hw, dilate=dilate,
            focus=mode == "auto_focus", tol=cfg.get("skip_auto_tol", 0.02),
            probe_stride=stride, **kw)
    if mode == "probe_focus":
        return R.render_frame_probe_focus(ft.net, ref_c, que, image_hw=hw,
                                          dilate=dilate, probe_stride=stride,
                                          **kw)
    if mode == "probe":
        return R.render_frame_probe_skip(ft.net, ref_c, que, image_hw=hw,
                                         dilate=dilate, **kw)
    return R.render_frame_skip_empty(ft.net, ref_c, que, **kw)
