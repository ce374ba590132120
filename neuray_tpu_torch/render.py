"""The port's render CLI (counterpart of the root ``render.py``):

    python -m neuray_tpu_torch.render --database_name <db> --cfg <yaml>
        [--pose_type eval|inter|inter_<n>|circle] [--pose_fn <txt>]
        [--rb 0] [--re -1] [--render_type gen|ft] [--ray_num 4096]
        [--depth] [--device cpu]

renders novel views of a database on the card and writes them as JPEGs:
``data/render/<db with / as _>/<cfg name>-<pose_type>/{qi}-nr.jpg`` and
``{qi}-nr_fine.jpg`` (and ``{qi}-depth.png`` / ``{qi}-depth_fine.png``
inverse-depth maps with ``--depth``); for ``eval`` poses the ground truth
goes to ``data/render/<db>/gt/{qi}.jpg``. A frame whose ``nr_fine.jpg``
exists is skipped (resume on rerun); ``--rb``/``--re`` pick the frames.
Databases are read under ``NEURAY_DATA_ROOT`` (default ``data``).

``--render_type gen`` (``render_video_gen``) renders with a
generalization model: the port's checkpoint ``ckpt_best.pt``, else
``ckpt.pt``, under the config's ``output_root`` (default ``data/model``)
and its ``load_ckpt_name`` (default its ``name``), as ``Trainer`` saves
it. Each pose renders from its 8 nearest reference views; poses that
select the same views share one scene encode. With ``skip_empty_rays``
(and hierarchical sampling) the frame goes through the driver of
``skip_mode``: ``two_phase`` (the default; the exact coarse pass gates
the fine one), ``probe``, ``probe_focus``, ``auto`` or ``auto_focus``
(the self-auditing probe: every frame audited, the accepted probe size
sticky upward, the exact gate for the rest of the run once the audit has
rejected every size; one line a frame in ``auto_audit.jsonl``, cleared
at the start of a run). ``--render_type ft`` renders a finetuned scene
(``models/ft.py: render_video_ft``).

Every frame runs on ``--device`` (default CUDA: without a card the CLI
raises unless ``--device cpu`` is given), every gather through the
hand-written kernel there, with TF32 off (``utils/device.py:
full_f32``). With ``use_dr_prediction`` the frames also carry the
direct-rendering colours, written as ``{qi}-dr.jpg`` and
``{qi}-dr_fine.jpg``. The JAX package renders from orbax checkpoints,
which ``tools/convert_reference_ckpt.py`` writes from the reference's
``model_best.pth``; the port's counterpart for that ``.pth`` is
``python -m neuray_tpu_torch.convert_reference_ckpt``, which writes the
``ckpt_best.pt`` read here. Not ported: the JAX package's segmenting of a
frame into bounded device calls (the chunk loops bound memory here).

Under ``torchrun --nproc_per_node N -m neuray_tpu_torch.render ...`` the
CLI renders on N ranks, as the JAX package's on its device mesh: every
rank encodes the scene, the ray phase and every skip mode's probe,
audits and render phases shard the rays (``parallel/sharding.py``, the
drivers' ``mesh``), for gen and ft alike, and rank 0 alone writes the
JPEGs, depth maps, ground truth and audit log.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from neuray_tpu_torch.data.database import (
    get_database_split, parse_database_name)
from neuray_tpu_torch.data.imgs_info import (
    build_imgs_info, build_render_imgs_info, imgs_info_slice)
from neuray_tpu_torch.data.render_poses import get_render_poses
from neuray_tpu_torch.data.train_dataset import build_src_imgs_info_select
from neuray_tpu_torch.data.view_select import select_working_views_db
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.models.ft import load_gen_state
from neuray_tpu_torch.parallel import sharding as P
from neuray_tpu_torch.train.metrics import color_map_backward
from neuray_tpu_torch.utils.config import load_cfg
from neuray_tpu_torch.utils.device import full_f32, resolve_device
from neuray_tpu_torch.utils.imageio import imwrite


def prepare_render_info(database, pose_type, pose_fn, use_depth):
    """(reference ids, rendered ids or None, query poses, Ks, shapes,
    depth ranges): the eval split's held-out views for ``eval*`` poses
    (``test`` with depth, ``test_all`` without), else the trajectory of
    ``get_render_poses`` at the first image's K and size over the
    database's whole depth range."""
    if pose_type.startswith("eval"):
        split_name = "test" if use_depth else "test_all"
        ref_ids, render_ids = get_database_split(database, split_name)
        que_Ks = np.asarray([database.get_K(i) for i in render_ids],
                            np.float32)
        que_poses = np.asarray([database.get_pose(i) for i in render_ids],
                               np.float32)
        que_shapes = np.asarray(
            [database.get_image(i).shape[:2] for i in render_ids])
        que_depth_ranges = np.asarray(
            [database.get_depth_range(i) for i in render_ids], np.float32)
    else:
        ref_ids = (database.get_img_ids(check_depth_exist=True)
                   if use_depth else database.get_img_ids())
        que_poses = get_render_poses(database, pose_type, pose_fn)
        k0 = database.get_img_ids()[0]
        que_Ks = np.tile(database.get_K(k0)[None], (len(que_poses), 1, 1))
        h, w = database.get_image(k0).shape[:2]
        que_shapes = np.tile(np.asarray([[h, w]]), (len(que_poses), 1))
        ranges = np.asarray(
            [database.get_depth_range(i) for i in database.get_img_ids()],
            np.float32)
        que_depth_ranges = np.tile(np.asarray(
            [[np.min(ranges[:, 0]), np.max(ranges[:, 1])]], np.float32),
            (len(que_poses), 1))
        render_ids = None
    return ref_ids, render_ids, que_poses, que_Ks, que_shapes, \
        que_depth_ranges


def save_renderings(output_dir, qi, render_info, h, w):
    """``{qi}-nr.jpg``, ``{qi}-nr_fine.jpg``, ``{qi}-dr.jpg`` and
    ``{qi}-dr_fine.jpg`` for the colours render_info holds."""
    for name in ("nr", "nr_fine", "dr", "dr_fine"):
        key = f"pixel_colors_{name}"
        if key in render_info:
            img = color_map_backward(
                R._host(render_info[key]).reshape(h, w, 3))
            imwrite(f"{output_dir}/{qi}-{name}.jpg", img)


def save_depth(output_dir, qi, render_info, h, w, depth_range):
    """``{qi}-depth.png`` / ``{qi}-depth_fine.png``: inverse depth scaled
    from 1 / far (0) to 1 / near (255)."""
    for key, name in (("render_depth", "depth"),
                      ("render_depth_fine", "depth_fine")):
        if key in render_info:
            depth = R._host(render_info[key]).reshape(h, w)
            near, far = depth_range
            inv = 1.0 / np.maximum(depth, 1e-5)
            inv = (inv - 1 / far) / max(1 / near - 1 / far, 1e-8)
            img = (np.clip(inv, 0, 1) * 255).astype(np.uint8)
            imwrite(f"{output_dir}/{qi}-{name}.png", img)


def to_device(info, device) -> dict:
    """numpy arrays -> tensors on device."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in info.items()}


class SkipRenderer:
    """The frame drivers of ``skip_mode`` over one run's frames, with the
    auto modes' state: the probe size the audit accepted last (frames
    start from it: it only grows) and, once an audit has rejected every
    size, the exact gate for every later frame. Each auto frame appends
    its audit to ``audit_path`` (rank 0 of a ``mesh``, over whose ranks
    the drivers shard)."""

    def __init__(self, renderer, cfg, render_depth, audit_path, mesh=None):
        self.renderer = self.probing = renderer
        self.mode = cfg.get("skip_mode", "two_phase")
        self.threshold = cfg.get("skip_empty_threshold", 0.05)
        self.stride = cfg.get("probe_stride", 1)
        self.dilate = cfg.get("probe_dilate", 1)
        self.tol = cfg.get("skip_auto_tol", 0.02)
        self.win_tol_db = cfg.get("skip_auto_win_tol_db", 0.05)
        self.win_ref_psnr = cfg.get("skip_auto_win_ref_psnr", 35.0)
        self.keep_base = ("pixel_colors_nr",) + (
            ("pixel_colors_dr",) if renderer.cfg.use_dr_prediction
            else ()) + (("render_depth",) if render_depth else ())
        self.fallback = False
        self.audit_path = audit_path
        self.mesh = mesh

    def __call__(self, qi, ref_c, que, hw):
        kw = dict(threshold=self.threshold, keep_base=self.keep_base,
                  mesh=self.mesh)
        if self.mode in ("auto", "auto_focus") and not self.fallback:
            out = R.render_frame_probe_auto(
                self.probing, ref_c, que, image_hw=hw, dilate=self.dilate,
                focus=self.mode == "auto_focus", tol=self.tol,
                win_tol_db=self.win_tol_db, win_ref_psnr=self.win_ref_psnr,
                probe_stride=self.stride, **kw)
            if out["fallback"] is None:
                self.probing = R._with_probe_sample_num(
                    self.renderer, out["probe_sample_num"])
            else:
                self.fallback = True
            if self.mesh is not None and not self.mesh.is_main:
                return out
            print(f"auto probe frame {qi}: psn={out['probe_sample_num']} "
                  f"false_skip={out['false_skip_rate']:.4f} "
                  f"fallback={out['fallback']}", flush=True)
            with open(self.audit_path, "a") as f:
                f.write(json.dumps({
                    "frame": qi,
                    "probe_sample_num": out["probe_sample_num"],
                    "false_skip_rate": out["false_skip_rate"],
                    "window_clip": out.get("window_clip"),
                    "window_clip_db": out.get("window_clip_db"),
                    "audit_trail": out.get("audit_trail"),
                    "fallback": out["fallback"]}) + "\n")
            return out
        if self.mode == "probe_focus":
            return R.render_frame_probe_focus(
                self.probing, ref_c, que, image_hw=hw, dilate=self.dilate,
                probe_stride=self.stride, **kw)
        if self.mode == "probe":
            return R.render_frame_probe_skip(self.probing, ref_c, que,
                                             image_hw=hw, dilate=self.dilate,
                                             **kw)
        # two_phase (and any other name), and the auto modes after their
        # fallback: the exact coarse pass gates the fine one
        return R.render_frame_skip_empty(self.renderer, ref_c, que, **kw)


def load_gen_renderer(cfg, render_cfg, device):
    """The generalization renderer of cfg with its checkpoint's weights
    (``load_ckpt_name``: an eval profile reuses another config's trained
    model, whose parameters it shares) on device, in eval mode."""
    renderer = R.NeurayRenderer(render_cfg)
    renderer.load_state_dict(load_gen_state(
        cfg.get("output_root", "data/model"),
        cfg.get("load_ckpt_name", cfg["name"])))
    return renderer.to(device).eval()


def render_video_gen(database_name, cfg_fn, pose_type, pose_fn,
                     render_depth, ray_num, rb, re, device=None, mesh=None):
    """Render frames rb..re of pose_type with the generalization model of
    the config cfg_fn (see the module's doc), on ``mesh``'s ranks (one
    process on ``device`` without one)."""
    if mesh is None:
        mesh = P.make_mesh(resolve_device(device))
    device = mesh.device
    cfg = load_cfg(cfg_fn)
    render_cfg = R.RenderConfig.from_cfg(
        {**cfg, "ray_batch_num": ray_num, "render_depth": render_depth})
    renderer = load_gen_renderer(cfg, render_cfg, device)

    database = parse_database_name(database_name)
    use_depth = render_cfg.init_net_type == "depth"
    (ref_ids_all, render_ids, que_poses, que_Ks, que_shapes,
     que_depth_ranges) = prepare_render_info(
        database, pose_type, pose_fn, use_depth)
    ref_ids_list = select_working_views_db(
        database, ref_ids_all, que_poses, 8)

    output_dir = (f'data/render/{database_name.replace("/", "_")}/'
                  f'{cfg["name"]}-{pose_type}')
    writer = mesh.is_main
    if writer:
        Path(output_dir).mkdir(exist_ok=True, parents=True)
    keep = ["pixel_colors_nr", "pixel_colors_nr_fine"]
    if render_cfg.use_dr_prediction:
        keep += ["pixel_colors_dr", "pixel_colors_dr_fine"]
    if render_depth:
        keep += ["render_depth", "render_depth_fine"]

    if "skip_auto_win_tol" in cfg and writer:
        print("NOTE: skip_auto_win_tol (hit-mass fraction) was replaced "
              "by skip_auto_win_tol_db (predicted PSNR cost, dB; "
              "default 0.05) — the old knob is ignored", flush=True)
    audit_path = f"{output_dir}/auto_audit.jsonl"
    skip = (SkipRenderer(renderer, cfg, render_depth, audit_path, mesh)
            if cfg.get("skip_empty_rays", False)
            and render_cfg.use_hierarchical_sampling else None)
    rays = P.make_sharded_render_fn(renderer, mesh, keep, pre_encoded=True)
    re = len(que_poses) if re == -1 else min(re, len(que_poses))
    # rank 0's list of the frames to render (a frame already written is
    # skipped), the same on every rank
    todo = mesh.broadcast_object(
        [qi for qi in range(rb, re)
         if not os.path.exists(f"{output_dir}/{qi}-nr_fine.jpg")])
    # a fresh audit log a run: the auto modes' frames append to it
    if writer and cfg.get("skip_mode") in ("auto", "auto_focus") and \
            os.path.exists(audit_path):
        os.remove(audit_path)
    use_src_imgs = cfg.get("use_src_imgs", False) or \
        render_cfg.init_net_type == "cost_volume"
    cv_nn_num = cfg.get("cost_volume_nn_num", 3)
    pad_interval = cfg.get("ref_pad_interval", 16)

    # the scene encode of the last ref set: consecutive poses mostly
    # select the same views, and the encode depends on nothing else
    enc_key = ref_c = None
    for qi in todo:
        ref_ids = ref_ids_list[qi]
        key = tuple(str(i) for i in ref_ids)
        if key != enc_key:
            src = None
            if use_src_imgs:
                # the cost-volume init net: the refs and their source views
                union_info, ref_cv_idx, ref_real_idx = \
                    build_src_imgs_info_select(database, ref_ids,
                                               ref_ids_all, cv_nn_num,
                                               pad_interval)
                ref_info = imgs_info_slice(union_info, ref_real_idx)
                ref_info["nn_ids"] = ref_cv_idx.astype(np.int64)
                src = to_device({k: union_info[k] for k in (
                    "imgs", "poses", "Ks", "depth_range")}, device)
            else:
                ref_info = build_imgs_info(database, list(ref_ids),
                                           pad_interval, True,
                                           replace_none_depth=True)
            ref_c = R.encode_ref(renderer, to_device(ref_info, device), src)
            enc_key = key
        que_info = build_render_imgs_info(
            que_poses[qi], que_Ks[qi], que_shapes[qi], que_depth_ranges[qi])
        h, w = que_info.pop("shape")
        que = to_device(que_info, device)
        if skip is not None:
            out = skip(qi, ref_c, que, (h, w))
        else:
            out = rays(ref_c, que)
        if not writer:
            continue
        save_renderings(output_dir, qi, out, h, w)
        if render_depth:
            save_depth(output_dir, qi, out, h, w, que_depth_ranges[qi])
        print(f"rendered {qi + 1}/{re}", flush=True)

    if pose_type.startswith("eval") and writer:
        gt_dir = f'data/render/{database_name.replace("/", "_")}/gt'
        Path(gt_dir).mkdir(exist_ok=True, parents=True)
        for qi, render_id in enumerate(render_ids):
            if rb <= qi < re:
                imwrite(f"{gt_dir}/{qi}.jpg", database.get_image(render_id))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.strip().splitlines()[0])
    parser.add_argument("--database_name", type=str,
                        default="nerf_synthetic/lego/black_800")
    parser.add_argument("--cfg", type=str,
                        default="configs/gen/neuray_gen_depth.yaml")
    parser.add_argument("--pose_type", type=str, default="eval")
    parser.add_argument("--pose_fn", type=str, default=None)
    parser.add_argument("--rb", type=int, default=0)
    parser.add_argument("--re", type=int, default=-1)
    parser.add_argument("--render_type", type=str, default="gen")
    parser.add_argument("--ray_num", type=int, default=4096)
    parser.add_argument("--depth", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="a torch device; default CUDA")
    flags = parser.parse_args(argv)
    full_f32()
    if flags.render_type not in ("gen", "ft"):
        raise NotImplementedError(flags.render_type)
    owned = not dist.is_initialized()       # torchrun: this process joins
    mesh = P.make_mesh(resolve_device(flags.device))
    args = (flags.database_name, flags.cfg, flags.pose_type, flags.pose_fn,
            flags.depth, flags.ray_num, flags.rb, flags.re, mesh.device, mesh)
    try:
        if flags.render_type == "gen":
            render_video_gen(*args)
        else:
            from neuray_tpu_torch.models.ft import render_video_ft
            render_video_ft(*args)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
