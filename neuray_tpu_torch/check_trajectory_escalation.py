"""The skip renderer's audit escalating mid-trajectory on real weights
(port of ``tools/check_trajectory_escalation.py``):

    python -m neuray_tpu_torch.check_trajectory_escalation [--size 400]
        [--frames 7] [--tol 0.02] [--win-tol-db 0.05] [--probe-stride 2]
        [--weights FILE] [--device cpu]

The camera sits on the radius-4 shell of the pan scene
(``data/synthetic.py: make_pan_scene_spheres``: a diffuse anchor sphere
and an X of thin rods ~32 deg apart), at the first point of a
``RandomState(7)`` search whose view of the anchor holds no rod sphere
(each projected against the frustum with a 12 px margin), and pans from
the anchor to the rods' centre with a quadratic ease-in, so the early
frames stay rod-free and the rods enter mid-trajectory. Every frame goes
through the render CLI's own skip policy, ``render.py: SkipRenderer`` in
``auto_focus`` mode (threshold 0.01, dilate 1): the self-auditing probe
from the size the audit accepted last (sticky upward), the exact
two-phase render for every frame after an audit rejected every size.
Where a rod enters, the audit must escalate for physical reasons, not by
script (``tests/test_torch_port_auto_reaudit.py`` scripts the outcomes).

Each frame prints a JSON row with the JAX tool's keys: whether a rod is
in the frustum, the starting and accepted probe size, the audited
false-skip rate, the windows' predicted cost in dB, the fallback, the
kept fraction, the GT-PSNR (the scene is analytic) and the audit trail
of every rung tried; then a verdict row: ``escalated`` (a larger size
accepted later, or a fallback), ``first_thin_frame``,
``accepted_sequence``, ``fallbacks``. The weights are
``tools/bench_weights_pan.npz``. On the card (the default) the frames
are ``--size`` square at 64 + 64 samples, bf16 with the u8 gather map;
``--device cpu`` caps them at 64 px, 16 + 16 samples, 64-ray chunks,
f32. The rows carry each frame's audit, so the policy's own audit log
is not written.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from neuray_tpu_torch.data.synthetic import (
    DEPTH_RANGE, RADIUS, look_at_pose, make_pan_scene_spheres,
    make_sphere_scene, render_spheres_view, sphere_in_frustum)
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.render import SkipRenderer
from neuray_tpu_torch.train.metrics import unit_psnr
from neuray_tpu_torch.utils.device import full_f32, resolve_device
from neuray_tpu_torch.utils.params import load_flax_params, load_params_npz

TOOLS = Path(__file__).resolve().parents[1] / "tools"
ROD_CENTER = (-1.25, 0.0, 0.0)
START_MARGIN = 12.0     # px: the rods clearly outside the first frame


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--frames", type=int, default=7)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--tol", type=float, default=0.02)
    ap.add_argument("--win-tol-db", type=float, default=0.05)
    ap.add_argument("--probe-stride", type=int, default=2)
    ap.add_argument("--weights", default=str(TOOLS / "bench_weights_pan.npz"))
    ap.add_argument("--device", default=None,
                    help="cpu: the small CPU shapes (default: CUDA)")
    return ap.parse_args(argv)


def start_camera(anchor, rods, K, h: int, w: int) -> np.ndarray:
    """The first shell point of the ``RandomState(7)`` search (512 draws)
    whose view of the anchor holds the anchor and no rod sphere."""
    target = np.asarray(anchor[0], np.float64)
    rs = np.random.RandomState(7)
    for _ in range(512):
        d = rs.randn(3)
        d /= np.linalg.norm(d)
        c = d * RADIUS
        pose = look_at_pose(c, target)
        if (sphere_in_frustum(pose, K, h, w, np.asarray(anchor[0]),
                              anchor[1])
                and not any(sphere_in_frustum(
                    pose, K, h, w, np.asarray(s[0]), s[1],
                    margin=START_MARGIN) for s in rods)):
            return c
    raise RuntimeError("no start view found (scene layout changed?)")


def policy_cfg(flags) -> dict:
    """The render CLI's config fields of the auto_focus policy."""
    return {"skip_mode": "auto_focus", "skip_empty_threshold": 0.01,
            "probe_dilate": 1, "probe_stride": flags.probe_stride,
            "skip_auto_tol": flags.tol,
            "skip_auto_win_tol_db": flags.win_tol_db}


def run(flags, device: torch.device, log=print, max_frames=None):
    """The trajectory's rows (the first ``max_frames`` of ``--frames``)
    and its verdict row."""
    on_card = device.type == "cuda"
    h = w = flags.size if on_card else min(flags.size, 64)
    dn = 64 if on_card else 16
    cfg = R.RenderConfig(
        use_hierarchical_sampling=True, depth_sample_num=dn,
        fine_depth_sample_num=dn,
        ray_batch_num=flags.chunk if on_card else 64, probe_sample_num=8,
        focus_sample_num=min(16, dn), focus_fine_sample_num=min(32, dn),
        use_vis=False, fine_use_vis=False, use_bf16=on_card,
        gather_quant="u8" if on_card else "none")
    renderer = R.NeurayRenderer(cfg)
    load_flax_params(renderer, load_params_npz(flags.weights))
    renderer = renderer.to(device).eval()

    spheres = make_pan_scene_spheres()
    anchor, rods = spheres[0], spheres[1:]
    ref = {k: torch.from_numpy(v).to(device) for k, v in make_sphere_scene(
        np.random.RandomState(0), 8, h, w, spheres, DEPTH_RANGE).items()}
    ref_c = R.encode_ref(renderer, ref)

    K = np.array([[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]],
                 np.float32)
    cam = start_camera(anchor, rods, K, h, w)
    t0 = np.asarray(anchor[0], np.float64)
    t1 = np.asarray(ROD_CENTER, np.float64)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    coords = torch.from_numpy(np.stack([xs, ys], -1).reshape(1, -1, 2)
                              .astype(np.float32)).to(device)
    n_rays = coords.shape[1]

    skip = SkipRenderer(renderer, policy_cfg(flags), False, os.devnull)
    rows = []
    for f in range(flags.frames if max_frames is None else max_frames):
        a = (f / (flags.frames - 1)) ** 2
        pose = look_at_pose(cam, (1 - a) * t0 + a * t1)
        thin_vis = any(sphere_in_frustum(pose, K, h, w, np.asarray(s[0]),
                                         s[1]) for s in rods)
        gt, _, _ = render_spheres_view(pose, K, h, w, spheres)
        que = {"coords": coords,
               "poses": torch.from_numpy(pose[None]).to(device),
               "Ks": torch.from_numpy(K[None]).to(device),
               "depth_range": torch.tensor([DEPTH_RANGE], device=device)}
        sticky = skip.fallback
        start_psn = None if sticky else skip.probing.cfg.probe_sample_num
        out = skip(f, ref_c, que, (h, w))
        if sticky:
            out.update({"probe_sample_num": None, "false_skip_rate": None,
                        "fallback": "two_phase(sticky)"})
        img = np.asarray(out["pixel_colors_nr_fine"][0], np.float32)
        row = {
            "frame": f,
            "thin_in_frustum": bool(thin_vis),
            "start_psn": start_psn,
            "accepted_psn": out.get("probe_sample_num"),
            "false_skip_rate": (None if out.get("false_skip_rate") is None
                                else round(out["false_skip_rate"], 4)),
            "window_clip_db": (round(out["window_clip_db"], 4)
                               if "window_clip_db" in out else None),
            "fallback": out.get("fallback"),
            "kept_fraction": round(out.get("kept_rays", n_rays) / n_rays, 4),
            "psnr_vs_gt": round(unit_psnr(img, gt.reshape(-1, 3)), 3),
            "audit_trail": out.get("audit_trail"),
        }
        rows.append(row)
        log(json.dumps(row), flush=True)

    accepted = [r["accepted_psn"] for r in rows
                if r["accepted_psn"] is not None and r["fallback"] is None]
    verdict = {
        "escalated": bool(len(set(accepted)) > 1
                          or any(r["fallback"] for r in rows)),
        "first_thin_frame": next((r["frame"] for r in rows
                                  if r["thin_in_frustum"]), None),
        "accepted_sequence": [r["accepted_psn"] for r in rows],
        "fallbacks": [r["fallback"] for r in rows]}
    log(json.dumps(verdict), flush=True)
    return rows, verdict


def main(argv=None):
    flags = parse_args(argv)
    full_f32()
    return run(flags, resolve_device(flags.device))


if __name__ == "__main__":
    main()
