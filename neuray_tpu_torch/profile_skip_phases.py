"""Phase split of the skip renders (port of
``tools/profile_skip_phases.py``):

    python -m neuray_tpu_torch.profile_skip_phases [--focus] [--iters 2]
        [--threshold 0.01] [--chunk 1024] [--weights FILE] [--device cpu]

Default: the two-phase exact gate (``models/renderer.py:
render_frame_skip_empty``), phase by phase: ``encode`` (``encode_ref``),
``coarse+score`` (``render_coarse_rays`` on every ray, its hit mass
summed and read back), ``fine`` (the rays above ``--threshold``:
``render_fine_rays`` on them with their coarse hit mass) and
``merge-readback`` (the coarse colours read back, the kept rays' fine
colours scattered into them). ``--focus``: the probe-focused bench
default (``render_frame_probe_focus`` at bench.py's settings: probe 16,
focus 16 + 32 samples, the depth init's diff at scale 2, probe stride 2,
dilate 1), phase by phase: ``encode``, ``probe+pool``
(``_strided_focus_probe``: the focus probe on every 2nd pixel and row,
3x3 window pooling), ``compact`` (``_dilate_keep_mask``, the kept rays'
coords and windows), ``focus-render(kept)`` (``render_focus_rays``) and
``merge`` (``_merge_kept_outputs``).

A synchronize ends each phase, so the phases are upper bounds of their
share of an overlapped frame. One frame warms up, then ``--iters``
frames are timed, and the fastest is reported with the JAX tool's keys:
each phase's host seconds, ``kept``, ``padded``, ``total``,
``rays_per_sec`` and ``pad_waste_fraction``; beside them each phase's
CUDA-event span ``<phase>_device_ms`` (``utils/profiling.py:
StageTimer``). On the card one more frame runs under ``torch.profiler``
for each phase's kernel time, ``<phase>_busy_ms``, and
``<phase>_idle_share``, the share of the reported frame's phase in which
the card ran no kernel (1 - busy / host time). A profiled frame takes
about twice a frame's time. The warm-up and profiled frames are the
namespace's ``warmup`` and ``profile_frames`` (``WARMUP``,
``PROFILE_FRAMES``), not flags: a caller in process may lower them.

Padding: the JAX tool pads the kept rays to ``--bucket`` chunk
multiples, the jitted drivers' ``bucket_chunks``, so that XLA compiles
a few shapes. Nothing in the port compiles per shape: its chunk loop
pads only the last chunk with copies of the last ray. So ``padded`` is
the kept count rounded up to a chunk, ``pad_waste_fraction`` is of that,
and ``--bucket`` and its sweep are not ported.

On the card (the default): 800x800, 8 views, 64 + 64 samples,
``--chunk``-ray chunks, bf16 with the u8 gather map, every gather
through the hand-written kernel, ``tools/bench_weights.npz``. ``--device
cpu``: the JAX tool's CPU shapes (64 px, 4 views, 16 + 16 samples, probe
and focus at 8, 256-ray chunks, f32) and flax's initializers under seed
0.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.utils.device import full_f32, resolve_device
from neuray_tpu_torch.utils.profiling import StageTimer
from neuray_tpu_torch.utils.tool_setup import (
    BENCH_WEIGHTS, build_renderer, device_name, sphere_scene)

KEEP_BASE = ("pixel_colors_nr",)
STRIDE, DILATE = 2, 1
WARMUP, PROFILE_FRAMES = 1, 1
PHASES = {False: ("encode", "coarse+score", "fine", "merge-readback"),
          True: ("encode", "probe+pool", "compact", "focus-render(kept)",
                 "merge")}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--threshold", type=float, default=0.01)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--focus", action="store_true",
                    help="profile the probe-focused bench default instead "
                    "of the two-phase exact gate")
    ap.add_argument("--weights", default=BENCH_WEIGHTS)
    ap.add_argument("--device", default=None,
                    help="cpu: the JAX tool's CPU shapes (default: CUDA)")
    flags = ap.parse_args(argv)
    if flags.iters < 1:
        ap.error("--iters must be at least 1")
    flags.warmup, flags.profile_frames = WARMUP, PROFILE_FRAMES
    return flags


def setup(flags, device: torch.device, params=None):
    """(renderer, ref, que, (h, w)) at the device's shapes."""
    on_card = device.type == "cuda"
    h = w = 800 if on_card else 64
    rfn, dn = (8, 64) if on_card else (4, 16)
    cfg = R.RenderConfig(
        use_hierarchical_sampling=True, depth_sample_num=dn,
        fine_depth_sample_num=dn,
        ray_batch_num=flags.chunk if on_card else 256,
        probe_sample_num=16 if on_card else 8,
        focus_sample_num=16 if on_card else 8,
        focus_fine_sample_num=32 if on_card else 8,
        init_diff_scale=2 if on_card and flags.focus else 1,
        use_vis=False, fine_use_vis=False, use_bf16=on_card,
        gather_quant="u8" if on_card else "none")
    renderer = build_renderer(cfg, device, params, flags.weights)
    ref, que = sphere_scene(rfn, h, w, device)
    return renderer, ref, que, (h, w)


def two_phase_frame(renderer, ref, que, threshold, timer, sync):
    """``render_frame_skip_empty``'s frame, phase by phase. Returns its
    frame dict (``keep_mask``, ``kept_rays``, the coarse colours ``k`` and
    the merged ``k + "_fine"``) and the encode ``ref_c``."""
    with timer.stage("encode", sync):
        ref_c = R.encode_ref(renderer, ref)
    with timer.stage("coarse+score", sync):
        coarse = R.render_coarse_rays(renderer, ref_c, que,
                                      KEEP_BASE + ("hit_prob_nr",))
        score = R._host(coarse["hit_prob_nr"].sum(dim=-1))
    with timer.stage("fine", sync):
        keep_mask = score[0] > threshold
        keep = np.nonzero(keep_mask)[0]
        fine = None
        if keep.size:
            idx = torch.from_numpy(keep).to(que["coords"].device)
            fine = R.render_fine_rays(
                renderer, ref_c, R._take_rays(que, keep),
                coarse["hit_prob_nr"][:, idx],
                tuple(k + "_fine" for k in KEEP_BASE))
    with timer.stage("merge-readback", sync):
        out = {"kept_rays": int(keep.size), "keep_mask": keep_mask}
        for k in KEEP_BASE:
            base = R._host(coarse[k]).astype(np.float32)
            merged = base.copy()
            if fine is not None:
                merged[0, keep] = R._host(fine[k + "_fine"])[0]
            out[k], out[k + "_fine"] = base, merged
    return out, ref_c


def focus_frame(renderer, ref, que, threshold, image_hw, timer, sync):
    """``render_frame_probe_focus``'s frame at probe stride 2 and dilate
    1, phase by phase. Returns its frame dict and the encode ``ref_c``."""
    keep_keys = KEEP_BASE + tuple(k + "_fine" for k in KEEP_BASE)
    rn = que["coords"].shape[1]
    with timer.stage("encode", sync):
        ref_c = R.encode_ref(renderer, ref)
    with timer.stage("probe+pool", sync):
        keep_mask, near, far = R._strided_focus_probe(
            renderer, ref_c, que, threshold, image_hw, STRIDE)
    with timer.stage("compact", sync):
        keep_mask = R._dilate_keep_mask(keep_mask, image_hw, DILATE)
        keep = np.nonzero(keep_mask)[0]
        if keep.size:
            que_k = R._take_rays(que, keep)
            idx = torch.from_numpy(keep).to(que["coords"].device)
            near_k, far_k = (torch.as_tensor(x, device=idx.device)[:, idx]
                             for x in (near, far))
    with timer.stage("focus-render(kept)", sync):
        kept_out = (R.render_focus_rays(renderer, ref_c, que_k, near_k,
                                        far_k, keep_keys)
                    if keep.size else None)
    with timer.stage("merge", sync):
        out = R._merge_kept_outputs(KEEP_BASE, kept_out, keep, keep_mask,
                                    1, rn)
    return out, ref_c


def one_frame(flags, renderer, ref, que, image_hw, timer, sync):
    if flags.focus:
        return focus_frame(renderer, ref, que, flags.threshold, image_hw,
                           timer, sync)
    return two_phase_frame(renderer, ref, que, flags.threshold, timer, sync)


def run(flags, device: torch.device, params=None):
    """(record, extras): extras holds the renderer, the query ``que``,
    ``image_hw``, and of the fastest frame its dict ``frame``, its encode
    ``ref_c`` and its phases' host ``seconds``, unrounded."""
    renderer, ref, que, image_hw = setup(flags, device, params)
    phases = PHASES[flags.focus]
    n_rays = que["coords"].shape[1]
    chunk = renderer.cfg.ray_batch_num
    best = None
    for i in range(flags.warmup + flags.iters):
        timer = StageTimer()
        frame, ref_c = one_frame(flags, renderer, ref, que, image_hw, timer,
                                 device)
        if i < flags.warmup:
            continue
        s = timer.summary()
        total = sum(s[p] for p in phases)
        if best is None or total < best[0]:
            best = (total, s, frame, ref_c)
    total, s, frame, ref_c = best
    rec = {p: round(s[p], 3) for p in phases}
    kept = frame["kept_rays"]
    padded = -(-kept // chunk) * chunk
    rec.update(kept=kept, padded=padded, total=round(total, 3),
               rays_per_sec=round(n_rays / total, 1),
               pad_waste_fraction=round((padded - kept) / max(padded, 1), 4))
    rec.update({f"{p}_device_ms": round(s[f"{p}_device_ms"], 3)
                for p in phases if f"{p}_device_ms" in s})
    if device.type == "cuda" and flags.profile_frames:
        timer = StageTimer(busy=True)
        for _ in range(flags.profile_frames):
            one_frame(flags, renderer, ref, que, image_hw, timer, device)
        b = timer.summary()
        for p in phases:
            rec[f"{p}_busy_ms"] = round(b[f"{p}_busy_ms"], 3)
            rec[f"{p}_idle_share"] = round(
                1.0 - b[f"{p}_busy_ms"] / (1e3 * s[p]), 4)
    rec["device"] = device_name(device)
    return rec, dict(renderer=renderer, ref_c=ref_c, que=que,
                     image_hw=image_hw, frame=frame,
                     seconds={p: s[p] for p in phases})


def main(argv=None):
    flags = parse_args(argv)
    full_f32()
    device = resolve_device(flags.device)
    print("device:", device_name(device), flush=True)
    rec, _ = run(flags, device)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
