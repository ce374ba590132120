"""What the render cells share: the scene and its poses from the seed,
the closed loop of whole frames (a frame's 8 nearest views encoded, then
the frame rendered; the next frame starts when one is done), the spans
and counters the per-layer readers read, and the check of the frames'
outputs against the plain reference on rays drawn from the seed.

A cell's ``traffic`` holds: ``views`` (the scene's views), ``view_hw``
and ``query_hw`` ([h, w]), ``ref_views`` (the nearest views a frame
takes), ``src_nn`` (each ref's source views, the cost-volume layout; 0
for none), ``poses`` (the query poses drawn, taken in turn),
``warmup_rays`` and ``check_rays`` (rays of each frame held to the
reference). Its ``check`` holds each compared number's limit.
"""
from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from pb import core, program, scene
from reference import model as M

KEEP = ("pixel_colors_nr", "pixel_colors_nr_fine")
CHECK_CHUNK = 4096
# a colour this far from the reference's is off: the port's f32 parity
# tolerance
OFF = 1e-4


class Frames:
    """The scene, the program's renderer and the frame inputs of one
    run of a render cell."""

    def __init__(self, ctx: core.Ctx, device, build_program: bool = True):
        self.ctx = ctx
        self.device = device
        tr = self.tr = ctx.workload["traffic"]
        program.set_precision()
        torch.zeros(1, device=device)
        ctx.mark("device")
        rng = np.random.default_rng(ctx.seed)
        self.views = scene.make_views(rng, tr["views"], *tr["view_hw"],
                                      device)
        self.poses, self.Ks, self.coords = scene.make_queries(
            rng, tr["poses"], *tr["query_hw"], device)
        program.sync(device)
        ctx.mark("scene")
        self.check_rng = np.random.default_rng([ctx.seed, 1])
        self.weights = ctx.weights_path()
        self.scale = ctx.config.get("weights_scale", {})
        self.renderer = program.renderer(
            ctx.config, ctx.workload.get("route", {}), self.weights, device,
            self.scale) if build_program else None
        ctx.mark("program")
        self.rays = self.coords.shape[1]

    def inputs(self, i: int):
        """Frame i's (ref, src, que)."""
        k = i % self.tr["poses"]
        return scene.frame_inputs(self.views, self.poses[k], self.Ks[k],
                                  self.coords, self.tr["ref_views"],
                                  self.tr.get("src_nn", 0))

    def sync(self):
        program.sync(self.device)

    def release(self):
        """Free the program's state before the reference runs."""
        self.renderer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class DeviceSpans:
    """Spans of named calls on the device's clock (CUDA events; the host
    clock on the CPU), read after the window."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: Dict[str, list] = {}

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def add(self, name: str, start, end):
        self.marks.setdefault(name, []).append((start, end))

    def seconds(self) -> Dict[str, List[float]]:
        out = {}
        for name, pairs in self.marks.items():
            out[name] = [a.elapsed_time(b) / 1e3 if self.cuda else b - a
                         for a, b in pairs]
        return out


def closed_loop(f: Frames, render: Callable, warmup: Callable):
    """Warm up, then frames back to back until the window has lasted
    ``ctx.seconds`` (the frame under way finishes). ``render(i, win,
    spans)`` renders frame i and returns its outputs (tensors [1, rn,
    3] by key) and its counters. Returns (outputs, counters, window,
    spans, setup_s)."""
    warmup()
    f.sync()
    f.ctx.mark("warm-up")
    setup_s = f.ctx.setup_s()
    spans = DeviceSpans(f.device)
    outs, counters, frame_s = [], {}, []
    with f.ctx.window(f.sync) as win:
        i = 0
        while True:
            t0 = time.perf_counter()
            out, cnt = render(i, win, spans)
            f.sync()
            frame_s.append(time.perf_counter() - t0)
            outs.append(out)
            for k, v in cnt.items():
                counters[k] = counters.get(k, 0) + v
            i += 1
            if win.elapsed() >= f.ctx.seconds:
                break
    print("frames: " + " ".join(f"{t:.3f}" for t in frame_s) + " s",
          file=sys.stderr)
    return outs, counters, win, spans.seconds(), setup_s


def reference_colors(W, ref, src, que, idx, pr, render_fn):
    """The reference's (coarse, fine) colours of que's rays idx, in
    chunks of CHECK_CHUNK rays."""
    ec = M.encode(W, ref, src, pr)
    parts = []
    for s in range(0, len(idx), CHECK_CHUNK):
        q = dict(que, coords=que["coords"][:, idx[s:s + CHECK_CHUNK]])
        parts.append(render_fn(W, ec, q, pr))
    del ec
    return [torch.cat([p[j] for p in parts], 1) for j in range(2)]


def check_frames(f: Frames, outs, render_fn, precision="f32",
                 against: str | None = None) -> Dict[str, float]:
    """Every frame of the window, ``check_rays`` of its rays drawn from
    the seed, held to the reference: ``ray_gap_numbers`` of each ray's
    widest channel gap in the coarse and in the fine colours. With
    ``against``, a reference at that precision stands in the program's
    place (the control); ``precision`` is the reference's own."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    W = M.load_weights(str(f.weights), f.device, f.scale)
    n = f.tr["check_rays"]
    coarse, fine = [], []
    with torch.no_grad():
        for i, out in enumerate(outs):
            idx = torch.from_numpy(np.sort(f.check_rng.choice(
                f.rays, min(n, f.rays), replace=False))).to(f.device)
            ref, src, que = f.inputs(i)
            want = reference_colors(W, ref, src, que, idx,
                                    M.Precision(precision), render_fn)
            if against is None:
                got = [out[k][:, idx].float() for k in KEEP]
            else:
                got = reference_colors(W, ref, src, que, idx,
                                       M.Precision(against), render_fn)
            coarse.append((got[0] - want[0]).abs().amax(-1)[0])
            fine.append((got[1] - want[1]).abs().amax(-1)[0])
    return ray_gap_numbers({"coarse": torch.cat(coarse),
                            "fine": torch.cat(fine)})


def ray_gap_numbers(gaps: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """For each pass, from the checked rays' gaps: the share farther than
    ``OFF`` from the reference (``<pass>_off_share``), the widest gap and
    its 99th and 99.9th percentiles."""
    out = {}
    for name, g in gaps.items():
        if not torch.isfinite(g).all():
            g = torch.full_like(g, float("inf"))
        out[f"{name}_off_share"] = float((g > OFF).float().mean())
        out[f"{name}_err"] = float(g.max())
        for q, tag in ((0.99, "p99"), (0.999, "p999")):
            out[f"{name}_{tag}_err"] = float(torch.quantile(g, q))
    return out


def failed_frames(outs) -> int:
    return sum(1 for out in outs
               if not all(bool(torch.isfinite(out[k]).all()) for k in KEEP))
