"""Closed-loop exact frames: each frame encodes its reference views
(``encode_ref``) and renders every pixel of the query view coarse + fine
(``render_rays`` in the configuration's ``ray_batch_num``-ray chunks).
``rays_per_s`` is every ray of every frame over the window."""
from __future__ import annotations

import torch

from pb import core, counts, frames


def render_fn(W, ec, que, pr):
    from reference import model as M
    return M.render_rays(W, ec, que, pr=pr)


def frame_counts(f: frames.Frames):
    """A frame's FLOPs and gather bytes (``pb/counts.py``)."""
    S = counts.file_shapes(f.weights)
    tr, render = f.tr, f.ctx.config["render"]
    v, (h, w), rays = tr["ref_views"], tr["view_hw"], f.rays
    dn, fdn = render["depth_sample_num"], render["fine_depth_sample_num"]
    cv = render["init_net_type"] == "cost_volume"
    flops = (counts.encode(S, v, h, w, cv)
             + counts.render_pass(S, rays, dn, v, False)
             + counts.render_pass(S, rays, fdn, v, True))
    gbytes = counts.gather_bytes(rays * (dn + fdn) * v, 3 + 64, 4)
    if not cv:   # the depth init net's cross-view diff gather
        gbytes += counts.gather_bytes(v * v * h * w, 4, 4, masked=False)
    return {"flops": flops, "gather_bytes": gbytes, "rays": rays,
            "frames": 1}


def run(ctx: core.Ctx) -> core.Measured:
    from neuray_tpu_torch.models import renderer as R
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    f = frames.Frames(ctx, device)
    per_frame = frame_counts(f)

    def warmup():
        ref, src, que = f.inputs(0)
        ec = R.encode_ref(f.renderer, ref, src)
        n = ctx.workload["traffic"]["warmup_rays"]
        R.render_rays(f.renderer, ec, dict(que, coords=que["coords"][:, :n]),
                      frames.KEEP)

    def render(i, win, spans):
        ref, src, que = f.inputs(i)
        with win.span("encode"):
            a = spans.mark()
            ec = R.encode_ref(f.renderer, ref, src)
            spans.add("encode", a, spans.mark())
        with win.span("render"):
            out = R.render_rays(f.renderer, ec, que, frames.KEEP)
        return out, per_frame

    outs, cnt, win, spans, setup_s = frames.closed_loop(f, render, warmup)
    rays = cnt["rays"]

    return core.Measured(
        e2e={"rays_per_s": rays / win.seconds}, attempted=len(outs),
        failed=frames.failed_frames(outs), setup_s=setup_s, window=win,
        counters=cnt, spans=spans,
        check=lambda: frames.check_frames(f, outs, render_fn),
        release=f.release)


def control(ctx: core.Ctx, n_frames: int, against: str):
    """The control's readings: the reference at ``against`` in the
    program's place on the first n_frames frames' check rays."""
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    f = frames.Frames(ctx, device, build_program=False)
    return frames.check_frames(f, [None] * n_frames, render_fn,
                               against=against)
