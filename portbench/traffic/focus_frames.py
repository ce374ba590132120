"""Closed-loop focus frames on the accelerator route of the bench
(``route``: bf16 compute, u8 gather maps, the diff features on the half
grid): each frame encodes its reference views (``encode_ref``), then
``render_frame_probe_focus`` probes every ``probe_stride``-th pixel and
row, keeps the rays whose probe score passes ``threshold`` (dilated by
``dilate``) and renders only those, coarse + fine inside their windows.
``rays_per_s`` is every ray of every frame over the window.

The check holds each frame's ``check_rays`` rays drawn from the seed to
the f32 reference of the same route: the share whose keep decision
differs (``keep_mismatch``) and, on the rays both keep, the widest gap of
the coarse colours (``coarse_err``) and the median ray's gap of the fine
ones (``fine_median_err``: in bf16 the fine sampler's CDF rounds, and a
few rays' fine samples land off the surface on either side, so the fine
colours' widest gap, ``fine_err``, read for the record, swings as far for
the route as for its control)."""
from __future__ import annotations

import numpy as np
import torch

from pb import core, counts, frames
from reference import model as M

PROBE_CHUNK = 16384


def frame_counts(f, kept: int):
    """A frame's FLOPs and gather bytes with ``kept`` rays rendered."""
    S = counts.file_shapes(f.weights)
    tr, route = f.tr, f.ctx.workload["route"]
    v, (h, w) = tr["ref_views"], tr["view_hw"]
    st, s = tr["probe_stride"], route["init_diff_scale"]
    probe = -(-h // st) * -(-w // st)
    psn, nc, nf = (route["probe_sample_num"], route["focus_sample_num"],
                   route["focus_fine_sample_num"])
    flops = (counts.encode(S, v, h, w, False)
             + counts.render_pass(S, probe, psn, v, False)
             + counts.render_pass(S, kept, nc, v, False)
             + counts.render_pass(S, kept, nf, v, True))
    # the bf16 outputs of the u8 maps; the f32 diff gather on the subgrid
    gbytes = (counts.gather_bytes((probe * psn + kept * (nc + nf)) * v,
                                  3 + 64, 2)
              + counts.gather_bytes(v * v * (h // s) * (w // s), 4, 4,
                                    masked=False))
    return {"flops": flops, "gather_bytes": gbytes, "rays": f.rays,
            "kept_rays": kept, "frames": 1}


def reference_frame(f, W, i, idx, pr):
    """The reference's keep mask [rn] and its (coarse, fine) colours of
    the rays idx it keeps (zeros elsewhere), for frame i."""
    tr, route = f.tr, f.ctx.workload["route"]
    h, w = tr["view_hw"]
    st = tr["probe_stride"]
    ref, _, que = f.inputs(i)
    ec = M.encode(W, ref, None, pr, route["init_diff_scale"])
    ys, xs = np.arange(0, h, st), np.arange(0, w, st)
    sub = torch.from_numpy((ys[:, None] * w + xs[None, :]).reshape(-1)).to(
        f.device)
    parts = []
    for a in range(0, len(sub), PROBE_CHUNK):
        q = dict(que, coords=que["coords"][:, sub[a:a + PROBE_CHUNK]])
        parts.append(M.focus_probe(W, ec, q, route["probe_sample_num"],
                                   pr=pr))
    score, near, far = (torch.cat([p[j] for p in parts], 1)[0]
                        for j in range(3))
    keep, near, far = M.strided_keep(score, near, far, (h, w), st,
                                     tr["threshold"])
    for _ in range(tr["dilate"]):
        keep = M.dilate(keep, (h, w))
    cols = [torch.zeros(1, len(idx), 3, device=f.device) for _ in range(2)]
    take = idx[keep[idx]]
    pos = torch.nonzero(keep[idx])[:, 0]
    for a in range(0, len(take), frames.CHECK_CHUNK):
        t = take[a:a + frames.CHECK_CHUNK]
        q = dict(que, coords=que["coords"][:, t])
        c, cf = M.focus_render(W, ec, q, near[t][None], far[t][None],
                               route["focus_sample_num"],
                               route["focus_fine_sample_num"], pr=pr)
        p = pos[a:a + frames.CHECK_CHUNK]
        cols[0][:, p], cols[1][:, p] = c, cf
    return keep, cols


def check(f, outs, against=None):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    W = M.load_weights(str(f.weights), f.device, f.scale)
    worst = {"keep_mismatch": 0.0, "coarse_err": 0.0, "fine_err": 0.0,
             "fine_median_err": 0.0}
    with torch.no_grad():
        for i, out in enumerate(outs):
            idx = torch.from_numpy(np.sort(f.check_rng.choice(
                f.rays, min(f.tr["check_rays"], f.rays),
                replace=False))).to(f.device)
            keep_r, want = reference_frame(f, W, i, idx, M.F32)
            if against is None:
                keep_p = torch.from_numpy(out["keep_mask"]).to(f.device)
                got = [torch.from_numpy(out[k]).to(f.device)[:, idx]
                       for k in frames.KEEP]
            else:
                keep_p, got = reference_frame(f, W, i, idx,
                                              M.Precision(against))
            kp, kr = keep_p[idx], keep_r[idx]
            worst["keep_mismatch"] = max(worst["keep_mismatch"],
                                         float((kp != kr).float().mean()))
            both = kp & kr
            if both.any():
                gaps = [(a[:, both] - b[:, both]).abs()
                        for a, b in zip(got, want)]
                fine = gaps[1].amax(-1)
                for key, gap in (("coarse_err", float(gaps[0].max())),
                                 ("fine_err", float(fine.max())),
                                 ("fine_median_err", float(fine.median()))):
                    worst[key] = max(worst[key], gap if gap == gap
                                     else float("inf"))
    return worst


def run(ctx: core.Ctx) -> core.Measured:
    from neuray_tpu_torch.models import renderer as R
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    f = frames.Frames(ctx, device)
    tr = f.tr
    kw = dict(threshold=tr["threshold"], keep_base=("pixel_colors_nr",),
              image_hw=tuple(tr["query_hw"]), dilate=tr["dilate"],
              probe_stride=tr["probe_stride"])

    def warmup():
        # a whole frame: the kept rays' count sets the focus passes' last
        # chunk, and every chunk shape runs
        ref, src, que = f.inputs(0)
        R.render_frame_probe_focus(f.renderer, R.encode_ref(f.renderer, ref),
                                   que, **kw)

    def render(i, win, spans):
        ref, _, que = f.inputs(i)
        with win.span("encode"):
            a = spans.mark()
            ec = R.encode_ref(f.renderer, ref)
            spans.add("encode", a, spans.mark())
        with win.span("probe_and_focus"):
            out = R.render_frame_probe_focus(f.renderer, ec, que, **kw)
        return out, frame_counts(f, out["kept_rays"])

    outs, cnt, win, spans, setup_s = frames.closed_loop(f, render, warmup)

    failed = sum(1 for o in outs if not all(np.isfinite(o[k]).all()
                                            for k in frames.KEEP))
    return core.Measured(
        e2e={"rays_per_s": cnt["rays"] / win.seconds}, attempted=len(outs),
        failed=failed, setup_s=setup_s, window=win, counters=cnt,
        spans=spans, check=lambda: check(f, outs), release=f.release)


def control(ctx: core.Ctx, n_frames: int, against: str):
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    f = frames.Frames(ctx, device, build_program=False)
    return check(f, [None] * n_frames, against)
