"""Measure the CUDA gather kernel on one NVIDIA GPU, beside an earlier
version of it, and count the kernels of the focused render's passes.

    python3 gather_bench.py [--parent DIR] [--out FILE]
    python3 gather_bench.py --passes [--root DIR] [--out FILE]
    python3 gather_bench.py --routes [--out FILE]

Without ``--passes``: for every row of ``chip_smoke.KERNEL_SHAPES``
(random coords, 5% outside the map) and for the gathers of real render
chunks (the exact f32 render's coarse pass, the bench default's and the
bf16 map's focused coarse pass, through the image centre of the
synthetic sphere at 800x800 with ``tools/bench_weights.npz``), the
kernel's device time per launch (``torch.profiler``) at map pixels and
through the fused render entry, its bound (``chip_smoke.gather_bound``)
and share, and with ``--parent`` the device time of the kernel in DIR (a
checkout of an earlier commit: its ``neuray_tpu_torch/ops/gather.py`` is
loaded on its own and builds its own source), timed in turns (parent,
this, this, parent). Then the wrapper's host time per call (enqueue,
no synchronization) of both.

With ``--passes``: the bench default (bf16 + u8) and the same profile in
f32 render 16 chunks of the focus probe and 16 of the focused render
(kept rays through the image centre); per chunk, the host time of the
synchronized chunks, and under ``torch.profiler`` the device events, the
device busy time and the gather kernels' time; the device idle share is
1 - busy / host time. ``--root DIR`` imports ``neuray_tpu_torch`` from
DIR, so the passes of an earlier commit run in the same call.

With ``--routes``: every route the kernel can take at each row (8- or
16-byte vectors, one thread a point for c = 3 or 4, one lane a channel),
map-pixel entry, each checked against the plain version; the numbers
behind ``ops/gather.py``'s route table.

Every number names the card (``nvidia-smi`` name and power limit).
Results print one line each and, with ``--out``, go to a JSON file.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as CS

ROOT = Path(__file__).resolve().parent


def log(*args):
    print(*args, flush=True)


def host_us(fn, *args, n=500):
    """Host time per call: the enqueue, with the queue drained first."""
    for _ in range(20):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def map_pixel_call(GA, feats, pix, dq):
    if feats.dtype == torch.uint8:
        return GA.gather_bilinear_border_u8, (feats, pix, *dq)
    return GA.gather_bilinear_border, (feats, pix)


def time_row(GA, parent, feats, pix, dq=None, fused_args=None,
             fused_pix=None):
    """Device ms of the kernel at map pixels pix (and the parent's, in
    turns), of the fused entry on fused_args (whose points convert to
    fused_pix, default pix), and the bounds."""
    fn, args = map_pixel_call(GA, feats, pix, dq)
    row = {}
    if parent is not None:
        pfn, pargs = map_pixel_call(parent, feats, pix, dq)
        times = [CS.device_ms(f, *a)[0] for f, a in
                 ((pfn, pargs), (fn, args), (fn, args), (pfn, pargs))]
        row["parent_device_ms"] = [times[0], times[3]]
        row["device_ms"] = [times[1], times[2]]
    else:
        row["device_ms"] = [CS.device_ms(fn, *args)[0]]
    nbytes, touched, bound_ms, by = CS.gather_bound(GA, feats, pix)
    row.update(bytes=nbytes, touched_pixels=touched, bound_ms=bound_ms,
               bound_by=by, share=bound_ms / min(row["device_ms"]))
    if fused_args:
        fms = CS.device_ms(GA.gather_feature_map, *fused_args)[0]
        fbytes, _, fbound, _ = CS.gather_bound(
            GA, feats, pix if fused_pix is None else fused_pix, True)
        row.update(fused_device_ms=fms, fused_bytes=fbytes,
                   fused_bound_ms=fbound, fused_share=fbound / fms)
    return row


def row_text(row):
    t = (f"device {' / '.join(f'{x:.4f}' for x in row['device_ms'])} ms")
    if "parent_device_ms" in row:
        t += (" (parent " + " / ".join(
            f"{x:.4f}" for x in row["parent_device_ms"]) + " ms)")
    t += (f"; bound {row['bytes']} B ({row['touched_pixels']} pixels) = "
          f"{1e3 * row['bound_ms']:.2f} us ({row['bound_by']}), share "
          f"{row['share']:.3f}")
    if "fused_device_ms" in row:
        t += (f"; fused entry {row['fused_device_ms']:.4f} ms, bound "
              f"{1e3 * row['fused_bound_ms']:.2f} us, share "
              f"{row['fused_share']:.3f}")
    return t


def random_inputs(GA, dev):
    """(label, map, map-pixel coords, dequant, fused entry args, their map
    pixels) for every row of chip_smoke.KERNEL_SHAPES, random coords."""
    g = torch.Generator(device=dev).manual_seed(0)
    for what, fh, fw, c, p, dtypes, fused in CS.KERNEL_SHAPES:
        v = CS.RFN
        base = torch.rand((v, fh, fw, c), generator=g, device=dev)
        pix = CS.random_coords(g, dev, v, p, fh, fw)
        points = CS.random_coords(g, dev, v, p, CS.H, CS.W)
        mask = (torch.rand((v, p), generator=g, device=dev) > 0.3).float()
        for dtype in dtypes:
            dq = None
            if dtype == torch.uint8:
                feats = torch.randint(0, 256, (v, fh, fw, c), generator=g,
                                      device=dev, dtype=dtype)
                scale = torch.rand(c, generator=g, device=dev) / 127.0
                dq = (scale, scale * 128.0)
            else:
                feats = base.to(dtype)
            fused_args = fpix = None
            if fused:
                fused_args = (feats, points, mask, CS.H, CS.W, dq)
                fpix = GA.feature_pixel_coords(points, CS.H, CS.W, fh, fw,
                                               fh == CS.H and fw == CS.W)
            yield (f"random coords: {what} [{v},{fh},{fw},{c}] x {p} "
                   f"{str(dtype)[6:]}", feats, pix, dq, fused_args, fpix)
        del base, pix, points, mask


def load_scene(R, dev):
    from neuray_tpu_torch.data.synthetic import make_query, make_sphere_scene
    from neuray_tpu_torch.utils.params import (
        load_flax_params, load_params_npz)
    rng = np.random.RandomState(0)
    ref_np = make_sphere_scene(rng, CS.RFN, CS.H, CS.W)
    que_np = make_query(rng, CS.H, CS.W, 0, full_image=True)
    que_np.pop("imgs")
    ref = {k: torch.from_numpy(v).to(dev) for k, v in ref_np.items()}
    que = {k: torch.from_numpy(v).to(dev) for k, v in que_np.items()}
    params = load_params_npz(str(ROOT / "tools" / "bench_weights.npz"))

    def build(**cfg):
        r = R.NeurayRenderer(R.RenderConfig(**cfg))
        load_flax_params(r, params)
        return r.to(dev).eval()
    return ref, que, build


def centre_chunk(que, n, idx=None):
    """n rays through the image centre (of idx if given), as numpy."""
    idx = np.arange(que["coords"].shape[1]) if idx is None else idx
    start = max(0, (idx.size - n) // 2)
    return idx[start:start + n]


def capture(module, name, fn):
    """The arguments of every call that fn makes to ``module.name``."""
    calls, real = [], getattr(module, name)

    def record(*args):
        calls.append(args)
        return real(*args)
    setattr(module, name, record)
    try:
        with torch.inference_mode():
            fn()
    finally:
        setattr(module, name, real)
    return calls


def real_inputs(GA, dev):
    """As ``random_inputs``, for the gathers of real chunks (their points
    lie on a few epipolar segments of each view) and of the encodes' diff
    gathers (full and half grid)."""
    from neuray_tpu_torch.models import init_net as N
    from neuray_tpu_torch.models import renderer as R
    from neuray_tpu_torch.ops import interpolate as I
    ref, que, build = load_scene(R, dev)
    exact = dict(use_hierarchical_sampling=True, depth_sample_num=CS.DN,
                 fine_depth_sample_num=CS.DN, ray_batch_num=CS.CHUNK,
                 use_vis=False, fine_use_vis=False)
    routes = [("exact f32, coarse pass", exact, None),
              ("bench default bf16 + u8, focused coarse pass",
               CS.BENCH_PROFILE, True),
              ("bench default with a bf16 map, focused coarse pass",
               dict(CS.BENCH_PROFILE, gather_quant="none"), True)]
    for what, cfg, focused in routes:
        r = build(**cfg)
        diff = capture(N, "gather_bilinear_border",
                       lambda: R.encode_ref(r, ref))
        ref_c = R.encode_ref(r, ref)
        if focused:
            keep, near, far = R._strided_focus_probe(
                r, ref_c, que, CS.BENCH_ARGS["threshold"], (CS.H, CS.W),
                CS.BENCH_ARGS["probe_stride"])
            part = centre_chunk(que, CS.CHUNK, np.nonzero(keep)[0])
            n, f = (torch.from_numpy(w[:, part]).to(dev) for w in (near, far))
            q = R._take_rays(que, part)
            calls = capture(I, "gather_feature_map",
                            lambda: r.render_chunk_focus(ref_c, q, n, f))
        else:
            q = R._take_rays(que, centre_chunk(que, CS.CHUNK))
            calls = capture(I, "gather_feature_map",
                            lambda: r.render_chunk(ref_c, q))
        if what.startswith(("exact", "bench default bf16 + u8")):
            feats, pix = diff[0]
            yield (f"real coords: encode diff, {what.split(',')[0]} "
                   f"{list(feats.shape)} x {pix.shape[1]} f32", feats, pix,
                   None, None, None)
        for name, args in zip(("rgb", "feats"), calls[:2]):
            feats, points, mask, h, w, dq = args
            fh, fw = feats.shape[1:3]
            pix = GA.feature_pixel_coords(points, h, w, fh, fw,
                                          fh == h and fw == w)
            yield (f"real coords: {what}, {name} {list(feats.shape)} x "
                   f"{points.shape[1]} {str(feats.dtype)[6:]}", feats, pix,
                   dq, args, pix)


def measure(GA, parent, dev):
    rows = []
    for gen in (random_inputs(GA, dev), real_inputs(GA, dev)):
        for label, feats, pix, dq, fused_args, fpix in gen:
            row = time_row(GA, parent, feats, pix, dq, fused_args, fpix)
            row["what"] = label
            rows.append(row)
            log(f"{label}: {row_text(row)}")
    return rows


def route_candidates(feats):
    """The kernel routes (elements a lane loads, as one vector?) that can
    take this map."""
    size, c = feats.element_size(), feats.shape[-1]
    out = [(vb // size, True) for vb in (16, 8) if (c * size) % vb == 0]
    return out + [(1, False)]


def check(out, ref):
    """A route's output against the plain version: f32 1e-5, bf16 one
    bf16 ulp of the value (these maps are not in [0, 1)), u8 codes
    bit-equal."""
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    elif not torch.equal(out, ref):
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                                   atol=1e-6)


def routes(GA, dev):
    """Device time of every route at every row, map-pixel entry; each
    output held to the plain version as in chip_smoke.hold."""
    rows, chosen = [], GA._route
    try:
        for gen in (random_inputs(GA, dev), real_inputs(GA, dev)):
            for label, feats, pix, dq, _, _ in gen:
                fn, args = map_pixel_call(GA, feats, pix, dq)
                ref_fn = (GA.gather_bilinear_border_u8_ref if dq
                          else GA.gather_bilinear_border_ref)
                row = {"what": label, "default": list(chosen(feats))}
                for route in route_candidates(feats):
                    GA._route = lambda f, route=route: route
                    out = fn(*args)
                    if dq and not torch.equal(out, ref_fn(*args)):
                        raise RuntimeError(f"u8 route {route} is not "
                                           "bit-equal to the plain version")
                    check(out, ref_fn(*args))
                    row[str(route)] = CS.device_ms(fn, *args)[0]
                    GA._route = chosen
                rows.append(row)
                log(f"{label}: " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in row.items()
                    if k.startswith("(")) + f" (default {row['default']})")
    finally:
        GA._route = chosen
    return rows


def host_rows(GA, parent, dev):
    """The wrappers' host time per call at the focused chunk's 64-channel
    gather (the device takes less than the host there)."""
    g = torch.Generator(device=dev).manual_seed(1)
    v, p = CS.RFN, CS.CHUNK * CS.BENCH_PROFILE["focus_sample_num"]
    feats = torch.rand((v, CS.H // 4, CS.W // 4, 64), generator=g,
                       device=dev).to(torch.bfloat16)
    pix = CS.random_coords(g, dev, v, p, CS.H // 4, CS.W // 4)
    points = CS.random_coords(g, dev, v, p, CS.H, CS.W)
    mask = torch.ones((v, p), device=dev)
    out = {}
    order = ([("parent", parent)] if parent else []) + [("this", GA)] * 2 \
        + ([("parent", parent)] if parent else [])
    for name, mod in order:
        out.setdefault(name, []).append(
            host_us(mod.gather_bilinear_border, feats, pix))
    out["this, fused entry"] = [host_us(GA.gather_feature_map, feats,
                                        points, mask, CS.H, CS.W)]
    log("host us per call, bf16 [8,200,200,64] x 12288: " + "; ".join(
        f"{k} {', '.join(f'{x:.2f}' for x in v)}" for k, v in out.items()))
    return out


def passes(dev):
    """Kernels, device busy time and idle share per chunk of the focused
    profile's two passes, bf16 + u8 and f32."""
    from neuray_tpu_torch.models import renderer as R
    from torch.profiler import ProfilerActivity, profile
    ref, que, build = load_scene(R, dev)
    out = {}
    for route, over in (("bf16 + u8", {}),
                        ("f32", dict(use_bf16=False, gather_quant="none"))):
        r = build(**{**CS.BENCH_PROFILE, **over})
        ref_c = R.encode_ref(r, ref)
        keep, near, far = R._strided_focus_probe(
            r, ref_c, que, CS.BENCH_ARGS["threshold"], (CS.H, CS.W),
            CS.BENCH_ARGS["probe_stride"])
        n_chunks = min(16, int(keep.sum()) // CS.CHUNK)
        kept = centre_chunk(que, n_chunks * CS.CHUNK, np.nonzero(keep)[0])
        every = centre_chunk(que, n_chunks * CS.CHUNK)
        chunks = {"probe": [], "focused render": []}
        for i in range(n_chunks):
            part = every[i * CS.CHUNK:(i + 1) * CS.CHUNK]
            chunks["probe"].append(
                (lambda q: lambda: r.probe_chunk_focus(ref_c, q))(
                    R._take_rays(que, part)))
            part = kept[i * CS.CHUNK:(i + 1) * CS.CHUNK]
            n, f = (torch.from_numpy(w[:, part]).to(dev) for w in (near, far))
            chunks["focused render"].append(
                (lambda q, n, f: lambda: r.render_chunk_focus(ref_c, q, n, f))(
                    R._take_rays(que, part), n, f))
        for kind, steps in chunks.items():
            with torch.inference_mode():
                steps[0]()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for s in steps:
                    s()
                torch.cuda.synchronize()
                host_ms = 1e3 * (time.perf_counter() - t0) / n_chunks
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for s in steps:
                        s()
                    torch.cuda.synchronize()
            events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            if not events:
                raise RuntimeError("torch.profiler recorded no device time")
            busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
            gather = sum(e.time_range.elapsed_us() for e in events
                         if "gather_lanes" in e.name
                         or "gather_bilinear_border" in e.name) / 1e3
            res = dict(kernels_per_chunk=len(events) / n_chunks,
                       host_ms_per_chunk=host_ms,
                       busy_ms_per_chunk=busy / n_chunks,
                       gather_ms_per_chunk=gather / n_chunks,
                       idle_share=1.0 - busy / n_chunks / host_ms)
            out[f"{route}, {kind}"] = res
            log(f"passes: {route}, {kind}: {res['kernels_per_chunk']:g} "
                f"device events per chunk, host {host_ms:.3f} ms per chunk, "
                f"device busy {res['busy_ms_per_chunk']:.3f} ms (gather "
                f"kernels {res['gather_ms_per_chunk']:.4f} ms), idle "
                f"{res['idle_share']:.3f}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit whose "
                    "gather kernel is timed beside this one")
    ap.add_argument("--passes", action="store_true",
                    help="count the focused render's kernels per chunk")
    ap.add_argument("--routes", action="store_true",
                    help="time every kernel route at every row")
    ap.add_argument("--root", default=str(ROOT),
                    help="import neuray_tpu_torch from this checkout")
    ap.add_argument("--out", help="write the results here as JSON")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gather_bench.py: no CUDA device")
    sys.path.insert(0, str(Path(a.root).resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {smi}; torch {torch.__version__}; root {a.root}")
    result = {"device": smi, "root": a.root}
    if a.passes:
        result["passes"] = passes(dev)
    else:
        from neuray_tpu_torch.ops import gather as GA
        GA.load_library()
        if a.routes:
            result["routes"] = routes(GA, dev)
        else:
            parent = None
            if a.parent:
                parent = CS.load_gather(a.parent)
                parent.load_library()
            result["parent"] = a.parent
            result["rows"] = measure(GA, parent, dev)
            result["host_us"] = host_rows(GA, parent, dev)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
