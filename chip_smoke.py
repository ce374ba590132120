"""Smoke run of the PyTorch port (``neuray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raising (exit code != 0):
  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. build the CUDA gather kernel from ``neuray_tpu_torch/csrc`` with nvcc;
  3. hold the kernel to its plain PyTorch twin on the card, each
     instantiation (f32, bf16, u8) and entry (map pixels; the fused render
     entry, which converts frame points and applies the mask) at the
     render path's shapes (``KERNEL_SHAPES``, coords partly out of range),
     with the bounds of ``hold``; per row print the kernel's device time
     (``torch.profiler``), its CUDA-event time, the plain version's and
     ``F.grid_sample``'s, and the bound (``gather_bound``: bytes moved
     over the HBM rate against flops over the f32 rate) with its share;
  4. render a full 800x800 novel view of the synthetic sphere from 8
     reference views, 64 coarse + 64 fine samples, with the trained
     ``tools/bench_weights.npz``: warm-up frame, then a timed frame whose
     kernel launches are counted; outputs finite, PSNR against the
     ground-truth image >= 24 dB;
  5. 2048 rays through the image centre again from the same encoded
     maps, on the card (kernel) and on the CPU (plain PyTorch): each pass
     agrees to 1e-4 on the same inputs (``in_situ``);
  6. the shipped fast eval profile (``configs/gen/neuray_gen_depth_fast
     .yaml``: half-grid init diff, self-auditing probe-focused render,
     probe every 2nd pixel) on the same scene, weights and query:
     warm-up frame, then a timed frame (encode + ``render_frame_probe_auto``)
     whose gather launches must equal what its chunk counts imply;
     GT-PSNR >= 24 dB; then 2048 kept rays through the image centre,
     card against CPU inside the probe's windows, each pass to 1e-4;
  7. ``bench.py``'s accelerator default on the same scene, weights and
     query: bf16 compute and the u8 gather map, half-grid init diff,
     ``render_frame_probe_focus`` with a 16-sample probe every 2nd pixel,
     threshold 0.01, dilate 1, 12 + 24 focus samples. Warm-up frame, then
     a timed frame (encode + render) whose gather launches must equal
     what its chunk counts imply, by instantiation; GT-PSNR >= 24 dB.
     Then the same profile with a bf16 map (no u8) and in f32, one frame
     each: PSNR of each bf16 frame against the f32 frame >= 30 dB (a
     broken route, not rounding) and the count of rays whose keep
     decision differs. Then 2048 kept rays through the image centre, card
     against CPU inside the probe's windows, each pass's colours within
     ``BF16_PASS_BOUND`` = 0.05 on the same inputs: two bf16
     implementations of a pass round differently, and the CPU test
     ``tests/test_torch_port_bf16.py::test_passes_on_the_same_inputs``
     measures the port against the JAX package at 0.012-0.039 per pass
     and holds it to this bound.
The line before the last is a JSON record of the kernel's instantiations
(time, bound and grid_sample's time at each one's 64-channel per-chunk
gather, ``KEY_ROWS``);
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
it exits non-zero before printing anything.
"""
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H = W = 800
RFN = 8
CHUNK = 1024
DN = 64
N_CHECK = 2048
PSNR_FLOOR = 24.0
# configs/gen/neuray_gen_depth_fast.yaml as RenderConfig fields (the
# card's machine has no yaml; tests/test_torch_port_drivers.py holds this
# to RenderConfig.from_cfg of the parsed file)
FAST_PROFILE = dict(
    use_hierarchical_sampling=True, use_vis=False, fine_use_vis=False,
    init_diff_scale=2, ray_batch_num=CHUNK, probe_sample_num=16,
    focus_sample_num=16, focus_fine_sample_num=32)
# the profile's render_frame_probe_auto arguments (skip_empty_threshold,
# skip_auto_tol, probe_dilate, probe_stride)
FAST_ARGS = dict(threshold=0.01, tol=0.02, dilate=1, probe_stride=2)
# bench.py's accelerator default (BENCH_* unset) as RenderConfig fields,
# and its render_frame_probe_focus arguments
BENCH_PROFILE = dict(
    use_hierarchical_sampling=True, depth_sample_num=DN,
    fine_depth_sample_num=DN, ray_batch_num=CHUNK, probe_sample_num=16,
    focus_sample_num=12, focus_fine_sample_num=24, init_diff_scale=2,
    use_vis=False, fine_use_vis=False, use_bf16=True, gather_quant="u8")
BENCH_ARGS = dict(threshold=0.01, dilate=1, probe_stride=2)
BF16_PASS_BOUND = 0.05
BF16_PSNR_FLOOR = 30.0


def log(*args):
    print(*args, flush=True)


def time_ms(fn, *args, warmup=3, iters=20):
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, *args, n=10):
    """Device time per call from ``torch.profiler``'s device rows: the
    summed duration of every device event of n calls, over n (at the
    per-chunk shapes a CUDA-event window measures the wrapper's host
    time, not the kernel). Returns (ms, device events per call, names)."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("torch.profiler recorded no device time")
    total_us = sum(e.time_range.elapsed_us() for e in events)
    return (total_us / n / 1e3, len(events) / n,
            sorted({e.name for e in events}))


# the bound: NVIDIA H100 SXM's published peaks (HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def gather_bound(GA, feats, pix, masked=False):
    """The least time the card could take for one gather of feats
    [v, fh, fw, c] at map pixels pix [v, p, 2]: each input byte read once
    (the coordinates; the map pixels the taps touch, counted distinct;
    the mask; u8's scale and offset) and each output byte written once,
    over the HBM rate, against 9 flops a channel (three lerps of two
    multiplies and an add; u8 +2 to dequantize, the mask +1) over the f32
    rate. Returns (bytes, touched pixels, bound ms, "bytes" or
    "operations")."""
    v, fh, fw, c = feats.shape
    p = pix.shape[1]
    u8 = feats.dtype == torch.uint8
    out_size = 2 if u8 else feats.element_size()
    touched = GA.touched_pixels(pix, fh, fw)
    nbytes = (touched * c * feats.element_size() + v * p * 2 * 4
              + v * p * c * out_size + (v * p * 4 if masked else 0)
              + (2 * c * 4 if u8 else 0))
    flops = v * p * c * (9 + 2 * u8 + masked)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (nbytes, touched, 1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def random_coords(g, dev, v, p, fh, fw):
    """[v, p, 2] pixels of an (fh, fw) grid with a 5% margin outside it
    on every side: the border clamp."""
    coords = torch.rand((v, p, 2), generator=g, device=dev)
    coords = coords * torch.tensor([fw * 1.1, fh * 1.1], device=dev)
    return (coords - torch.tensor([fw * 0.05, fh * 0.05],
                                  device=dev)).contiguous()


def grid_sample_fn(feats, pix):
    """The one PyTorch call that computes the plain-coords gather on the
    same map, timed as ``library_ms`` and used nowhere in the port:
    ``F.grid_sample`` on the NCHW view, coords normalized for
    align_corners=True, border padding. Its grid takes the map's dtype."""
    import torch.nn.functional as F
    fh, fw = feats.shape[1:3]
    nchw = feats.permute(0, 3, 1, 2)
    scale = torch.tensor([2.0 / (fw - 1), 2.0 / (fh - 1)], device=pix.device)
    grid = (pix * scale - 1.0)[:, None].to(feats.dtype)

    def call():
        return F.grid_sample(nchw, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)
    return call


F32, BF16, U8 = torch.float32, torch.bfloat16, torch.uint8
# phase 3: (what, map h, map w, channels, points per view, instantiations,
# also the fused render entry); the frame is (H, W), RFN views
KERNEL_SHAPES = [
    ("feats 1/4 res, per chunk", H // 4, W // 4, 64, CHUNK * DN,
     (F32, BF16), True),
    ("rgb full res, per chunk", H, W, 3, CHUNK * DN, (F32, BF16), True),
    ("feats 1/4 res, per focused chunk", H // 4, W // 4, 64,
     CHUNK * BENCH_PROFILE["focus_sample_num"], (F32, BF16, U8), True),
    ("rgb full res, per focused chunk", H, W, 3,
     CHUNK * BENCH_PROFILE["focus_sample_num"], (F32, BF16, U8), True),
    ("diff [depth|rgb], per encode", H, W, 4, RFN * H * W, (F32, BF16),
     False),
    ("diff [depth|rgb], per half-grid encode", H // 2, W // 2, 4,
     RFN * (H // 2) * (W // 2), (F32, BF16), False)]
# each instantiation's row in the kernels line: its 64-channel per-chunk
# gather on the main path (u8 serves the focused passes)
KEY_ROWS = {"f32": "feats 1/4 res, per chunk",
            "bf16": "feats 1/4 res, per chunk",
            "u8": "feats 1/4 res, per focused chunk"}


def hold(name, out, ref):
    """Kernel against its plain version on the same inputs. f32: 1e-5
    (FMA contraction in the lerps; the coordinate conversion divides in
    IEEE f32 on both sides, see ``feature_pixel_coords``). bf16: both
    lerp in f32 and round once, so contraction may put a value on the
    other side of a rounding boundary: one bf16 ulp of values in [0, 1),
    2^-8. u8 at map pixels: bit-equal (every f32 op rounded as the plain
    version's); the fused u8 entry: one bf16 ulp of the output. Returns
    the max abs error."""
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if out.dtype == F32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    elif name == "u8":
        if not torch.equal(out, ref):
            raise RuntimeError(f"u8 kernel differs from its plain version "
                               f"by {err}")
    else:
        rtol = 2.0 ** -8 if name == "u8 fused" else 0.0
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                                   atol=2.0 ** -8)
    return err


def check_kernel(GA, dev):
    """Phase 3: every instantiation and entry against its plain version
    at the main path's shapes, timed (kernel device time from the
    profiler, CUDA-event times of kernel and plain version, grid_sample's
    time) beside its bound. Returns (the rows, {instantiation: its
    kernels-line stats})."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows, stats = [], {}
    for what, fh, fw, c, p, dtypes, fused in KERNEL_SHAPES:
        v = RFN
        base = torch.rand((v, fh, fw, c), generator=g, device=dev)
        pix = random_coords(g, dev, v, p, fh, fw)
        points = random_coords(g, dev, v, p, H, W)
        mask = (torch.rand((v, p), generator=g, device=dev) > 0.3).float()
        for dtype in dtypes:
            name = {F32: "f32", BF16: "bf16", U8: "u8"}[dtype]
            if dtype == U8:
                feats = torch.randint(0, 256, (v, fh, fw, c), generator=g,
                                      device=dev, dtype=U8)
                scale = torch.rand(c, generator=g, device=dev) / 127.0
                dq = (scale, scale * 128.0)
                kernel = (GA.gather_bilinear_border_u8, feats, pix, *dq)
                plain = GA.gather_bilinear_border_u8_ref
            else:
                feats, dq = base.to(dtype), None
                kernel = (GA.gather_bilinear_border, feats, pix)
                plain = GA.gather_bilinear_border_ref
            jobs = [("map pixels", kernel, (plain, *kernel[1:]),
                     pix, False, None if dq else grid_sample_fn(feats, pix))]
            if fused:
                args = (feats, points, mask, H, W, dq)
                jobs.append((
                    "fused", (GA.gather_feature_map, *args),
                    (GA.gather_feature_map_ref, *args),
                    GA.feature_pixel_coords(points, H, W, fh, fw,
                                            fh == H and fw == W),
                    True, None))
            for entry, (fn, *a), (ref_fn, *ra), at, masked, lib in jobs:
                err = hold(name if entry == "map pixels" else name + " fused",
                           fn(*a), ref_fn(*ra))
                ms = time_ms(fn, *a)
                dev_ms, per_call, kernels = device_ms(fn, *a)
                plain_ms = time_ms(ref_fn, *ra)
                lib_ms = None if lib is None else time_ms(lib)
                nbytes, touched, bound_ms, bound_by = gather_bound(
                    GA, feats, at, masked)
                row = dict(what=what, entry=entry, dtype=name,
                           shape=[v, fh, fw, c], points=p, max_abs_err=err,
                           device_ms=dev_ms, event_ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bytes=nbytes,
                           touched_pixels=touched, bound_ms=bound_ms,
                           bound_by=bound_by, share=bound_ms / dev_ms)
                rows.append(row)
                lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
                log(f"kernel check: {what} [{v},{fh},{fw},{c}] x [{v},{p},2]"
                    f" {name} {entry}: max_abs_err {err:.3g}; kernel device "
                    f"{dev_ms:.4f} ms ({per_call:g} launch/call {kernels}), "
                    f"events {ms:.4f} ms; plain {plain_ms:.4f} ms; grid_sample"
                    f" {lib_txt}; bound {nbytes} B ({touched} pixels touched)"
                    f" = {1e3 * bound_ms:.2f} us ({bound_by}), share "
                    f"{bound_ms / dev_ms:.3f}")
                s = stats.setdefault(name, {"max_abs_err": 0.0})
                s["max_abs_err"] = max(s["max_abs_err"], err)
                if entry == "map pixels" and what == KEY_ROWS[name]:
                    s.update(ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=lib_ms)
    return rows, stats


def psnr(img, gt):
    mse = float(np.mean((img.astype(np.float64) - gt) ** 2))
    return -10.0 * np.log10(mse)


def in_situ(R, renderer, ref_c, que, idx, windows=None, bound=1e-4):
    """The kernel path in place against the plain path on the CPU, from
    the same encoded maps, on the rays idx (numpy): the exact passes, or
    with ``windows`` = (near, far) [1, rn] the focused passes inside
    them.

    Each pass's colours are held to ``bound`` (f32: 1e-4; bf16:
    ``BF16_PASS_BOUND``) on the same inputs: the coarse
    pass from the same depths, the fine pass from the same (the card's)
    fine depths. The coarse hit_prob_nr and the end-to-end fine colours
    are reported, not held: the fine
    sampler divides the coarse hit mass by its sum, so on nearly empty
    rays (sum ~0.006) a 1e-5 difference in hit_prob moves fine depths by
    ~1e-3 and their colours by up to a few 1e-3 (3.4e-3 measured on
    this scene)."""
    from neuray_tpu_torch.ops import sampling as S
    cpu_renderer = copy.deepcopy(renderer).cpu()
    ref_cpu = {k: v.cpu() for k, v in ref_c.items()}
    worst = {"coarse pixel_colors_nr": 0.0, "coarse hit_prob_nr": 0.0,
             "fine pixel_colors_nr_fine": 0.0,
             "end-to-end pixel_colors_nr_fine": 0.0}

    def diff(key, a, b):
        worst[key] = max(worst[key],
                         (a.cpu().float() - b.float()).abs().max().item())

    def cpu(x):
        return None if x is None else x.cpu()

    with torch.inference_mode():
        for part in np.array_split(idx, -(-idx.size // CHUNK)):
            q_gpu = R._take_rays(que, part)
            q_cpu = {k: v.cpu() for k, v in q_gpu.items()}
            if windows is None:
                depth, _ = S.sample_depth(q_gpu["depth_range"], 1, part.size,
                                          DN)
                pos = None
            else:
                near, far = (torch.from_numpy(w[:, part]).to(
                    que["coords"].device) for w in windows)
                depth, pos = renderer.focus_depths(q_gpu, near, far)
            c_gpu = renderer._render_by_depth(depth, q_gpu, ref_c, False, pos)
            c_cpu = cpu_renderer._render_by_depth(depth.cpu(), q_cpu, ref_cpu,
                                                  False, cpu(pos))
            for key in ("pixel_colors_nr", "hit_prob_nr"):
                diff("coarse " + key, c_gpu[key], c_cpu[key])
            if windows is None:
                fine = renderer._fine_depth(depth, c_gpu["hit_prob_nr"],
                                            q_gpu["depth_range"], DN)
                pos = None
                e2e_cpu = cpu_renderer.render_chunk(ref_cpu, q_cpu)
            else:
                fine, pos = renderer.focus_fine_depths(
                    q_gpu, depth, c_gpu["hit_prob_nr"])
                e2e_cpu = cpu_renderer.render_chunk_focus(
                    ref_cpu, q_cpu, near.cpu(), far.cpu())
            f_gpu = renderer._render_by_depth(fine, q_gpu, ref_c, True, pos)
            f_cpu = cpu_renderer._render_by_depth(fine.cpu(), q_cpu, ref_cpu,
                                                  True, cpu(pos))
            diff("fine pixel_colors_nr_fine", f_gpu["pixel_colors_nr"],
                 f_cpu["pixel_colors_nr"])
            diff("end-to-end pixel_colors_nr_fine", f_gpu["pixel_colors_nr"],
                 e2e_cpu["pixel_colors_nr_fine"])
    what = "exact" if windows is None else "focused"
    log(f"in situ ({what}): {idx.size} rays from #{idx[0]}, card vs CPU "
        "max_abs_err: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    held = {k: v for k, v in worst.items() if "pixel_colors" in k
            and not k.startswith("end")}
    if not all(v <= bound for v in held.values()):
        raise RuntimeError(f"card and CPU passes differ: {held}")


def expected_fast_launches(out, n_rays, n_probe):
    """Gather launches implied by ``render_frame_probe_auto``'s own chunk
    counts: 1 for the encode's half-grid diff gather, and 2 (rgb, then
    the 64-ch map) per chunk pass. Per audit rung: the strided probe over
    n_probe rays, the false-skip audit over min(skipped, 2048) rays and,
    where it ran, the window audit over min(kept, 1024) rays. Then the
    focused render, 2 passes over the kept rays, or on fallback the exact
    coarse pass over every ray and the fine pass over the kept ones."""
    def chunks(n):
        return -(-n // CHUNK)

    passes = 0
    for rung in out["audit_trail"]:
        kept = round(rung["kept_fraction"] * n_rays)
        passes += chunks(n_probe) + chunks(min(n_rays - kept, 2048))
        if rung["window_clip_db"] is not None:
            passes += chunks(min(kept, 1024))
    if out["fallback"] is None:
        passes += 2 * chunks(out["kept_rays"])
    else:
        passes += chunks(n_rays) + chunks(out["kept_rays"])
    return 1 + 2 * passes


def fast_profile(R, GA, renderer, ref, que, gt, full_img):
    """Phase 6. Returns the gather launches of its timed frame, by
    instantiation."""
    fast = R.NeurayRenderer(R.RenderConfig(**FAST_PROFILE))
    fast.load_state_dict(renderer.state_dict())
    fast = fast.to(ref["imgs"].device).eval()
    n_rays = que["coords"].shape[1]
    stride = FAST_ARGS["probe_stride"]
    n_probe = -(-H // stride) * -(-W // stride)

    def frame():
        t0 = time.perf_counter()
        ref_c = R.encode_ref(fast, ref)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = R.render_frame_probe_auto(fast, ref_c, que, image_hw=(H, W),
                                        focus=True, **FAST_ARGS)
        torch.cuda.synchronize()
        return ref_c, out, t0, t1, time.perf_counter()

    t0 = time.perf_counter()
    frame()
    log(f"fast profile warm-up frame: {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    GA.reset_launches()
    ref_c, out, t0, t1, t2 = frame()
    launches = GA.LAUNCHES
    by_dtype = dict(GA.LAUNCHES_BY_DTYPE)
    expected = expected_fast_launches(out, n_rays, n_probe)
    for k in ("pixel_colors_nr", "pixel_colors_nr_fine"):
        if out[k].shape != (1, n_rays, 3) or not np.isfinite(out[k]).all():
            raise RuntimeError(f"fast profile {k}: shape {out[k].shape} or "
                               "not finite")
    img = out["pixel_colors_nr_fine"][0].reshape(H, W, 3)
    frame_psnr = psnr(img, gt)
    log(f"fast profile frame: {n_rays} rays, encode {t1 - t0:.3f} s, "
        f"probe + audits + render {t2 - t1:.3f} s = "
        f"{n_rays / (t2 - t1):.1f} rays/s ({n_rays / (t2 - t0):.1f} rays/s "
        f"with the encode), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, gather "
        f"launches {launches} (expected {expected})")
    log(f"fast profile audit: kept {out['kept_rays'] / n_rays:.4f} of the "
        f"rays, probe_sample_num {out['probe_sample_num']}, false_skip_rate "
        f"{out['false_skip_rate']:.5f}, window_clip_db "
        f"{out.get('window_clip_db')}, fallback {out['fallback']}, "
        f"audit_trail {json.dumps(out['audit_trail'])}")
    log(f"fast profile quality: GT-PSNR fine {frame_psnr:.3f} dB, "
        f"PSNR against the full frame {psnr(img, full_img):.3f} dB")
    if launches != expected:
        raise RuntimeError(f"gather kernel launched {launches} times in the "
                           f"fast profile frame, expected {expected}")
    if not frame_psnr >= PSNR_FLOOR:
        raise RuntimeError(f"fast profile GT-PSNR {frame_psnr:.3f} dB < "
                           f"{PSNR_FLOOR}")

    keep = np.nonzero(out["keep_mask"])[0]
    start = max(0, (keep.size - N_CHECK) // 2)
    probe = R._with_probe_sample_num(fast, out["probe_sample_num"])
    _, near, far = R._strided_focus_probe(
        probe, ref_c, que, FAST_ARGS["threshold"], (H, W), stride)
    in_situ(R, fast, ref_c, que, keep[start:start + N_CHECK], (near, far))
    return by_dtype


def expected_focus_launches(kept_rays, n_probe):
    """Gather launches of ``render_frame_probe_focus``'s passes, implied by
    its chunk counts: 2 (rgb, then the 64-ch map) per chunk of the probe
    over n_probe rays and of each of the two focused passes over the kept
    rays."""
    def chunks(n):
        return -(-n // CHUNK)

    return 2 * (chunks(n_probe) + 2 * chunks(kept_rays))


def bench_profile(R, GA, renderer, ref, que, gt):
    """Phase 7. Returns the gather launches of its counted frames, by
    instantiation."""
    n_rays = que["coords"].shape[1]
    stride = BENCH_ARGS["probe_stride"]
    n_probe = -(-H // stride) * -(-W // stride)

    def build(**over):
        r = R.NeurayRenderer(R.RenderConfig(**{**BENCH_PROFILE, **over}))
        r.load_state_dict(renderer.state_dict())
        return r.to(ref["imgs"].device).eval()

    def frame(r):
        """Encode + render_frame_probe_focus, its launches counted and
        checked against the chunk counts: the encode's half-grid diff
        gather is f32, the passes gather from the route's maps."""
        GA.reset_launches()
        t0 = time.perf_counter()
        ref_c = R.encode_ref(r, ref)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = R.render_frame_probe_focus(r, ref_c, que, image_hw=(H, W),
                                         **BENCH_ARGS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = dict(GA.LAUNCHES_BY_DTYPE)
        c = r.cfg
        route = ("f32" if not c.use_bf16 else
                 "u8" if c.gather_quant == "u8" else "bf16")
        expected = {"f32": 1, "bf16": 0, "u8": 0}
        expected[route] += expected_focus_launches(out["kept_rays"], n_probe)
        for k in ("pixel_colors_nr", "pixel_colors_nr_fine"):
            if out[k].shape != (1, n_rays, 3) or not np.isfinite(out[k]).all():
                raise RuntimeError(f"bench profile ({route}) {k}: shape "
                                   f"{out[k].shape} or not finite")
        if launches != expected:
            raise RuntimeError(f"bench profile ({route}): gather launches "
                               f"{launches}, expected {expected}")
        img = out["pixel_colors_nr_fine"][0].reshape(H, W, 3)
        return {"ref_c": ref_c, "out": out, "img": img, "launches": launches,
                "encode": t1 - t0, "render": t2 - t1}

    bench = build()
    t0 = time.perf_counter()
    frame(bench)
    log(f"bench profile warm-up frame: {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    u8 = frame(bench)
    bf16 = frame(build(gather_quant="none"))
    f32 = frame(build(use_bf16=False, gather_quant="none"))
    kept = u8["out"]["kept_rays"]
    total = u8["encode"] + u8["render"]
    log(f"bench profile frame (bf16 + u8): {n_rays} rays, encode "
        f"{u8['encode']:.3f} s, probe + render {u8['render']:.3f} s = "
        f"{n_rays / u8['render']:.1f} rays/s ({n_rays / total:.1f} rays/s "
        f"with the encode), kept {kept / n_rays:.4f} of the rays, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"gather launches {u8['launches']}")
    for name, f in (("bf16 map", bf16), ("f32", f32)):
        log(f"bench profile frame ({name}): encode {f['encode']:.3f} s, probe "
            f"+ render {f['render']:.3f} s = {n_rays / f['render']:.1f} "
            f"rays/s, kept {f['out']['kept_rays'] / n_rays:.4f}, gather "
            f"launches {f['launches']}")
    gt_psnr = {k: psnr(f["img"], gt) for k, f in
               (("bf16 + u8", u8), ("bf16", bf16), ("f32", f32))}
    vs_f32 = {k: psnr(f["img"], f32["img"]) for k, f in
              (("bf16 + u8", u8), ("bf16", bf16))}
    flips = {k: int((f["out"]["keep_mask"] != f32["out"]["keep_mask"]).sum())
             for k, f in (("bf16 + u8", u8), ("bf16", bf16))}
    log("bench profile quality: GT-PSNR fine " + ", ".join(
        f"{k} {v:.3f} dB" for k, v in gt_psnr.items()) + "; against the f32 "
        "frame " + ", ".join(f"{k} {v:.3f} dB" for k, v in vs_f32.items())
        + f"; rays whose keep decision differs from f32 {flips}")
    if not gt_psnr["bf16 + u8"] >= PSNR_FLOOR:
        raise RuntimeError(f"bench profile GT-PSNR {gt_psnr['bf16 + u8']:.3f}"
                           f" dB < {PSNR_FLOOR}")
    if not all(v >= BF16_PSNR_FLOOR for v in vs_f32.values()):
        raise RuntimeError(f"bench profile against f32 {vs_f32} < "
                           f"{BF16_PSNR_FLOOR} dB")

    keep = np.nonzero(u8["out"]["keep_mask"])[0]
    start = max(0, (keep.size - N_CHECK) // 2)
    _, near, far = R._strided_focus_probe(
        bench, u8["ref_c"], que, BENCH_ARGS["threshold"], (H, W), stride)
    in_situ(R, bench, u8["ref_c"], que, keep[start:start + N_CHECK],
            (near, far), BF16_PASS_BOUND)
    return [f["launches"] for f in (u8, bf16, f32)]


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from neuray_tpu_torch.data.synthetic import make_query, make_sphere_scene
    from neuray_tpu_torch.models import renderer as R
    from neuray_tpu_torch.ops import gather as GA
    from neuray_tpu_torch.utils.params import (
        load_flax_params, load_params_npz)

    # cuDNN's f32 convs default to TF32 (~1e-3 error); keep full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    GA.load_library()
    log(f"build: gather_bilinear_border.cu in "
        f"{time.perf_counter() - t0:.2f} s")

    _, kernel_stats = check_kernel(GA, dev)

    # ---- full frame ----
    rng = np.random.RandomState(0)
    ref_np = make_sphere_scene(rng, RFN, H, W)
    que_np = make_query(rng, H, W, 0, full_image=True)
    gt = que_np.pop("imgs")[0]
    ref = {k: torch.from_numpy(v).to(dev) for k, v in ref_np.items()}
    que = {k: torch.from_numpy(v).to(dev) for k, v in que_np.items()}
    cfg = R.RenderConfig(
        use_hierarchical_sampling=True, depth_sample_num=DN,
        fine_depth_sample_num=DN, ray_batch_num=CHUNK, use_vis=False,
        fine_use_vis=False, init_diff_scale=1, use_bf16=False,
        gather_quant="none")
    renderer = R.NeurayRenderer(cfg)
    load_flax_params(renderer, load_params_npz(
        str(Path(__file__).resolve().parent / "tools" / "bench_weights.npz")))
    renderer = renderer.to(dev).eval()
    n_rays = que["coords"].shape[1]
    n_chunks = -(-n_rays // CHUNK)

    t0 = time.perf_counter()
    R.render_full(renderer, ref, que)
    torch.cuda.synchronize()
    log(f"warm-up frame: {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    GA.reset_launches()
    t0 = time.perf_counter()
    ref_c = R.encode_ref(renderer, ref)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = R.render_rays(renderer, ref_c, que)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = GA.LAUNCHES
    counted = [dict(GA.LAUNCHES_BY_DTYPE)]
    expected = 2 * 2 * n_chunks + 1
    if launches != expected:
        raise RuntimeError(f"gather kernel launched {launches} times in "
                           f"the frame, expected {expected}")
    for k, v in out.items():
        if v.shape[:2] != (1, n_rays):
            raise RuntimeError(f"{k} has shape {tuple(v.shape)}")
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise RuntimeError(f"{k} is not finite")
    img = out["pixel_colors_nr_fine"][0].reshape(H, W, 3).cpu().numpy()
    frame_psnr = psnr(img, gt)
    coarse_psnr = psnr(
        out["pixel_colors_nr"][0].reshape(H, W, 3).cpu().numpy(), gt)
    log(f"frame: {n_rays} rays, encode {t1 - t0:.3f} s, ray loop "
        f"{t2 - t1:.3f} s = {n_rays / (t2 - t1):.1f} rays/s "
        f"({n_rays / (t2 - t0):.1f} rays/s with the encode), "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"gather launches {launches}")
    log(f"quality: GT-PSNR fine {frame_psnr:.3f} dB, coarse "
        f"{coarse_psnr:.3f} dB")
    if not frame_psnr >= PSNR_FLOOR:
        raise RuntimeError(f"GT-PSNR {frame_psnr:.3f} dB < {PSNR_FLOOR}")

    in_situ(R, renderer, ref_c, que,
            np.arange(N_CHECK) + (n_rays - N_CHECK) // 2)

    counted.append(fast_profile(R, GA, renderer, ref, que, gt, img))
    counted += bench_profile(R, GA, renderer, ref, que, gt)

    log(json.dumps({"kernels": [{
        "name": f"gather_bilinear_border_{k}", "route": "cuda",
        "source": "neuray_tpu_torch/csrc/gather_bilinear_border.cu",
        "replaces": "neuray_tpu/ops/pallas/gather.py:85",
        "launches": sum(c[k] for c in counted),
        **kernel_stats[k]} for k in ("f32", "bf16", "u8")]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
