"""Does any threshold on the cheap probe score separate the rays the
network's coarse pass keeps from the rays it skips? (port of
``tools/diag_probe_score.py``)

    python -m neuray_tpu_torch.diag_probe_score [--size 800] [--chunk 1024]
        [--probe-samples 16] [--net-threshold 0.01] [--weights FILE]
        [--device cpu]

Encodes 8 sphere views, then scores every ray of the full-image query
view twice: the probe (``models/renderer.py: probe_rays``, the
dist-decoder score at ``--probe-samples`` samples) and the network
(``render_coarse_rays`` keeping ``hit_prob_nr``, summed over depth). A
ray is kept by the network where its hit mass exceeds
``--net-threshold``. It prints one JSON record, indented as the JAX
tool's, with its keys: ``net_kept_fraction``, the quantiles of the probe
score on the kept and on the skipped rays (``probe_score_kept_quantiles``,
``probe_score_skipped_quantiles``), ``pearson_r`` of the two scores,
and, for each recall target r (the share of network-kept rays the probe
keeps), ``recall_<r>``: the ``probe_threshold`` and the
``overall_keep_fraction`` of all rays above it.

On the card (the default) the frame is ``--size`` square at 64 + 64
samples in ``--chunk``-ray chunks on the bench route, bf16 with the u8
gather map, every gather through the hand-written kernel, with
``tools/bench_weights.npz``; ``--device cpu`` gives the JAX tool's CPU
shapes (64 px, 16 + 16 samples, 64-ray chunks, f32) and flax's
initializers under seed 0.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.utils.device import full_f32, resolve_device
from neuray_tpu_torch.utils.tool_setup import (
    BENCH_WEIGHTS, build_renderer, device_name, sphere_scene)

QUANTILES = (0, 0.001, 0.01, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0)
RECALLS = (1.0, 0.9999, 0.999, 0.99)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--probe-samples", type=int, default=16)
    ap.add_argument("--net-threshold", type=float, default=0.01)
    ap.add_argument("--weights", default=BENCH_WEIGHTS)
    ap.add_argument("--device", default=None,
                    help="cpu: the JAX tool's CPU shapes (default: CUDA)")
    return ap.parse_args(argv)


def config(flags, device: torch.device) -> R.RenderConfig:
    on_card = device.type == "cuda"
    dn = 64 if on_card else 16
    return R.RenderConfig(
        use_hierarchical_sampling=True, depth_sample_num=dn,
        fine_depth_sample_num=dn,
        ray_batch_num=flags.chunk if on_card else 64,
        probe_sample_num=flags.probe_samples, use_vis=False,
        fine_use_vis=False, use_bf16=on_card,
        gather_quant="u8" if on_card else "none")


def scores(renderer, ref_c, que):
    """(probe score, the coarse pass's hit mass), each [rn] f32 numpy."""
    probe = R._host(R.probe_rays(renderer, ref_c, que))[0]
    hit = R.render_coarse_rays(renderer, ref_c, que, ("hit_prob_nr",))
    return probe, R._host(hit["hit_prob_nr"].sum(-1))[0]


def record(probe: np.ndarray, net: np.ndarray, net_threshold: float):
    """The JAX tool's record of the two scores."""
    kept = net > net_threshold
    out = {
        "net_kept_fraction": round(float(kept.mean()), 4),
        "probe_score_kept_quantiles": {
            str(q): round(float(np.quantile(probe[kept], q)), 5)
            for q in QUANTILES},
        "probe_score_skipped_quantiles": {
            str(q): round(float(np.quantile(probe[~kept], q)), 5)
            for q in QUANTILES},
        "pearson_r": round(float(np.corrcoef(probe, net)[0, 1]), 4),
    }
    for recall in RECALLS:
        th = float(np.quantile(probe[kept], 1.0 - recall))
        out[f"recall_{recall}"] = {
            "probe_threshold": round(th, 5),
            "overall_keep_fraction": round(float((probe >= th).mean()), 4)}
    return out


def run(flags, device: torch.device, params=None):
    """(record, extras): extras holds the renderer, the encode ``ref_c``,
    the query ``que`` and both scores (``probe``, ``net``)."""
    h = w = flags.size if device.type == "cuda" else 64
    renderer = build_renderer(config(flags, device), device, params,
                              flags.weights)
    ref, que = sphere_scene(8, h, w, device)
    ref_c = R.encode_ref(renderer, ref)
    probe, net = scores(renderer, ref_c, que)
    return record(probe, net, flags.net_threshold), dict(
        renderer=renderer, ref_c=ref_c, que=que, probe=probe, net=net)


def main(argv=None):
    flags = parse_args(argv)
    full_f32()
    device = resolve_device(flags.device)
    print("device:", device_name(device), flush=True)
    out, _ = run(flags, device)
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
