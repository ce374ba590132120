"""Per-stage time of the scene encode (port of ``tools/profile_encode.py``):

    python -m neuray_tpu_torch.profile_encode [--size 800] [--rfn 8]
        [--iters 3] [--weights FILE] [--device cpu]

splits the encode of ``--rfn`` sphere views into its stages, each timed
on its own:

  init_net            ``NeurayRenderer.initialize_ray_feats``: DepthInitNet,
                      depth maps -> raw visibility features G' (its
                      cross-view diff gather through the hand-written
                      kernel on the card)
  image+vis_encoder   ``NeurayRenderer.encode_scene``: ResUNetLight on the
                      views -> image features, the vis encoder -> G
  gather_cache        ``NeurayRenderer.build_gather_cache``: the gather map
                      (on the card the u8 quantization)

and ``fused_encode``, the whole encode as the renderer runs it
(``models/renderer.py: encode_ref``). Each stage runs once to warm up and
``--iters`` times; its best host seconds (a synchronize ends each stage)
are ``<stage>_s`` as in the JAX tool, and the CUDA-event span of that
call ``<stage>_device_ms`` (``utils/profiling.py: StageTimer``). The
stages run one after another with nothing to overlap, so their sum is
close to the fused encode (the JAX tool's stages are separate XLA
programs, which its fused program fuses across).

On the card (the default): ``--size`` square views at the bench route
(bf16, the u8 gather map) with ``tools/bench_weights.npz``; ``--device
cpu``: the JAX tool's CPU shapes (at most 64 px, f32) and flax's
initializers under seed 0. The last line is one JSON record with the
JAX tool's keys (``platform`` the torch device type) and the device
times.
"""
from __future__ import annotations

import argparse
import json

import torch

from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.utils.device import full_f32, resolve_device
from neuray_tpu_torch.utils.profiling import StageTimer
from neuray_tpu_torch.utils.tool_setup import (
    BENCH_WEIGHTS, build_renderer, device_name, sphere_scene)

STAGES = ("init_net", "image+vis_encoder", "gather_cache", "fused_encode")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--rfn", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--weights", default=BENCH_WEIGHTS)
    ap.add_argument("--device", default=None,
                    help="cpu: the JAX tool's CPU shapes (default: CUDA)")
    flags = ap.parse_args(argv)
    if flags.iters < 1:
        ap.error("--iters must be at least 1")
    return flags


def config(device: torch.device) -> R.RenderConfig:
    on_card = device.type == "cuda"
    dn = 64 if on_card else 8
    return R.RenderConfig(
        use_hierarchical_sampling=True, depth_sample_num=dn,
        fine_depth_sample_num=dn, use_vis=False, fine_use_vis=False,
        use_bf16=on_card, gather_quant="u8" if on_card else "none")


@torch.inference_mode()
def encode_stages(renderer, ref, timer: StageTimer, sync):
    """One encode stage by stage, then the fused encode, each a stage of
    ``timer``. Returns {stage: its output}: init_net's G', the encoders'
    (img_feats, ray_feats), the gather cache's ref dict, encode_ref's."""
    cfg = renderer.cfg
    out = {}
    with timer.stage("init_net", sync):
        out["init_net"] = renderer.initialize_ray_feats(ref)
    with timer.stage("image+vis_encoder", sync):
        out["image+vis_encoder"] = renderer.encode_scene(ref,
                                                         out["init_net"])
    img_feats, ray_feats = out["image+vis_encoder"]
    with timer.stage("gather_cache", sync):
        out["gather_cache"] = renderer.build_gather_cache(
            dict(ref, img_feats=img_feats, ray_feats=ray_feats),
            cfg.use_bf16, cfg.gather_quant)
    with timer.stage("fused_encode", sync):
        out["fused_encode"] = R.encode_ref(renderer, ref)
    return out


def run(flags, device: torch.device, params=None):
    """(record, the stages' outputs of the last call)."""
    h = w = flags.size if device.type == "cuda" else min(flags.size, 64)
    renderer = build_renderer(config(device), device, params, flags.weights)
    ref, _ = sphere_scene(flags.rfn, h, w, device, query=False)
    best = {}
    for i in range(1 + flags.iters):
        timer = StageTimer()
        outputs = encode_stages(renderer, ref, timer, device)
        if i == 0:      # the warm-up
            continue
        s = timer.summary()
        for k in STAGES:
            if k not in best or s[k] < best[k][0]:
                best[k] = (s[k], s.get(f"{k}_device_ms"))
    rec = {"shape": f"{flags.rfn}x{h}x{w}", "platform": device.type,
           "device": device_name(device)}
    for k in STAGES:
        rec[f"{k}_s"] = round(best[k][0], 3)
    rec["sum_of_stages_s"] = round(sum(best[k][0] for k in STAGES[:3]), 3)
    for k in STAGES:
        if best[k][1] is not None:
            rec[f"{k}_device_ms"] = round(best[k][1], 3)
    return rec, outputs


def main(argv=None):
    flags = parse_args(argv)
    full_f32()
    device = resolve_device(flags.device)
    rec, _ = run(flags, device)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
