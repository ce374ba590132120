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
     ``tools/bench_weights.npz``: a warm-up of ``WARMUP_CHUNKS`` chunks
     (every kernel of the frame) and of the frame's output allocations,
     then a timed frame whose kernel
     launches are counted; outputs finite, PSNR against the ground-truth
     image >= 24 dB;
  5. 1024 rays (one chunk) through the image centre again from the same encoded
     maps, on the card (kernel) and on the CPU (plain PyTorch): each pass
     agrees to 1e-4 on the same inputs (``in_situ``);
  6. the shipped fast eval profile (``configs/gen/neuray_gen_depth_fast
     .yaml``: half-grid init diff, self-auditing probe-focused render,
     probe every 2nd pixel) on the same scene, weights and query:
     warm-up frame, then a timed frame (encode + ``render_frame_probe_auto``)
     whose gather launches must equal what its chunk counts imply;
     GT-PSNR >= 24 dB; then 1024 kept rays through the image centre,
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
     decision differs. Then 1024 kept rays through the image centre, card
     against CPU inside the probe's windows, each pass's colours within
     ``BF16_PASS_BOUND`` = 0.05 on the same inputs: two bf16
     implementations of a pass round differently, and the CPU test
     ``tests/test_torch_port_bf16.py::test_passes_on_the_same_inputs``
     measures the port against the JAX package at 0.012-0.039 per pass
     and holds it to this bound.
  8. generalization training (``train_phase``): the fields of
     ``configs/train/gen/neuray_gen_depth_train.yaml`` (``TRAIN_PROFILE``)
     through ``Trainer(cfg).run()`` on the card, from the trainer's own
     init, at the gen dataset's training shapes (``TRAIN_CUTS``), every
     gather's backward through the hand-written kernel; then one step's
     gradients on the card against the CPU's.
  9. per-scene finetuning (``ft_phase``): the fields of
     ``configs/train/ft/neuray_ft_depth_lego.yaml`` (``FT_PROFILE``, its
     gen model ``GEN_PROFILE`` with the trained weights as checkpoint)
     through ``FtTrainer(cfg).run()`` on a NeRF-synthetic sphere
     fabricated at 800x800 (``FT_CUTS``): ray_feats [100, 200, 200, 32]
     from the gen init net, 33 steps of 512 rays with the self-hit
     consistency path, every gather and its backward through the kernels,
     a validation over the 6 val views; then one step's gradients,
     ray_feats included, on the card against the CPU's.
 10. the cost-volume frame (``cv_phase``, ``tools/bench_cost_volume.py``'s
     shape): ``configs/gen/neuray_gen_cost_volume.yaml`` (``CV_PROFILE``)
     with ``tools/bench_weights_cv.npz`` at full width (MVSNet over 64
     planes, ResUNetLight(2,3,6,3)/32), 8 reference views of the sphere
     at 1024x768 that are also the source views (nn 3), a 1008x756 query,
     64 + 64 samples: the exact f32 frame through ``encode_ref(..., src)``
     and ``render_rays`` (encode, MVSNet's share, homo_warp beside its
     bytes bound, rays/s, peak memory, gather launches held, GT-PSNR
     within 0.05 dB of the JAX package's on every 8th pixel and row (the
     weights, trained at 384 px, fall short of 24 dB here), the centre
     chunk's real-coordinate gathers timed, card vs CPU
     per pass 1e-4), then the bench default on it (bf16 + u8, focus
     12:24) beside the same profile in f32: GT-PSNR no more than 0.5 dB
     below the f32 frame's (the weights' flat cost volume puts the two
     29 dB apart).
 11. finetuning from the cost-volume model (phase 9 with
     ``configs/train/ft/neuray_ft_cv_lego.yaml``, ``FT_CV_PROFILE``, its
     gen model ``GEN_CV_PROFILE`` with ``tools/bench_weights_cv.npz``):
     ray_feats from MVSNet on each of the 100 views with its 3 nearest
     views at 640x640, then the same steps, checks, validation and
     gradient check as phase 9.
 12. generalization training through the port's CLI on the dataset
     mixture (``gen_cli_phase``): one scene of each of the five training
     families fabricated on disk at its reader's size (``GEN_CLI_DATA``),
     fern (20 JPEG originals at 4032x3024 and a COLMAP model) and lego
     for validation; the host's time to make a sample of each family;
     ``python -m neuray_tpu_torch.run_training`` (``main``) on a copy of
     ``configs/train/gen/neuray_gen_depth_train.yaml`` cut to 40 steps
     (``GEN_CLI_CUTS``, its val sets to one view each), every step's
     gather launches held, the validation's psnr_nr_fine on fern and lego
     and its vis_img files held to the renders through the codec (the gt
     panel >= 35 dB, the whole >= 30 dB), fern's cache
     build and JPEG reads timed, a profiled step, one step's gradients on
     each of three real-estate crops (``GRAD_SAMPLE_CLOCKS``) on the card
     against the CPU's, the ResUNet encoders' against an f64 witness
     (``grad_check``; taken on the card, held to the CPU's on one crop by
     ``witness_device_check``), and the forward and
     backward kernels timed on the real coordinates of the GSO map and
     the 400x600 crop's map (``real_coord_rows``);
 13. cost-volume generalization training the same way
     (``configs/train/gen/neuray_gen_cost_volume_train.yaml``, 15 steps,
     validating on fern): steps/s and the cost-volume init net's share of
     a step.
 14. the render and eval CLIs (``cli_phase``) on phase 9's scene with the
     trained weights as the gen checkpoint: ``python -m
     neuray_tpu_torch.render`` with ``configs/gen/neuray_gen_depth.yaml``
     on 1 eval view, with ``neuray_gen_depth_fast.yaml`` (auto_focus and
     its audit log) on 2, and ``--render_type ft`` on one pose from phase
     9's finetuned checkpoint; every frame's JPEGs equal to its driver
     called directly, its gather launches held to its chunk counts, one
     encode a ref set, s a frame, encode s and JPEG write ms; a rerun
     resumes and rewrites the audit log; ``python -m neuray_tpu_torch.eval``
     on the frames (its PSNR that of the files, GT-PSNR >= 18 dB, the FT
     frame's >= 24 dB, eval s);
     then ``neuray_tpu_torch/selfcheck.py``'s render and FT self-checks;
     and the first exact frame by ``python -m neuray_tpu_torch.render``
     in a fresh process (run beside phase 20), where PyTorch's default
     TF32 flags hold until the CLI's ``main`` turns them off: its JPEGs
     equal this process's byte for byte, both processes' flags printed
     (``cli_fresh_process``).
 15. the shipped configs no earlier phase runs: (a) ``configs/train/gen/
     neuray_gen_depth_train_fast.yaml`` (the diff on the half grid)
     through the CLI on phase 12's data, cut as phase 12 at 20 steps
     (``fast_cli_phase``): every step's gathers held and its diff gather
     on its half grid, steps/s beside phase 12's, the half-grid diff
     gather of a 400x608 crop timed; (b) finetuning by the shipped birds,
     fern and desktop configs (``ft_db_phase``, ``FT_DB_SCENES``), each
     on a scene written at its reader's real size (LLFF 1008x756 padded
     to 1008x768; DTU test 800x600 padded to 800x608; the example layout
     at 1280x720), 3 + 6 steps held as phase 9's, steps/s beside phase
     9's, the validations (the configs' initial one on birds, one at the
     end, on the first val view) printed, the padded maps' gathers timed
     forward and backward on their real coordinates, and on birds one
     step's gradients card vs CPU (``ft_grad_compare``).
 16. the reference's checkpoints (``ref_ckpt_phase``): ``model_best.pth``
     files written from both ``.npz`` weights under the reference's keys,
     converted by ``python -m neuray_tpu_torch.convert_reference_ckpt``,
     held leaf for leaf to ``load_flax_params``; phase 14's first exact
     view rendered by the CLI from the converted depth checkpoint, its
     JPEGs equal phase 14's byte for byte.
 17. direct rendering (``dr_phase``): phase 4's exact frame with
     ``use_dr_prediction``: ``pixel_colors_nr_fine`` bit-equal to phase
     4's, the DR colours' GT-PSNR, rays/s beside phase 4's, card vs CPU
     on 1024 centre rays; one render CLI frame whose ``-dr.jpg`` equals
     its driver's; one training step with the DR losses card vs CPU.
 18. multi-GPU (``multi_gpu_phase``): 2 spawned ranks (on one card they
     share it over gloo; one a card over nccl where there are two), the
     kernel built before they start: (a) phase 4's exact frame through
     ``make_sharded_render_fn``, within 1e-5 of phase 4's (byte-equality
     printed); (b) the bench default with ``mesh``, phase 7's keep set;
     (c) data-parallel steps of phase 12's config on its data and (d)
     ray-sharded steps of phase 9's on its scene, the first step's
     averaged gradients within 1e-5 of each leaf's norm of the
     one-process step on the same inputs, the parameters the same on
     every rank; (e), beside phase 20, the render CLI under torchrun, its
     JPEGs equal to phase 14's, and the training CLI under torchrun beside
     the one-process CLI on the same finetuning config and at lr 0: step 1's
     logged losses equal, each later step's within
     ``MG_CLI_UPDATE_SHARE`` of the update's effect. Each rank's gather
     launches, times and peak memory printed beside how the ranks sit on
     the cards.
 19. the analytic scenes (``scenes_phase``): (a) the blobs with
     ``tools/bench_weights_blobs.npz`` at 800x800, 8 views, 64 + 64
     samples: the exact f32 frame (rays/s, launches held, GT-PSNR on every
     8th pixel and row within 0.05 dB of the JAX package's), then
     ``render_frame_probe_auto`` on the bench route (bf16 + u8, probe from
     8, threshold 0.01, dilate 1, stride 2, tol 0.02, 0.05 dB): accepted
     probe, false-skip rate, clip, kept fraction, rays/s, launches held by
     instantiation, GT-PSNR no more than 0.5 dB below the exact frame's;
     (b) the room with ``bench_weights_room_strong.npz``: the exact frame
     held the same way, the auto frame must reject the windows and fall
     back to the two-phase render, bit-equal to ``render_frame_skip_empty``
     on the same route, and the two-phase frame on the bf16 and on the
     bf16 + u8 route >= 30 dB against the exact f32 frame; (c) the pan
     trajectory (``python -m neuray_tpu_torch.check_trajectory_escalation``
     at its defaults, 400x400, 7 frames): no larger probe accepted before
     the rods enter the frustum, an escalation or fallback at or after
     it; (d), beside phase 20, the main of ``python -m
     neuray_tpu_torch.make_bench_weights --scene blobs`` in a fresh
     process, 40 steps at 400 px: steps/s (on a card shared with phase
     20 and phase 18(e)'s CLIs), the
     loss, 5 forward and 2 backward gather launches a step, its npz read
     back in that process rendering a chunk equal to the trained model's,
     one step's gradients card vs CPU; then the room frame's and a pan
     frame's real-coordinate gathers timed as forward rows.
 20. the diagnostic and profiling tools (``tools_phase``) at their card
     defaults on the bench route but for depth (``TOOLS``), in
     process, each tool's gather launches held to its chunk counts:
     ``diag_probe_score``'s scores bit-equal to ``probe_rays`` and
     ``render_coarse_rays`` on its encode; ``profile_encode``'s staged
     maps bit-equal to ``encode_ref``'s, then the tool in a fresh process;
     ``profile_skip_phases``' two-phase keep set equal to
     ``render_frame_skip_empty``'s and its ``--focus`` frame bit-equal to
     ``render_frame_probe_focus``'s; ``profile_stages``' first chunk of each
     stage card vs CPU (its gathers by ``hold`` against their plain
     versions, its bf16 modules by the lossy-mode rule, the rest 1e-4).
Phase 3 also holds the gather's backward kernel (the scatter-add into an
f32 map) to its plain twin at both training steps' shapes
(``BACKWARD_SHAPES``), beside ``grid_sampler_2d_backward``, and its
edge cases on maps whose sides end in partial 8x8 tiles (``EDGE_SHAPES``).
The line before the last is a JSON record of the kernel's instantiations
(time, bound and grid_sample's time at each one's 64-channel per-chunk
gather, ``KEY_ROWS``; the backward at generalization training's
64-channel gather);
the launches are those of every phase's main path, each phase's counts
set to 0 before it and read after; the line before the device's is the
whole run's seconds; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits non-zero before printing anything.

    python3 chip_smoke.py --grad-sweep N --out FILE

runs phase 12's gradient check alone on the real-estate crops of N clocks,
with the ResUNet encoders' f64 witness and, at the worst clock and any
outside the bar, a layer-by-layer trace of where f32 strays from it
(``grad_sweep``, ``encoder_trace``); the tables go to FILE.
"""
import copy
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

H = W = 800
RFN = 8
CHUNK = 1024
# phase 4's warm-up: enough chunks to run every kernel of the frame once
# (a whole frame took 10-13 s of the run; phase 18 needs the time)
WARMUP_CHUNKS = 8
DN = 64
# the card-vs-CPU checks' rays: one CHUNK, the main path's chunk, through
# the image centre (the CPU's plain passes over it are most of phases 4-7's
# check time)
N_CHECK = CHUNK
PSNR_FLOOR = 24.0
# configs/gen/neuray_gen_depth.yaml as RenderConfig fields, in CHUNK-ray
# chunks (tests/test_torch_port_render.py holds this to the parsed file)
EXACT_PROFILE = dict(
    use_hierarchical_sampling=True, use_depth_loss=True, use_vis=False,
    fine_use_vis=False, ray_batch_num=CHUNK)
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
# configs/train/gen/neuray_gen_depth_train.yaml, every field but those
# TRAIN_CUTS replaces (tests/test_torch_port_train.py holds this to the
# parsed file): depth init, 64 + 64 samples, no vis, render + depth loss
# with the fine render loss, Adam with exp decay from 4e-4
TRAIN_PROFILE = dict(
    network="neuray_gen", init_net_type="depth",
    use_hierarchical_sampling=True, use_depth_loss=True,
    dist_decoder_cfg={"use_vis": False},
    fine_dist_decoder_cfg={"use_vis": False}, ray_batch_num=2048,
    loss=["render", "depth"], key_metric_name="psnr_nr_fine",
    use_dr_loss=False, use_dr_fine_loss=False, use_nr_fine_loss=True,
    lr_type="exp_decay",
    lr_cfg={"lr_init": 0.0004, "decay_step": 100000, "decay_rate": 0.5})
# phase 8's shapes: the gen dataset's training sample (8 reference views,
# the 400x600 crop padded to 400x608, 512 query rays, 8192 depth-loss
# pixels a view); steps, and the gradient check's reduced size
TRAIN_RFN, TRAIN_H, TRAIN_W = 8, 400, 608
TRAIN_RAYS, TRAIN_DEPTH_COORDS = 512, 8192
WARMUP_STEPS, TIMED_STEPS = 3, 30
GRAD_CHECK_DATA = {"rfn": 4, "h": 64, "w": 96, "train_ray_num": 256,
                   "depth_loss_coords_num": TRAIN_DEPTH_COORDS}
GRAD_BOUND, GRAD_FLOOR = 2e-3, 1e-5
# the renderer's ResUNets, whose leaves phase 12 holds to an f64 witness
WITNESSED = ("image_encoder", "init_net.res_net")
# compare_grads's columns for a leaf of theirs under the f64 witness;
# the held ones: "card vs its masks' f64" and "f64 vs f64"
WITNESS_COLUMNS = ("card vs CPU", "card vs its masks' f64",
                   "CPU vs its masks' f64", "card vs f64", "CPU vs f64",
                   "f64 vs f64")
# what phase 8 changes in the training config: synthetic sphere scenes in
# place of the 5-dataset mixture (no augmentation), psnr_ssim without the
# vis_img dumps, a one-view synthetic val set, and the run's length
TRAIN_CUTS = dict(
    name="chip_smoke_train", total_step=WARMUP_STEPS + TIMED_STEPS,
    val_interval=WARMUP_STEPS + TIMED_STEPS, save_interval=10 ** 6,
    train_log_step=10, val_metric=["psnr_ssim"], worker_num=6,
    train_dataset_type="synthetic",
    train_dataset_cfg={"rfn": TRAIN_RFN, "h": TRAIN_H, "w": TRAIN_W,
                       "train_ray_num": TRAIN_RAYS,
                       "depth_loss_coords_num": TRAIN_DEPTH_COORDS},
    val_set_list=[{"name": "sphere", "type": "synthetic",
                   "cfg": {"rfn": TRAIN_RFN, "h": TRAIN_H, "w": TRAIN_W,
                           "num": 1}}])

# phase 9: configs/train/ft/neuray_ft_depth_lego.yaml, every field but those
# FT_CUTS replaces, its gen_cfg the parsed configs/gen/neuray_gen_depth.yaml
# (GEN_PROFILE; the card's machine has no yaml; tests/
# test_torch_port_ft_trainer.py holds both to the parsed files): the gen
# model's weights and depth-init ray_feats, 512 rays a step from 8 of the
# 16 nearest views, 64 + 64 samples, no vis, render + consistency loss
# with the fine render loss, self-hit, Adam with exp decay from 1e-4
GEN_PROFILE = dict(
    name="neuray_gen_depth", network="neuray_gen", init_net_type="depth",
    use_hierarchical_sampling=True, use_depth_loss=True,
    dist_decoder_cfg={"use_vis": False}, ray_batch_num=8192,
    loss=["render", "depth"], val_metric=["psnr_ssim", "vis_img"],
    key_metric_name="psnr_nr_fine", use_dr_loss=False,
    use_dr_fine_loss=False, use_nr_fine_loss=True, total_step=400000,
    val_interval=10000, lr_type="exp_decay",
    lr_cfg={"lr_init": 0.0002, "decay_step": 100000, "decay_rate": 0.5},
    train_dataset_type="gen",
    train_dataset_cfg={"resolution_type": "hr", "type2sample_weights": {
        "gso": 80, "dtu_train": 20, "real_iconic": 10, "space": 20,
        "real_estate": 40}, "aug_pixel_center_sample": True},
    val_set_list=[
        {"name": "llff_fern", "type": "gen",
         "cfg": {"val_database_name": "llff_colmap/fern/high"}},
        {"name": "nerf_lego", "type": "gen",
         "cfg": {"val_database_name": "nerf_synthetic/lego/black_800"}}])
FT_PROFILE = dict(
    name="neuray_ft_depth_lego", network="neuray_ft",
    use_hierarchical_sampling=True, dist_decoder_cfg={"use_vis": False},
    gen_cfg=GEN_PROFILE, database_split="val_all", train_ray_num=512,
    use_self_hit_prob=True, loss=["render", "consist"],
    key_metric_name="psnr_nr_fine", use_nr_fine_loss=True,
    save_interval=5000,
    lr_cfg={"lr_init": 0.0001, "decay_step": 100000, "decay_rate": 0.5})
# what phase 9 changes in the finetuning config: the fabricated sphere
# (100 train views at 800x800 with analytic depth maps, the 6 val views)
# in place of lego, which is not in the repository; 3 + 30 steps; no
# validation of the initial state and one of the 6 val views at the end;
# psnr_ssim without the vis_img dumps
FT_STEPS = WARMUP_STEPS + TIMED_STEPS
FT_CUTS = dict(database_name="nerf_synthetic/sphere/black_800",
               total_step=FT_STEPS, val_interval=FT_STEPS,
               validate_initialization=False, val_metric=["psnr_ssim"],
               train_log_step=10)
FT_TRAIN_VIEWS = 100
# phase 14 renders the test views phase 9 writes beside its train views
CLI_TEST_VIEWS = 3
# the card-vs-CPU gradient check's reduced scene: 8 train views at 128x128,
# 256 query rays, all through the sphere (foreground_ratio 1)
FT_GRAD_SCENE = {"n_train": 8, "size": 128}
FT_GRAD_CHECK = dict(train_ray_num=256, foreground_ratio=1.0,
                     neighbor_view_num=4, init_view_num=4)

# phase 10: tools/bench_cost_volume.py's frame (BASELINE.md row 3): 8
# reference views of the sphere at 1024x768 (the cost-volume config's
# ref_pad_interval 32 pads fern's 1008x756 so), which are also the source
# views, each with its CV_NN nearest other views by camera centre as
# nn_ids; a 1008x756 query; 64 + 64 samples in CHUNK-ray chunks;
# tools/bench_weights_cv.npz. configs/gen/neuray_gen_cost_volume.yaml as
# RenderConfig fields (tests/test_torch_port_cv_ft.py holds this to the
# parsed file; the file's 2048-ray chunks are the only cut)
CV_H, CV_W = 768, 1024
CV_QH, CV_QW = 756, 1008
CV_NN = 3
CV_PROFILE = dict(
    init_net_type="cost_volume", use_hierarchical_sampling=True,
    use_depth_loss=True, use_vis=False, fine_use_vis=False,
    ray_batch_num=CHUNK)
# its bench-default route: bf16 + u8 and bench.py's probe and 12 + 24
# focus samples (BENCH_PROFILE's fields but the depth init's diff scale)
CV_BENCH_PROFILE = dict(
    CV_PROFILE, use_bf16=True, gather_quant="u8", probe_sample_num=16,
    focus_sample_num=12, focus_fine_sample_num=24)
# the GT-PSNR held in phase 10: the weights were trained at 384 px and
# fall short of PSNR_FLOOR at these sizes, so the card's fine image is held
# within CV_PSNR_TOL dB of the JAX package's on the rays of every
# CV_PSNR_STRIDE-th pixel and row (``cv_psnr_rays``): CV_JAX_GT_PSNR, from
# ``python tests/test_torch_port_cv_quality.py`` on the CPU
CV_PSNR_STRIDE = 8
CV_JAX_GT_PSNR = 21.8611
CV_PSNR_TOL = 0.05
# the bench route of phase 10 is held by GT-PSNR: its bf16 + u8 frame within
# CV_BF16_GT_TOL dB below the f32 frame of the same profile (a broken route,
# not rounding). The weights' MVSNet is at its initialization, and its flat
# cost volume makes the bf16 init net's output a function of rounding
# (tests/test_torch_port_cost_volume.py), so the two frames are 29.1 dB
# apart, under phase 7's BF16_PSNR_FLOOR, at equal GT-PSNR
CV_BF16_GT_TOL = 0.5
# the cost-volume encode's per-ref-view volume written by homo_warp: 32
# channels over 64 planes of the 1/4 map of MVSNet's eval size 768x576
CV_WARP_SHAPE = (32, 64, 144, 192)

# phase 11: configs/train/ft/neuray_ft_cv_lego.yaml, every field but those
# FT_CUTS replaces, its gen_cfg the parsed
# configs/gen/neuray_gen_cost_volume.yaml (GEN_CV_PROFILE; tests/
# test_torch_port_cv_ft.py holds both to the parsed files): phase 9's
# finetuning from the cost-volume gen model, whose init runs MVSNet on
# each of the 100 views with its 3 nearest views at 640x640. FtTrainer
# reads neither train_dataset_* nor val_set_list (its scene is its own).
GEN_CV_PROFILE = dict(
    name="neuray_gen_cost_volume", network="neuray_gen",
    init_net_type="cost_volume", use_hierarchical_sampling=True,
    use_depth_loss=True, dist_decoder_cfg={"use_vis": False},
    loss=["render", "depth"], val_metric=["psnr_ssim", "vis_img"],
    key_metric_name="psnr_nr_fine", use_dr_loss=False,
    use_dr_fine_loss=False, use_nr_fine_loss=True, depth_correct_ratio=1.0,
    total_step=400000, val_interval=10000, lr_type="exp_decay",
    lr_cfg={"lr_init": 0.0004, "decay_step": 100000, "decay_rate": 0.5},
    train_dataset_type="gen",
    train_dataset_cfg={
        "resolution_type": "hr", "type2sample_weights": {
            "gso": 80, "dtu_train": 20, "real_iconic": 10, "space": 20,
            "real_estate": 40},
        "train_database_types": ["dtu_train", "space", "real_iconic",
                                 "real_estate", "gso"],
        "aug_pixel_center_sample": True, "ref_pad_interval": 32,
        "use_src_imgs": True},
    val_set_list=[
        {"name": "llff_fern", "type": "gen",
         "cfg": {"val_database_name": "llff_colmap/fern/high",
                 "ref_pad_interval": 32, "use_src_imgs": True}},
        {"name": "nerf_lego", "type": "gen",
         "cfg": {"val_database_name": "nerf_synthetic/lego/black_800",
                 "use_src_imgs": True}}])
FT_CV_PROFILE = dict(
    FT_PROFILE, name="neuray_ft_cv_lego", gen_cfg=GEN_CV_PROFILE,
    train_dataset_type="ft",
    train_dataset_cfg={"database_name": "nerf_synthetic/lego/black_800",
                       "database_split": "val_all"},
    val_set_list=[{"name": "scene", "type": "ft", "cfg": {
        "database_name": "nerf_synthetic/lego/black_800",
        "database_split": "val_all"}}])


# phase 19: the analytic scenes of neuray_tpu_torch/data/synthetic.py and
# their trained weights under tools/. The blobs and the room frames are
# 800x800 from RFN views of RandomState(0), 64 + 64 samples; each exact f32
# frame's GT-PSNR on every SCENE_PSNR_STRIDE-th pixel and row is held
# within SCENE_PSNR_TOL dB of the JAX package's (SCENE_JAX_GT_PSNR, from
# ``python tests/test_torch_port_scene_quality.py`` on the CPU)
SCENE_WEIGHTS = {"blobs": "bench_weights_blobs.npz",
                 "room": "bench_weights_room_strong.npz"}
SCENE_PSNR_STRIDE = 8
SCENE_JAX_GT_PSNR = {"blobs": 32.9311, "room": 19.0344}
SCENE_PSNR_TOL = 0.05


def log(*args):
    print(*args, flush=True)


# the calls device_ms times with CUDA events where the profiler records
# no device rows
EVENT_ITERS = 50


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


def device_ms(fn, *args, n=10, tries=6):
    """Device time per call from ``torch.profiler``'s device rows: for
    each kernel (or memset) of a call, the mean duration of its rows over
    n calls, summed (at the per-chunk shapes a CUDA-event window measures
    the wrapper's host time, not the kernel). A window whose device rows
    come back empty (seen on the card on a 4 us kernel, three windows in
    a row once) or with a
    kernel short of one row a call (seen after the training phases: rows
    dropped) is profiled again, up to ``tries`` windows; the means stand
    for the rows that came. Where every window came back empty (seen once
    on the card, in phase 15b), the call is timed with CUDA events over
    ``EVENT_ITERS`` calls instead (an upper bound: the wrapper's host time
    where it exceeds the kernel's), its kernels a call not counted.
    Returns (ms, device events per call or None, {short kernel name: its
    ms per call})."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn(*args)
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        rows = {}
        for e in events:
            name = e.name.removeprefix("void ").replace(
                "(anonymous namespace)::", "").split("(")[0][:60]
            rows.setdefault(name, []).append(e.time_range.elapsed_us())
        if rows and all(len(v) == n for v in rows.values()):
            break
    if not rows:
        ms = time_ms(fn, *args, iters=EVENT_ITERS)
        log(f"device_ms: torch.profiler recorded no device time in {tries} "
            f"windows; CUDA events instead, {ms:.5f} ms a call")
        return ms, None, {"CUDA events, profiler empty": round(ms, 5)}
    by_name = {k: round(sum(v) / len(v) / 1e3, 5)
               for k, v in sorted(rows.items())}
    return sum(by_name.values()), len(events) / n, by_name


def per_call_text(per_call):
    """device_ms's device events a call, or why there is no count."""
    return "not counted" if per_call is None else f"{per_call:g}"


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
# phase 3: (what, views, map h, map w, channels, points per view,
# instantiations, also the fused render entry); the frame is (H, W)
KERNEL_SHAPES = [
    ("feats 1/4 res, per chunk", RFN, H // 4, W // 4, 64, CHUNK * DN,
     (F32, BF16), True),
    ("rgb full res, per chunk", RFN, H, W, 3, CHUNK * DN, (F32, BF16), True),
    ("feats 1/4 res, per focused chunk", RFN, H // 4, W // 4, 64,
     CHUNK * BENCH_PROFILE["focus_sample_num"], (F32, BF16, U8), True),
    ("rgb full res, per focused chunk", RFN, H, W, 3,
     CHUNK * BENCH_PROFILE["focus_sample_num"], (F32, BF16, U8), True),
    ("diff [depth|rgb], per encode", RFN, H, W, 4, RFN * H * W, (F32, BF16),
     False),
    ("diff [depth|rgb], per half-grid encode", RFN, H // 2, W // 2, 4,
     RFN * (H // 2) * (W // 2), (F32, BF16), False),
    ("self-hit ray_feats 1/4 res, per finetuning pass", 1, H // 4, W // 4,
     32, FT_PROFILE["train_ray_num"], (F32,), True)]
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
    for what, v, fh, fw, c, p, dtypes, fused in KERNEL_SHAPES:
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
            for job in jobs:
                row = kernel_row(GA, what, name, feats, *job)
                rows.append(row)
                s = stats.setdefault(name, {"max_abs_err": 0.0})
                s["max_abs_err"] = max(s["max_abs_err"], row["max_abs_err"])
                if row["entry"] == "map pixels" and what == KEY_ROWS[name]:
                    s.update({k: row[k] for k in ("plain_ms", "bound_ms",
                                                  "bound_by", "library_ms")},
                             ms=row["device_ms"])
    return rows, stats


def kernel_row(GA, what, name, feats, entry, kernel, plain, at, masked, lib):
    """One row of a forward gather: the kernel call ``kernel`` (fn, *args)
    held to ``plain`` (``hold``) and timed (profiler device ms, CUDA-event
    ms), the plain version's and the library call ``lib``'s (or None)
    event ms, and the bound of the gather at map pixels ``at``."""
    (fn, *a), (ref_fn, *ra) = kernel, plain
    v, fh, fw, c = feats.shape
    p = at.shape[1]
    err = hold(name if entry == "map pixels" else name + " fused", fn(*a),
               ref_fn(*ra))
    ms = time_ms(fn, *a)
    dev_ms, per_call, kernels = device_ms(fn, *a)
    plain_ms = time_ms(ref_fn, *ra)
    lib_ms = None if lib is None else time_ms(lib)
    nbytes, touched, bound_ms, bound_by = gather_bound(GA, feats, at, masked)
    lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"kernel check: {what} [{v},{fh},{fw},{c}] x [{v},{p},2] {name} "
        f"{entry}: max_abs_err {err:.3g}; kernel device {dev_ms:.4f} ms "
        f"({per_call_text(per_call)} launch/call {kernels}), events "
        f"{ms:.4f} ms; plain {plain_ms:.4f} ms; grid_sample {lib_txt}; "
        f"bound {nbytes} B ({touched} pixels touched) = "
        f"{1e3 * bound_ms:.2f} us ({bound_by}), share "
        f"{bound_ms / dev_ms:.3f}")
    return dict(what=what, entry=entry, dtype=name, shape=[v, fh, fw, c],
                points=p, max_abs_err=err, device_ms=dev_ms, event_ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes,
                touched_pixels=touched, bound_ms=bound_ms, bound_by=bound_by,
                share=bound_ms / dev_ms)


# phase 3, the backward: (what, views, map h, map w, channels, points per
# view, entries, the frame of the fused entry's points, its mask random (or
# ones), also a training sample's real coords) at the training steps'
# shapes: generalization training's (phase 8) and finetuning's (phase 9)
BACKWARD_SHAPES = [
    ("feats 1/4 res, per training pass", TRAIN_RFN, TRAIN_H // 4,
     TRAIN_W // 4, 64, TRAIN_RAYS * DN, ("map pixels", "fused"),
     (TRAIN_H, TRAIN_W), True, True),
    ("ray_feats 1/4 res, per depth-loss head", TRAIN_RFN, TRAIN_H // 4,
     TRAIN_W // 4, 32, TRAIN_DEPTH_COORDS, ("fused",), (TRAIN_H, TRAIN_W),
     False, False),
    ("feats 1/4 res, per finetuning pass", RFN, H // 4, W // 4, 64,
     FT_PROFILE["train_ray_num"] * DN, ("fused",), (H, W), True, False),
    ("self-hit ray_feats 1/4 res, per finetuning pass", 1, H // 4, W // 4,
     32, FT_PROFILE["train_ray_num"], ("fused",), (H, W), False, False)]
BACKWARD_KEY = ("feats 1/4 res, per training pass", "fused")
# the long bin: every point of a view on one pixel, at the training pass's
# shape. Map pixels (7.5, 7.5), a corner of four 8x8 tiles, and the frame
# point (303.5, 199.5) of the 400x608 frame, pixel (75.5, 49.5) of its
# 100x152 map (x / 607 and y / 399 are 0.5 exactly). Weights 0.25 and
# grad_out integers in [-4, 4]: every partial sum of the 32,768 products
# on a pixel is exact in f32, so any order of the sums gives one result
# (random grad_out would leave both sides ~1e-3 of f32 rounding apart).
LONG_BIN = {"map pixels": (7.5, 7.5), "fused": (303.5, 199.5)}
# edge-case checks of the tiled backward (held, not timed): the channel
# counts of every route, on maps of (views, map h, map w) with this many
# points a view: the training crop's (its 100 rows end in a partial 8x8
# tile) and one of 180 x 252 (partial tiles at both ends: desktop's 180
# rows, birds' 252 columns, phase 15); the frame is 4x the map
EDGE_CHANNELS = (1, 3, 4, 5, 8, 32, 64, 67)
EDGE_SHAPES = ((2, TRAIN_H // 4, TRAIN_W // 4, 4096), (2, 180, 252, 4096))


def gather_backward_bound(GA, grad_out, pix, fh, fw, masked):
    """The least time the card could take for one backward of the f32
    gather at map pixels pix [v, p, 2], counted as ``gather_bound``
    counts: grad_out [v, p, c], the coordinates and the mask read once
    and the [v, fh, fw, c] gradient written once (whatever implements
    it), over the HBM rate, against 10 flops a channel (the row and four
    tap weights, four adds; the mask +1) over the f32 rate. Returns
    (bytes, touched pixels, bound ms, "bytes" or "operations"); the
    touched pixels are for information."""
    v, p, c = grad_out.shape
    touched = GA.touched_pixels(pix, fh, fw)
    nbytes = (v * p * c * 4 + v * p * 2 * 4 + (v * p * 4 if masked else 0)
              + v * fh * fw * c * 4)
    flops = v * p * c * (10 + masked)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (nbytes, touched, 1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def most_taps(GA, pix, fh, fw):
    """The most taps that land on one pixel of one view, for points at map
    pixels pix [v, p, 2]."""
    v = pix.shape[0]
    x0, y0, _, _ = GA._anchor(pix, fh, fw)
    idx = (y0.long() * fw + x0.long())[..., None] + torch.tensor(
        [0, 1, fw, fw + 1], device=pix.device)
    idx = idx.reshape(v, -1) + fh * fw * torch.arange(
        v, device=pix.device)[:, None]
    return int(torch.bincount(idx.flatten()).max()) if idx.numel() else 0


def grid_sample_backward_fn(grad_out, feats_shape, points, size, align):
    """The one PyTorch call that computes the map's gradient of the same
    gather, timed as ``library_ms``: ``grid_sampler_2d_backward``'s input
    gradient on the NCHW view, border, the route's align_corners, points
    normalized by the (h, w) = size frame (the map's own for map pixels),
    grad_out already times the mask."""
    v, p, c = grad_out.shape
    h, w = size
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=points.device)
    grid = (points * scale - 1.0)[:, None].contiguous()       # v,1,p,2
    g = grad_out.permute(0, 2, 1)[:, :, None].contiguous()    # v,c,1,p
    nchw = torch.zeros(feats_shape, device=points.device).permute(0, 3, 1, 2)

    def call():
        return torch.ops.aten.grid_sampler_2d_backward(
            g, nchw, grid, 0, 1, align, [True, False])[0]
    return call


def real_training_points(dev):
    """The points of one training step's coarse pass on a synthetic
    training sample at phase 8's shapes, projected into its reference
    views: (points [v, p, 2] in the (TRAIN_H, TRAIN_W) frame, mask
    [v, p])."""
    from neuray_tpu_torch.data.train_dataset import SyntheticRendererDataset
    from neuray_tpu_torch.ops import geometry as G
    from neuray_tpu_torch.ops import sampling as S
    s = SyntheticRendererDataset(TRAIN_CUTS["train_dataset_cfg"], True)[0]
    ref, que = ({k: torch.from_numpy(v).to(dev) for k, v in s[k].items()}
                for k in ("ref", "que"))
    depth, _ = S.sample_depth(que["depth_range"], 1, TRAIN_RAYS, DN)
    pts, _ = G.depth2points(que["coords"], que["poses"], que["Ks"], depth)
    _, points, _, mask = G.project_points_ref_views(
        ref["poses"], ref["Ks"], TRAIN_H, TRAIN_W, pts.reshape(-1, 3))
    return points.contiguous(), mask.float()


def hold_backward(out, ref):
    """The backward kernel against its plain twin: both form every
    product alike, but they sum in other orders (the kernel's bins fill
    in another order on every run), so each element within 1e-5 relative
    and 1e-6 of the largest gradient absolute. Returns the max abs
    error."""
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-6 * ref.abs().max().item())
    return (out - ref).abs().max().item()


def poisoned(fn, *args):
    """``fn(*args)`` (a backward entry) into a block that held NaN: a block
    of the gradient's size is filled with NaN and freed, so the caching
    allocator hands it back as the gradient; a pixel the kernels do not
    write stays NaN. Raises unless the block came back and the result is
    finite."""
    grad_out, *_, fh, fw = args
    v, _, c = grad_out.shape
    junk = torch.full((v, fh, fw, c), float("nan"), device=grad_out.device)
    ptr = junk.data_ptr()
    del junk
    out = fn(*args)
    torch.cuda.synchronize()
    if out.data_ptr() != ptr:
        raise RuntimeError("the NaN-filled block did not come back as the "
                           "gradient")
    bad = int((~torch.isfinite(out)).sum())
    if bad:
        raise RuntimeError(f"the backward left {bad} gradient elements "
                           "unwritten or not finite")
    return out


def backward_call(GA, grad_out, at, m, h, w, fh, fw):
    """(kernel entry, plain twin, args, map pixels of the points, the
    library's frame and align_corners) of one backward: the map-pixel
    entry when m is None, else the fused entry with mask m."""
    if m is None:
        return (GA.gather_bilinear_border_backward,
                GA.gather_bilinear_border_backward_ref,
                (grad_out, at, fh, fw), at, (fh, fw), True)
    align = fh == h and fw == w
    return (GA.gather_feature_map_backward,
            GA.gather_feature_map_backward_ref,
            (grad_out, at, m, h, w, fh, fw),
            GA.feature_pixel_coords(at, h, w, fh, fw, align), (h, w), align)


def hold_backward_call(GA, grad_out, at, m, h, w, fh, fw):
    """One backward launch held to its plain twin, into a NaN-poisoned
    block (``poisoned``), counted once. Returns (max abs error, kernel
    entry, its args, map pixels, library frame, align)."""
    fn, plain, args, pix, size, align = backward_call(
        GA, grad_out, at, m, h, w, fh, fw)
    before = GA.BACKWARD_LAUNCHES
    err = hold_backward(poisoned(fn, *args), plain(*args))
    if GA.BACKWARD_LAUNCHES != before + 1:
        raise RuntimeError("the backward kernel was not launched once")
    return err, fn, plain, args, pix, size, align


def backward_row(GA, what, entry, grad_out, at, m, h, w, fh, fw,
                 parent=None):
    """One timed backward row: held (``hold_backward_call``), the kernel's
    device time (profiler) and kernels a call, its event time, the plain
    twin's and ``grid_sampler_2d_backward``'s, the bound and its share,
    taps a touched pixel and the most on one pixel; with ``parent`` (the
    gather module of an earlier checkout) its device time on the same
    inputs, in turns parent, this, this, parent. Logs one line; returns
    the row."""
    v, p, c = grad_out.shape
    err, fn, plain, args, pix, size, align = hold_backward_call(
        GA, grad_out, at, m, h, w, fh, fw)
    ms = time_ms(fn, *args)
    dev_ms, per_call, kernels = device_ms(fn, *args)
    plain_ms = time_ms(plain, *args)
    lib_ms = time_ms(grid_sample_backward_fn(
        grad_out if m is None else grad_out * m[..., None], (v, fh, fw, c),
        at, size, align))
    nbytes, touched, bound_ms, bound_by = gather_backward_bound(
        GA, grad_out, pix, fh, fw, m is not None)
    row = dict(what=what, entry=entry, shape=[v, fh, fw, c], points=p,
               max_abs_err=err, device_ms=dev_ms, kernels_per_call=per_call,
               event_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bytes=nbytes, touched_pixels=touched,
               most_taps=most_taps(GA, pix, fh, fw), bound_ms=bound_ms,
               bound_by=bound_by, share=bound_ms / dev_ms)
    text = ""
    if parent is not None:
        pfn = getattr(parent, fn.__name__)
        turns = [device_ms(f, *args)[0] for f in (pfn, fn, fn, pfn)]
        row.update(parent_device_ms=[turns[0], turns[3]],
                   turns_device_ms=turns[1:3])
        text = (f"; in turns parent {turns[0]:.4f} / {turns[3]:.4f} ms, this"
                f" {turns[1]:.4f} / {turns[2]:.4f} ms")
    log(f"backward check: {what} [{v},{fh},{fw},{c}] x [{v},{p},2] {entry}: "
        f"max_abs_err {err:.3g}; kernel device {dev_ms:.4f} ms "
        f"({per_call_text(per_call)} kernels/call {kernels}), events "
        f"{ms:.4f} ms; plain {plain_ms:.4f} ms; grid_sampler_2d_backward "
        f"{lib_ms:.4f} ms; bound {nbytes} B = {1e3 * bound_ms:.2f} us "
        f"({bound_by}), share {bound_ms / dev_ms:.3f}; {touched} pixels "
        f"touched, {4 * v * p / max(touched, 1):.1f} taps a pixel, at most "
        f"{row['most_taps']} on one{text}")
    return row


def row_stats(row):
    """A backward row's timed figures for the kernels line."""
    return {"ms": row["device_ms"], **{k: row[k] for k in (
        "plain_ms", "bound_ms", "bound_by", "library_ms", "share",
        "kernels_per_call")}}


def check_backward_edges(GA, dev, g):
    """Phase 3's edge cases of the tiled backward, each held to its plain
    twin into a NaN-poisoned block, on each map of ``EDGE_SHAPES``:
    points on 8x8 tile seams and corners, on the map's last row and
    column (a partial tile where the side is not a multiple of 8), and
    outside it, at every channel count of ``EDGE_CHANNELS`` (the 16-byte,
    8-byte and scalar routes), on both entries (map pixels; fused,
    half-pixel, with mask zeros); one view; no points; grad_out 4 and 8
    bytes off a 16-byte boundary (the scalar and 8-byte routes). Returns
    the largest error and the count of checks."""
    worst, n = 0.0, 0
    for shape in EDGE_SHAPES:
        e, k = edge_cases(GA, dev, g, *shape)
        worst, n = max(worst, e), n + k
    log(f"backward edge cases: {n} checks on maps {EDGE_SHAPES} (tile seams "
        f"and corners, the last row and column, outside the map; c "
        f"{EDGE_CHANNELS}; one view; no points; grad_out 4 and 8 bytes "
        f"off), max_abs_err {worst:.3g}, every pixel written")
    return worst, n


def edge_cases(GA, dev, g, v, fh, fw, p):
    """``check_backward_edges`` on one map [v, fh, fw] with p points a
    view, its frame 4x the map. Returns (the largest error, the count)."""
    h, w = 4 * fh, 4 * fw
    q = p // 4

    def seams(hi):
        return torch.randint(1, hi, (v, q, 1), generator=g, device=dev) * 8 - 1

    seam = torch.cat([seams(fw // 8), seams(fh // 8)], -1).float()
    pix = torch.cat([
        seam + torch.rand((v, q, 2), generator=g, device=dev),  # seams
        seam,                                                    # corners
        torch.tensor([fw - 1.0, fh - 1.0], device=dev) - torch.rand(
            (v, q, 2), generator=g, device=dev) * 1.5,           # last row
        random_coords(g, dev, v, q, fh, fw) * 1.4 - 10], 1)      # outside
    # the frame points whose map pixels these are (half-pixel)
    pts = ((pix + 0.5) * torch.tensor([(w - 1) / fw, (h - 1) / fh],
                                      device=dev)).contiguous()
    mask = (torch.rand((v, p), generator=g, device=dev) > 0.3).float()
    worst, n = 0.0, 0
    for c in EDGE_CHANNELS:
        grad_out = torch.randn((v, p, c), generator=g, device=dev)
        cases = [(grad_out, pix.contiguous(), None), (grad_out, pts, mask),
                 (grad_out[:1], pts[:1], mask[:1]),
                 (grad_out[:, :0], pts[:, :0], mask[:, :0])]
        if c % 4 == 0:
            flat = torch.randn(v * p * c + 2, generator=g, device=dev)
            cases += [(flat[k:k + v * p * c].view(v, p, c), pts, mask)
                      for k in (1, 2)]
        for go, at, m in cases:
            worst = max(worst, hold_backward_call(GA, go, at, m, h, w, fh,
                                                  fw)[0])
            n += 1
    return worst, n


def check_backward(GA, dev, parent=None):
    """Phase 3, the backward at the training steps' shapes: random coords
    (5% outside the map) and, for generalization training's 64-channel
    pass, the real coords of a training sample's coarse pass and the long
    bins (``LONG_BIN``), each a timed row (``backward_row``); then the
    edge cases (``check_backward_edges``). Returns the kernels-line stats
    of ``BACKWARD_KEY``'s row."""
    g = torch.Generator(device=dev).manual_seed(1)
    stats = {"max_abs_err": 0.0}
    for (what, v, fh, fw, c, p, entries, (h, w), random_mask,
         real) in BACKWARD_SHAPES:
        grad_out = torch.randn((v, p, c), generator=g, device=dev)
        points = random_coords(g, dev, v, p, h, w)
        mask = ((torch.rand((v, p), generator=g, device=dev) > 0.3).float()
                if random_mask else torch.ones((v, p), device=dev))
        jobs = [("map pixels", grad_out, random_coords(g, dev, v, p, fh, fw),
                 None) if e == "map pixels" else
                ("fused", grad_out, points, mask) for e in entries]
        if real:
            jobs.append(("fused, real coords", grad_out,
                         *real_training_points(dev)))
            exact = torch.randint(-4, 5, (v, p, c), generator=g,
                                  device=dev).float()
            for e in entries:
                at = torch.tensor(LONG_BIN[e], device=dev).expand(
                    v, p, 2).contiguous()
                jobs.append((f"{e}, long bin {LONG_BIN[e]}", exact, at,
                             None if e == "map pixels" else mask))
        for entry, go, at, m in jobs:
            row = backward_row(GA, what, entry, go, at, m, h, w, fh, fw,
                               parent)
            stats["max_abs_err"] = max(stats["max_abs_err"],
                                       row["max_abs_err"])
            if (what, entry) == BACKWARD_KEY:
                stats.update(row_stats(row))
    worst, _ = check_backward_edges(GA, dev, g)
    stats["max_abs_err"] = max(stats["max_abs_err"], worst)
    return stats


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


def expected_fast_launches(out, n_rays, n_probe, chunk=CHUNK):
    """Gather launches implied by ``render_frame_probe_auto``'s own chunk
    counts: 1 for the encode's half-grid diff gather, and 2 (rgb, then
    the 64-ch map) per chunk pass. Per audit rung: the strided probe over
    n_probe rays, the false-skip audit over min(skipped, 2048) rays and,
    where it ran, the window audit over min(kept, 1024) rays. Then the
    focused render, 2 passes over the kept rays, or on fallback the exact
    coarse pass over every ray and the fine pass over the kept ones."""
    def chunks(n):
        return -(-n // chunk)

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
    instantiation, and the bench default's frame record (``out``, its
    ``encode`` and ``render`` seconds: phase 18 holds its sharded twin to
    it)."""
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
    return [f["launches"] for f in (u8, bf16, f32)], u8


def scene_frame(name, size=H):
    """Phase 19's frame of the named scene (``data/synthetic.py:
    named_scene``): RFN reference views of ``RandomState(0)`` and the
    full-image query that follows them, as numpy arrays, and the query's
    ground truth [size, size, 3]."""
    from neuray_tpu_torch.data.synthetic import (
        make_query, make_sphere_scene, named_scene)
    spheres, depth_range = named_scene(name)
    rng = np.random.RandomState(0)
    ref = make_sphere_scene(rng, RFN, size, size, spheres, depth_range)
    que = make_query(rng, size, size, 0, full_image=True, spheres=spheres,
                     depth_range=depth_range)
    return ref, que, que.pop("imgs")[0]


def scene_psnr_rays(size=H):
    """The rays of every SCENE_PSNR_STRIDE-th pixel of every
    SCENE_PSNR_STRIDE-th row of a size x size frame, as indices."""
    ys, xs = np.meshgrid(np.arange(0, size, SCENE_PSNR_STRIDE),
                         np.arange(0, size, SCENE_PSNR_STRIDE), indexing="ij")
    return (ys * size + xs).ravel()


def cv_psnr_rays():
    """The query's rays on every CV_PSNR_STRIDE-th pixel of every
    CV_PSNR_STRIDE-th row, as indices into its CV_QH x CV_QW rays."""
    ys, xs = np.meshgrid(np.arange(0, CV_QH, CV_PSNR_STRIDE),
                         np.arange(0, CV_QW, CV_PSNR_STRIDE), indexing="ij")
    return (ys * CV_QW + xs).ravel()


def cv_scene(seed=0):
    """Phase 10's scene, as ``tools/bench_cost_volume.py`` builds it: RFN
    reference views of the sphere at CV_W x CV_H, the src views the refs
    themselves, each ref's ``nn_ids`` its CV_NN nearest other refs by
    camera centre; a CV_QW x CV_QH query over every pixel. Returns (ref,
    src, que, the query's ground-truth image), numpy."""
    from neuray_tpu_torch.data.synthetic import (
        DEPTH_RANGE, look_at_camera, render_spheres_view)
    rng = np.random.RandomState(seed)
    views = [look_at_camera(rng, CV_H, CV_W) for _ in range(RFN)]
    centers = np.stack([-pose[:, :3].T @ pose[:, 3] for pose, _ in views])
    ref = {"imgs": np.stack([render_spheres_view(pose, K, CV_H, CV_W)[0]
                             for pose, K in views]),
           "poses": np.stack([pose for pose, _ in views]),
           "Ks": np.stack([K for _, K in views]),
           "depth_range": np.tile(np.asarray([DEPTH_RANGE], np.float32),
                                  (RFN, 1)),
           "nn_ids": np.stack([np.argsort(np.linalg.norm(
               centers - c, axis=1))[1:CV_NN + 1] for c in centers])}
    src = {k: ref[k] for k in ("imgs", "poses", "Ks", "depth_range")}
    pose, K = look_at_camera(rng, CV_QH, CV_QW)
    xs, ys = np.meshgrid(np.arange(CV_QW), np.arange(CV_QH))
    que = {"coords": np.stack([xs, ys], -1).reshape(1, -1, 2).astype(
               np.float32),
           "poses": pose[None], "Ks": K[None],
           "depth_range": np.asarray([DEPTH_RANGE], np.float32)}
    return ref, src, que, render_spheres_view(pose, K, CV_QH, CV_QW)[0]


class SpanTimer:
    """CUDA-event spans of named calls: ``wrap(name, fn)`` returns fn
    recording an event pair around each call; ``ms()`` sums each name's
    spans (after a synchronize) and counts them."""

    def __init__(self):
        self.spans = {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.spans.setdefault(name, []).append((start, end))
            return out
        return timed

    def ms(self):
        torch.cuda.synchronize()
        return {k: (sum(a.elapsed_time(b) for a, b in v), len(v))
                for k, v in self.spans.items()}


def cv_encode_breakdown(renderer, ref, src):
    """One more cost-volume encode with CUDA-event spans around MVSNet,
    its FeatureNet, each homo_warp and each CostRegNet call, the init net
    and the whole encode. Returns {span: (ms, calls)}."""
    from neuray_tpu_torch.models import mvsnet as M
    from neuray_tpu_torch.models.renderer import encode_ref
    timer, init = SpanTimer(), renderer.init_net
    mods = {"init net": init, "MVSNet": init.mvsnet,
            "FeatureNet": init.mvsnet.feature,
            "CostRegNet": init.mvsnet.cost_regularization}
    warp = M.homo_warp
    try:
        for name, mod in mods.items():
            mod.forward = timer.wrap(name, mod.forward)
        M.homo_warp = timer.wrap("homo_warp", warp)
        timer.wrap("encode", encode_ref)(renderer, ref, src)
    finally:
        M.homo_warp = warp
        for mod in mods.values():
            del mod.forward
    return timer.ms()


def warp_bound_ms(n_warps):
    """homo_warp's bytes bound for a frame: each call reads its source map
    [32, 144, 192] once and writes its [32, 64, 144, 192] f32 volume
    once (``CV_WARP_SHAPE``), over the HBM rate."""
    c, dn, h, w = CV_WARP_SHAPE
    return 1e3 * n_warps * 4 * (c * h * w + c * dn * h * w) / HBM_BYTES_PER_S


def cv_phase(GA, R, dev, weights):
    """Phase 10: the cost-volume frame (``cv_scene``), two routes.

    1. The exact f32 coarse + fine render (``CV_PROFILE``) through
       ``encode_ref(renderer, ref, src)`` and ``render_rays``: a warm-up
       frame, then a timed one whose gather launches must be 2 a chunk
       pass (the cost-volume encode gathers nothing), all f32; outputs
       finite, ray_feats on the card, GT-PSNR of the fine image reported
       and, on ``cv_psnr_rays``, within ``CV_PSNR_TOL`` of the JAX
       package's ``CV_JAX_GT_PSNR``. Then the encode's breakdown (CUDA events:
       MVSNet and its parts, homo_warp beside its bytes bound), a
       profiled encode and a profiled chunk (kernels, idle share), the
       centre chunk's 64-ch map gathers as forward rows on their real
       coords (``kernel_row``), and 1024 rays through the image centre,
       card against CPU per pass at 1e-4 on the same encoded maps
       (``in_situ``).
    2. The bench default (``CV_BENCH_PROFILE``: bf16 + u8,
       ``render_frame_probe_focus`` with ``BENCH_ARGS``): warm-up, then a
       timed frame, and the same profile in f32, each one's launches
       equal to what its chunk counts imply; the bf16 + u8 frame's
       GT-PSNR no more than ``CV_BF16_GT_TOL`` below the f32 frame's,
       its PSNR against that frame and against route 1's reported.
    Returns (the gather launches of both timed frames, by instantiation;
    the forward rows)."""
    from neuray_tpu_torch.utils.params import load_flax_params
    gc.collect()            # the earlier phases' trainers (closures cycle)
    torch.cuda.empty_cache()
    ref_np, src_np, que_np, gt = cv_scene()
    ref, src, que = ({k: torch.from_numpy(v).to(dev) for k, v in d.items()}
                     for d in (ref_np, src_np, que_np))
    renderer = R.NeurayRenderer(R.RenderConfig(**CV_PROFILE))
    load_flax_params(renderer, weights)
    renderer = renderer.to(dev).eval()
    n_rays = que["coords"].shape[1]
    n_chunks = -(-n_rays // CHUNK)
    shape = (CV_QH, CV_QW, 3)

    gather, captured, fmap = R.interpolate_feature_map, [], []

    def capture_centre(feats, *args):
        if feats.shape[-1] == 64:
            fmap.append(None)
            if (len(fmap) - 1) // 2 == WARMUP_CHUNKS // 2:
                keep_points(captured, *args[:2])
        return gather(feats, *args)

    # the warm-up: WARMUP_CHUNKS chunks around the centre chunk, whose
    # gathers' points are kept, and the frame's output allocations (as
    # phase 4's)
    t0 = time.perf_counter()
    start = (n_chunks // 2 - WARMUP_CHUNKS // 2) * CHUNK
    R.interpolate_feature_map = capture_centre
    try:
        warm = R.render_rays(renderer, R.encode_ref(renderer, ref, src), dict(
            que, coords=que["coords"][:, start:start + WARMUP_CHUNKS * CHUNK]))
    finally:
        R.interpolate_feature_map = gather
    frame_sized = [torch.empty((1, n_rays) + v.shape[2:], dtype=v.dtype,
                               device=dev) for v in warm.values()]
    del warm, frame_sized
    torch.cuda.synchronize()
    log(f"cost-volume warm-up ({WARMUP_CHUNKS} chunks around the centre and "
        f"the frame's output allocations): {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    GA.reset_launches()
    t0 = time.perf_counter()
    ref_c = R.encode_ref(renderer, ref, src)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = R.render_rays(renderer, ref_c, que)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    exact = dict(GA.LAUNCHES_BY_DTYPE)
    if exact != {"f32": 4 * n_chunks, "bf16": 0, "u8": 0}:
        raise RuntimeError(f"cost-volume frame: gather launches {exact}, "
                           f"expected {4 * n_chunks} f32 (2 a chunk pass)")
    if {ref_c[k].device.type for k in ("ray_feats", "feats")} != {dev.type}:
        raise RuntimeError("cost-volume encode did not run on the card")
    for k, v in out.items():
        if v.shape[:2] != (1, n_rays):
            raise RuntimeError(f"cost-volume {k} has shape {tuple(v.shape)}")
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise RuntimeError(f"cost-volume {k} is not finite")
    img = out["pixel_colors_nr_fine"][0].reshape(shape).cpu().numpy()
    frame_psnr = psnr(img, gt)
    coarse_psnr = psnr(out["pixel_colors_nr"][0].reshape(shape).cpu()
                       .numpy(), gt)
    log(f"cost-volume frame: {n_rays} rays ({CV_QW}x{CV_QH}) from {RFN} "
        f"views {CV_W}x{CV_H}, nn {CV_NN}, {DN} + {DN} samples: encode "
        f"{t1 - t0:.3f} s, ray loop {t2 - t1:.3f} s = "
        f"{n_rays / (t2 - t1):.1f} rays/s ({n_rays / (t2 - t0):.1f} rays/s "
        f"with the encode), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({base / 2**30:.2f} GiB allocated before the frame), gather "
        f"launches {exact['f32']}")
    sub = cv_psnr_rays()
    sub_psnr = psnr(img.reshape(-1, 3)[sub], gt.reshape(-1, 3)[sub])
    log(f"cost-volume quality: GT-PSNR fine {frame_psnr:.3f} dB, coarse "
        f"{coarse_psnr:.3f} dB; fine on the {sub.size} rays of every "
        f"{CV_PSNR_STRIDE}th pixel and row {sub_psnr:.4f} dB, the JAX "
        f"package's (CPU) {CV_JAX_GT_PSNR:.4f} dB")
    if not abs(sub_psnr - CV_JAX_GT_PSNR) <= CV_PSNR_TOL:
        raise RuntimeError(f"cost-volume GT-PSNR {sub_psnr:.4f} dB is "
                           f"{CV_PSNR_TOL} dB or more from the JAX "
                           f"package's {CV_JAX_GT_PSNR:.4f} dB")

    spans = cv_encode_breakdown(renderer, ref, src)
    enc = spans["encode"][0]
    n_warps = spans["homo_warp"][1]
    log("cost-volume encode (CUDA events): " + ", ".join(
        f"{k} {ms:.2f} ms ({ms / enc:.3f} of the encode, {n} calls)"
        for k, (ms, n) in spans.items()) + f"; homo_warp's bytes bound "
        f"{warp_bound_ms(n_warps):.3f} ms for its {n_warps} volumes "
        f"{list(CV_WARP_SHAPE)}")
    profile_step(lambda: R.encode_ref(renderer, ref, src),
                 "cost-volume encode")
    que_chunk = dict(que, coords=que["coords"][:, (n_chunks // 2) * CHUNK:
                                               (n_chunks // 2 + 1) * CHUNK])
    with torch.inference_mode():
        profile_step(lambda: renderer.render_chunk(ref_c, que_chunk),
                     "cost-volume render chunk")

    feats = ref_c["feats"]
    rows = []
    for name, (points, mask) in zip(("coarse", "fine"), captured):
        pix = GA.feature_pixel_coords(points, CV_H, CV_W, *feats.shape[1:3],
                                      False)
        what = f"cost-volume feats 1/4 res, centre chunk, {name} pass"
        rows.append(kernel_row(
            GA, what, "f32", feats, "map pixels",
            (GA.gather_bilinear_border, feats, pix),
            (GA.gather_bilinear_border_ref, feats, pix), pix, False,
            grid_sample_fn(feats, pix)))
        args = (feats, points, mask, CV_H, CV_W, None)
        rows.append(kernel_row(GA, what, "f32", feats, "fused",
                               (GA.gather_feature_map, *args),
                               (GA.gather_feature_map_ref, *args), pix, True,
                               None))
    in_situ(R, renderer, ref_c, que, np.arange(N_CHECK)
            + (n_rays - N_CHECK) // 2)

    stride = BENCH_ARGS["probe_stride"]
    n_probe = -(-CV_QH // stride) * -(-CV_QW // stride)

    def focus_frame(r):
        """Encode + render_frame_probe_focus; its launches held to its
        chunk counts (every gather of the route's maps)."""
        GA.reset_launches()
        t0 = time.perf_counter()
        ref_b = R.encode_ref(r, ref, src)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = R.render_frame_probe_focus(r, ref_b, que,
                                         image_hw=(CV_QH, CV_QW),
                                         **BENCH_ARGS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = dict(GA.LAUNCHES_BY_DTYPE)
        route = "u8" if r.cfg.use_bf16 else "f32"
        want = {"f32": 0, "bf16": 0, "u8": 0}
        want[route] = expected_focus_launches(res["kept_rays"], n_probe)
        if launches != want:
            raise RuntimeError(f"cost-volume bench default ({route}): gather "
                               f"launches {launches}, expected {want}")
        for k in ("pixel_colors_nr", "pixel_colors_nr_fine"):
            if res[k].shape != (1, n_rays, 3) or not np.isfinite(
                    res[k]).all():
                raise RuntimeError(f"cost-volume bench default ({route}) {k}"
                                   f": shape {res[k].shape} or not finite")
        return {"out": res, "launches": launches, "encode": t1 - t0,
                "render": t2 - t1,
                "img": res["pixel_colors_nr_fine"][0].reshape(shape)}

    def build(profile):
        r = R.NeurayRenderer(R.RenderConfig(**profile))
        r.load_state_dict(renderer.state_dict())
        return r.to(dev).eval()

    bench = build(CV_BENCH_PROFILE)
    t0 = time.perf_counter()
    focus_frame(bench)
    log(f"cost-volume bench default warm-up frame: "
        f"{time.perf_counter() - t0:.2f} s")
    u8 = focus_frame(bench)
    f32 = focus_frame(build({**CV_BENCH_PROFILE, "use_bf16": False,
                             "gather_quant": "none"}))
    vs_f32 = psnr(u8["img"], f32["img"])
    flips = int((u8["out"]["keep_mask"] != f32["out"]["keep_mask"]).sum())
    for name, f in (("bf16 + u8", u8), ("f32", f32)):
        kept = f["out"]["kept_rays"]
        log(f"cost-volume bench default ({name}, focus "
            f"{CV_BENCH_PROFILE['focus_sample_num']}:"
            f"{CV_BENCH_PROFILE['focus_fine_sample_num']}): encode "
            f"{f['encode']:.3f} s, probe + render {f['render']:.3f} s = "
            f"{n_rays / f['render']:.1f} rays/s "
            f"({n_rays / (f['encode'] + f['render']):.1f} rays/s with the "
            f"encode), kept {kept / n_rays:.4f} of the rays, gather launches"
            f" {f['launches']}; GT-PSNR {psnr(f['img'], gt):.3f} dB, against"
            f" the exact f32 frame {psnr(f['img'], img):.3f} dB")
    gt_u8, gt_f32 = psnr(u8["img"], gt), psnr(f32["img"], gt)
    log(f"cost-volume bench default quality: bf16 + u8 against the f32 "
        f"frame of the same profile {vs_f32:.3f} dB; rays whose keep "
        f"decision differs {flips}; GT-PSNR {gt_u8:.3f} dB against the f32 "
        f"frame's {gt_f32:.3f} dB")
    if not gt_u8 >= gt_f32 - CV_BF16_GT_TOL:
        raise RuntimeError(f"cost-volume bench default GT-PSNR {gt_u8:.3f} dB"
                           f" is {CV_BF16_GT_TOL} dB or more below its f32 "
                           f"frame's {gt_f32:.3f} dB")
    return [exact, u8["launches"], f32["launches"]], rows


def sphere_rays(sample, n, seed=0):
    """The sample with its query rays moved onto n pixels where the query
    view sees the sphere (on nearly empty rays the fine sampler divides by
    a coarse hit mass near 0, and a rounding difference between two
    devices moves the fine depths: ROADMAP Queue 3, fault 3)."""
    ys, xs = np.nonzero(sample["que"]["imgs"][0].sum(-1) > 0)
    pick = np.random.RandomState(seed).choice(ys.size, n, replace=False)
    sample["que"]["coords"] = np.stack(
        [xs[pick], ys[pick]], -1)[None].astype(np.float32)
    return sample


def tap(module, names):
    """Forward hooks on ``module``'s submodules ``names`` ("" for itself):
    each call records the submodule's first input and its output, and the
    output's gradient when a backward reaches it. Returns (records by
    name, the hooks' handles)."""
    rec, handles = {}, []
    for name in names:
        def hook(mod, args, out, name=name):
            r = rec[name] = {"in": args[0].detach(), "out": out.detach()}
            if out.requires_grad:
                out.register_hook(lambda g: r.__setitem__("grad", g.detach()))
        handles.append(module.get_submodule(name).register_forward_hook(hook))
    return rec, handles


def relu_tape(module=None, replay=None):
    """``torch.nn.functional.relu`` replaced until the returned ``restore``
    is called: it records each call's mask (input > 0, on the CPU) into
    the returned list while ``module``'s forward runs (every call if
    module is None), or with ``replay`` (masks in call order) returns its
    input times the next mask, so the backward passes exactly where the
    recorded forward passed. Returns (the masks, restore)."""
    F = torch.nn.functional
    own, masks, state = F.relu, [], {"on": module is None}

    def relu(x, inplace=False):
        if replay is not None:
            masks.append(replay[len(masks)])
            return x * masks[-1].to(x.device, x.dtype)
        out = own(x, inplace=inplace)
        if state["on"]:
            masks.append((out > 0).cpu())
        return out

    handles = [] if module is None else [
        module.register_forward_pre_hook(lambda *a: state.update(on=True)),
        module.register_forward_hook(lambda *a: state.update(on=False))]

    def restore():
        F.relu = own
        for h in handles:
            h.remove()

    F.relu = relu
    return masks, restore


def encoder_f64(encoder, imgs, grad, names=(), masks=None,
                prefix="image_encoder", device="cpu"):
    """The f64 witness: ``encoder`` (a ResUNet of the renderer: the image
    encoder, the init net's ``res_net``) copied to f64 on ``device``, its
    InstanceNorms too (the port computes their statistics in f32), run on
    imgs and taken back from ``grad``, the gradient of its output; with
    ``masks`` (an f32 forward's ReLU masks, ``relu_tape``) each ReLU
    passes where that forward's did. The run's checks take it on the card
    (f64 there too; ``witness_device_check`` holds it to the CPU's).
    Returns (its parameters' gradients by the renderer's names, under
    ``prefix``, on the CPU; ``tap`` records of names; its ReLU masks)."""
    from neuray_tpu_torch.models import blocks
    enc = copy.deepcopy(encoder).to(device).double()
    rec, handles = tap(enc, names)
    own = blocks.InstanceNorm.forward
    blocks.InstanceNorm.forward = lambda self, x: \
        torch.nn.functional.instance_norm(x, weight=self.weight,
                                          bias=self.bias, eps=self.eps)
    used, restore = relu_tape(replay=masks)
    try:
        enc(imgs.to(device, torch.float64)).backward(
            grad.to(device, torch.float64))
    finally:
        restore()
        blocks.InstanceNorm.forward = own
        for h in handles:
            h.remove()
    if masks is not None and len(used) != len(masks):
        raise RuntimeError(f"the witness made {len(used)} ReLU calls, the "
                           f"forward it replays {len(masks)}")
    return ({f"{prefix}.{n}": p.grad.cpu()
             for n, p in enc.named_parameters()}, rec, used)


# witness_device_check: the views of a step's encoder input it takes, and
# its bar on each leaf: both sides are f64 but for the decoder's upsample
# weights, which the port computes from f32 sample positions
# (``blocks.upsample2x_align_corners``) that the card and the CPU round
# apart (up to 3.8e-6 in a weight on the card); the bar is 200x under the
# GRAD_BOUND the witness holds the card to, the floor for the conv biases
# that feed an InstanceNorm, whose gradient is 0 but for rounding
WITNESS_VIEWS = 2
WITNESS_DEVICE_BOUND, WITNESS_DEVICE_FLOOR = 1e-5, 1e-9


def witness_device_check(dev, cfg, weights, io):
    """The f64 witness (``encoder_f64``) on the card against the same on
    the CPU: the trained weights' image encoder (``cfg``: the renderer's)
    on the first ``WITNESS_VIEWS`` views of a step's encoder input ``io``
    (the CPU side's input, output gradient: ``grad_check``'s record), the
    card replaying the CPU witness's own ReLU masks; each leaf within
    ``WITNESS_DEVICE_BOUND`` of its norm plus ``WITNESS_DEVICE_FLOOR``.
    Both sides timed."""
    from neuray_tpu_torch.models.renderer import NeurayRenderer
    from neuray_tpu_torch.utils.params import load_flax_params
    model = NeurayRenderer(cfg)
    load_flax_params(model, weights)
    imgs, grad = io["in"][:WITNESS_VIEWS], io["grad"][:WITNESS_VIEWS]
    t0 = time.perf_counter()
    cpu, _, masks = encoder_f64(model.image_encoder, imgs, grad)
    t1 = time.perf_counter()
    card = encoder_f64(model.image_encoder, imgs, grad, masks=masks,
                       device=dev)[0]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    worst, leaf, small, bad = 0.0, None, 0.0, []
    for k, b in cpu.items():
        diff, norm = (card[k] - b).norm().item(), b.norm().item()
        if diff > WITNESS_DEVICE_BOUND * norm + WITNESS_DEVICE_FLOOR:
            bad.append((k, diff, norm))
        if norm > WITNESS_DEVICE_FLOOR / WITNESS_DEVICE_BOUND:
            if diff / norm >= worst:
                worst, leaf = diff / norm, k
        else:
            small = max(small, diff)
    log(f"f64 witness, card vs CPU (the image encoder on {WITNESS_VIEWS} "
        f"views {list(imgs.shape[1:3])}, the CPU's ReLU masks replayed): "
        f"{len(cpu)} leaves, worst {worst:.3g} of its norm ({leaf}; bound "
        f"{WITNESS_DEVICE_BOUND:g} + {WITNESS_DEVICE_FLOOR:g}), largest "
        f"difference of a leaf of norm under "
        f"{WITNESS_DEVICE_FLOOR / WITNESS_DEVICE_BOUND:g} {small:.3g}; the "
        f"CPU {t1 - t0:.2f} s, the card {t2 - t1:.2f} s")
    if bad:
        raise RuntimeError(f"the f64 witness differs between the card and "
                           f"the CPU (leaf, difference, norm): {bad}")


def grad_check(trainer, dev, weights, sample=None, what=None, witness=False,
               strict=True):
    """One training step's gradients on the card and on the CPU from the
    trained ``tools/bench_weights.npz`` (``weights``: the flax tree) in
    the training config, on the same inputs (a ``GRAD_CHECK_DATA`` sample)
    and the same fine draws (a CPU generator of one seed on both sides):
    each parameter's gradient within ``GRAD_BOUND`` of its norm plus
    ``GRAD_FLOOR`` (``compare_grads``; the card sums in another order, its
    atomics in another order on every run; a conv bias that feeds an
    InstanceNorm has an exactly zero gradient, and both sides leave
    rounding there). Both sides take the CPU's cross-view diff features:
    a pure function of the data, with no gradient, held to the kernel in
    phases 3 and 5, whose f32 rounding the init net's gradients amplify
    (4.4e-3 for 6.3e-6 on the CPU test's scene,
    ``tests/test_torch_port_train.py``). The trained weights, not the
    33-step parameters of the run: there the image encoder's first layers
    amplified the card's other summation order past the bar (a
    conditioning of that early state; the trained weights pass with a wide
    margin). ``sample`` (a training sample, its rays already where the
    query sees the sphere; phase 12 passes real-estate crops) and ``what``
    replace the synthetic sample and its description.

    ``witness`` (phase 12): the leaves of the renderer's two ResUNets
    (``WITNESSED``) are held to their f64 witness (``encoder_f64``, from
    each side's own input and gradient of the encoder's output, each ReLU
    passing where that side's f32 forward passed: ``relu_tape``) rather
    than to the CPU's f32 gradients. On real-estate crops 9-15 elements
    of the image encoder's ReLUs round across zero in an f32 forward,
    differently on the card and on the CPU (``encoder_trace``); each flip
    moves the layers below it by up to ~1e-3 of their gradient's norm, so
    two f32 sides differ by the sum of their flips, while each, with its
    own masks, is within ~1e-4 of f64 (the card ~2e-6). The step is also
    taken on the card with the CPU's fine depths (the fine sampler turns
    the coarse hit_prob's rounding into a far larger move of the fine
    depths, ROADMAP Queue 3, fault 3), as phase 9 does; both comparisons
    are printed, the one with the CPU's fine depths is held (one
    real-estate crop of 12, its fine depths 0.051 apart, reads 3.18e-3 on
    ``fine_agg_net`` with its own and 5.6e-4 with the CPU's). ``strict``: raise when a held leaf is outside
    its bar. Returns the records of ``compare_grads`` (``own``: each
    side's fine depths; ``given``: the CPU's given to the card, under
    ``witness``), the fine depths' largest difference, the losses and,
    under ``witness``, the CPU's encoder input and output gradient
    (``io``)."""
    from neuray_tpu_torch.data.train_dataset import SyntheticRendererDataset
    from neuray_tpu_torch.models import init_net as N
    from neuray_tpu_torch.models.renderer import NeurayRenderer
    from neuray_tpu_torch.utils.params import load_flax_params
    trained = NeurayRenderer(trainer.renderer.cfg)
    load_flax_params(trained, weights)
    if sample is None:
        sample = sphere_rays(
            SyntheticRendererDataset(GRAD_CHECK_DATA, True)[0],
            GRAD_CHECK_DATA["train_ray_num"])
        what = what or (f"training gradients, card vs CPU ({GRAD_CHECK_DATA}"
                        f", {DN} + {DN} samples, rays through the sphere)")
    sample = {k: v for k, v in sample.items() if k != "scene_name"}
    ref = {k: torch.from_numpy(v) for k, v in sample["ref"].items()}
    diff = N.get_diff_feats(
        ref["imgs"], N.extract_depth_for_init(ref["depth_range"],
                                              ref["depth"]),
        ref["depth_range"], ref["poses"], ref["Ks"])

    def step(device, fine=None):
        """The step on device (the fine depths replaced by ``fine`` where
        given): its loss, gradients, fine depths and encoder record."""
        renderer = copy.deepcopy(trained).to(device).train()
        names = WITNESSED if witness else ()
        rec, handles = tap(renderer, names)
        seen, own = [], renderer._fine_depth

        def fine_depth(*args):
            d = own(*args) if fine is None else fine[len(seen)].to(device)
            seen.append(d.detach().cpu())
            return d

        renderer._fine_depth = fine_depth
        batch = {k: ({n: torch.from_numpy(x).to(device)
                      for n, x in v.items()} if isinstance(v, dict)
                     else torch.from_numpy(v).to(device))
                 for k, v in sample.items()}
        tapes = [relu_tape(renderer.get_submodule(n)) for n in names]
        try:
            out = renderer(batch["ref"], batch["que"], True,
                           batch.get("depth_loss_coords"),
                           torch.Generator().manual_seed(11))
            losses = trainer.loss_fn(out, batch)
            total = sum(v.mean() for k, v in losses.items()
                        if k.startswith("loss"))
            total.backward()
        finally:
            for _, restore in reversed(tapes):
                restore()
            for h in handles:
                h.remove()
        grads = {n: p.grad.cpu().double()
                 for n, p in renderer.named_parameters() if p.grad is not None}
        io = {n: {"in": rec[n]["in"].cpu(), "grad": rec[n]["grad"].cpu(),
                  "masks": masks} for n, (masks, _) in zip(names, tapes)}
        return total.item(), grads, seen, io

    own_diff = N.get_diff_feats
    N.get_diff_feats = lambda imgs, *args: diff.to(imgs.device)
    try:
        cpu = step(torch.device("cpu"))
        card = step(dev)
        given = step(dev, cpu[2]) if witness else None
    finally:
        N.get_diff_feats = own_diff
    moved = max((a - b).abs().max().item() for a, b in zip(card[2], cpu[2]))
    if not witness:
        result = compare_grads(card[1], cpu[1], what, None, strict)
        log(f"training loss, card vs CPU: {card[0]:.6f} vs {cpu[0]:.6f}")
        return {"own": result, "given": None, "moved": moved,
                "losses": (card[0], cpu[0]), "io": None}

    def f64(side):
        """The side's f64 witnesses of the ``WITNESSED`` modules, from its
        own input and output gradient: with f64's own ReLU masks, and
        with the side's, and the count of elements where they differ."""
        exact, replayed, flips = {}, {}, 0
        for name in WITNESSED:
            module, io = trained.get_submodule(name), side[3][name]
            grads, _, masks = encoder_f64(module, io["in"], io["grad"],
                                          prefix=name, device=dev)
            exact.update(grads)
            replayed.update(encoder_f64(module, io["in"], io["grad"],
                                        masks=io["masks"], prefix=name,
                                        device=dev)[0])
            flips += sum(int((a != b).sum())
                         for a, b in zip(masks, io["masks"]))
        return exact, replayed, flips

    w_cpu = f64(cpu)
    result = compare_grads(card[1], cpu[1], what + ", each its own fine "
                           "depths", None, False)
    result_given = compare_grads(
        given[1], cpu[1], what + ", the card given the CPU's fine depths",
        (f64(given), w_cpu), strict)
    log(f"training loss, card vs CPU: {card[0]:.6f} vs {cpu[0]:.6f}; the "
        f"fine depths differ by up to {moved:.3g}")
    return {"own": result, "given": result_given, "moved": moved,
            "losses": (card[0], cpu[0]), "io": cpu[3]["image_encoder"]}


def compare_grads(card, cpu, what, witness=None, strict=True):
    """Each parameter's gradient on the card within ``GRAD_BOUND`` of its
    norm on the CPU plus ``GRAD_FLOOR``; raises otherwise (unless not
    ``strict``). ``witness`` (for the card and for the CPU, ``grad_check``:
    the f64 gradients of the ``WITNESSED`` encoders from their output
    gradient with f64's ReLU masks, the same with its own f32 forward's
    masks, and the count of elements where the masks differ): each of
    their leaves is held instead to its witness with the card's own masks
    (the card's rounding, its ReLU flips taken out), and the two exact
    witnesses to each other (what the inputs' and output gradients'
    difference makes of it), each within ``GRAD_BOUND`` of the witness's
    norm plus ``GRAD_FLOOR``; the CPU's distances and each side's
    distance to the exact witness (its flips in) are reported.
    Returns a record: the worst relative error of a parameter whose
    gradient is above 1000 floors and its name, the leaves outside their
    bar (name -> (error, norm)), the flips, and under ``witness`` by
    witnessed leaf the relative errors (``WITNESS_COLUMNS``) and the
    norm."""
    if card.keys() != cpu.keys():
        raise RuntimeError("the card and the CPU differ in which parameters "
                           "get a gradient")
    err = {n: ((card[n] - g).norm().item(), g.norm().item())
           for n, g in cpu.items()}
    rel = {n: d / g for n, (d, g) in err.items() if g > 1e3 * GRAD_FLOOR}
    worst = max(rel, key=rel.get)
    small = max([d for d, g in err.values() if g <= 1e3 * GRAD_FLOOR] or [0])
    log(f"{what}: {len(err)} parameters, worst relative norm "
        f"{rel[worst]:.3g} ({worst}), median "
        f"{np.median(list(rel.values())):.3g} over the {len(rel)} above "
        f"{1e3 * GRAD_FLOOR:g}; largest difference under the floor "
        f"{small:.3g}")
    held, rows, flips = dict(err), {}, None
    if witness is not None:
        (exact_card, masked_card, flips_card), (exact, masked, flips_cpu) = \
            witness
        flips = (flips_card, flips_cpu)
        for n, w in exact.items():
            norm = w.norm().item()
            dist = [(card[n] - masked_card[n]).norm().item(),
                    (cpu[n] - masked[n]).norm().item(),
                    (card[n] - exact_card[n]).norm().item(),
                    (cpu[n] - w).norm().item(),
                    (exact_card[n] - w).norm().item()]
            held[n] = (max(dist[0], dist[4]), norm)
            rows[n] = tuple(x / (norm + GRAD_FLOOR)
                            for x in [err[n][0]] + dist) + (norm,)
        big = {n: r for n, r in rows.items() if r[-1] > 1e3 * GRAD_FLOOR}
        rest = {n: r for n, r in rel.items() if n not in rows}
        log(f"{what}, the ResUNets' {len(rows)} leaves against their f64 "
            f"witness (ReLU flips: card {flips_card}, CPU {flips_cpu}), "
            f"the worst over the {len(big)} above {1e3 * GRAD_FLOOR:g}: "
            + ", ".join(f"{label} {max(r[i] for r in big.values()):.3g} ("
                        f"{max(big, key=lambda n: big[n][i])})"
                        for i, label in enumerate(WITNESS_COLUMNS))
            + f"; the other leaves card vs CPU {max(rest.values()):.3g} "
            f"({max(rest, key=rest.get)})")
    bad = {n: e for n, e in held.items()
           if not e[0] <= GRAD_BOUND * e[1] + GRAD_FLOOR}
    if bad and strict:
        raise RuntimeError(f"card and CPU gradients differ: {bad}")
    return {"worst": (rel[worst], worst), "bad": bad, "flips": flips,
            "witness": rows}


def encoder_trace(encoder, dev, imgs, grad):
    """Where the image encoder turns rounding into gradient error: the
    encoder alone, run on imgs and taken back from grad on the card in
    f32, on the CPU in f32 and in f64 (``encoder_f64``), every submodule
    tapped. Returns one line per submodule in the order its forward ends:
    the relative error of its output and of its output's gradient, card
    and CPU against f64, and for an InstanceNorm the largest ratio over
    its planes of the input's RMS to its deviation (the digits its mean's
    subtraction cancels); where a ReLU follows (a block's output, a bn1's),
    the count of elements whose ReLU passes in f32 and not in f64, or the
    reverse, on the card and on the CPU."""
    from neuray_tpu_torch.models.blocks import BasicBlock, InstanceNorm
    names = [n for n, _ in encoder.named_modules() if n]
    recs = []
    for device in (dev, torch.device("cpu")):
        enc = copy.deepcopy(encoder).to(device)
        rec, handles = tap(enc, names)
        enc(imgs.to(device)).backward(grad.to(device))
        for h in handles:
            h.remove()
        recs.append(rec)
    _, r64, _ = encoder_f64(encoder, imgs, grad, names)

    def rel(rec, name, key):
        if key not in rec[name] or key not in r64[name]:
            return float("nan")
        exact = r64[name][key]
        return ((rec[name][key].cpu().double() - exact).norm()
                / (exact.norm() + 1e-300)).item()

    lines = []
    for n in r64:
        line = (f"{n}: output card {rel(recs[0], n, 'out'):.3g} cpu "
                f"{rel(recs[1], n, 'out'):.3g}; its gradient card "
                f"{rel(recs[0], n, 'grad'):.3g} cpu "
                f"{rel(recs[1], n, 'grad'):.3g}")
        mod = encoder.get_submodule(n)
        if isinstance(mod, InstanceNorm):
            x = r64[n]["in"].flatten(2)
            ratio = (x.pow(2).mean(-1).sqrt()
                     / (x.var(-1, unbiased=False) + mod.eps).sqrt())
            line += f"; input RMS / deviation up to {ratio.max().item():.3g}"
        if isinstance(mod, BasicBlock) or n.endswith("bn1"):
            exact = r64[n]["out"] > 0
            line += "; ReLU flips card {} cpu {}".format(*(
                int(((rec[n]["out"].cpu() > 0) != exact).sum())
                for rec in recs))
        lines.append(line)
    return lines


def profile_step(run_step, what="training step"):
    """One more call of ``run_step`` (a training step, say) under
    ``torch.profiler``: kernels, device busy time (the kernels' summed
    durations) and its share of the step's wall time, and the five kernel
    names with the most device time; where the profiler recorded no
    device row, the step's wall time and "not measured"."""
    from torch.profiler import ProfilerActivity, profile
    run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        # the device rows of record_function ranges (the optimizer's step)
        # span kernels counted on their own
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not by_name:
        log(f"{what} profile: {1e3 * wall:.2f} ms; torch.profiler recorded "
            f"no device rows: device busy time and idle share not measured")
        return
    busy = sum(sum(v) for v in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:5]
    log(f"{what} profile: {sum(len(v) for v in by_name.values())} "
        f"kernels, device busy {busy:.2f} ms of {1e3 * wall:.2f} ms "
        f"(idle share {1 - busy / (1e3 * wall):.3f}); most device time: "
        + "; ".join(f"{name[:60]} {sum(v) / 1e3:.2f} ms x{len(v)}"
                    for name, v in top))


def real_backward_rows(GA, dev, what, captured, size, fh, fw, parent):
    """A step's captured 64-channel map gathers (coarse, then fine: their
    points and masks) as timed backward rows (``backward_row``), each on a
    random grad_out. Returns the rows."""
    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for name, (points, mask) in zip(("coarse", "fine"), captured):
        v, p, _ = points.shape
        grad_out = torch.randn((v, p, 64), generator=g, device=dev)
        rows.append(backward_row(GA, what, f"fused, real coords, {name} pass",
                                 grad_out, points, mask, *size, fh, fw,
                                 parent))
    return rows


def keep_points(captured, points, mask):
    captured.append((points.detach().clone(), mask.detach().clone()))


def train_phase(GA, dev, root, weights, parent=None):
    """Phase 8: ``Trainer(cfg).run()`` on the card with the training
    config's fields (``TRAIN_PROFILE``) and these cuts (``TRAIN_CUTS``):
    synthetic sphere scenes in place of the 5-dataset mixture, made anew
    for every step by spawned DataLoader workers, with no augmentation;
    no vis_img dumps; 3 warm-up and 30 timed steps from the trainer's own
    init; a one-view synthetic val set at the training size. Each step is
    timed on the host clock between synchronizations and its gather
    launches counted: 6 forward (the encode's diff gather; rgb and the
    64-ch map in each of the two passes; the depth-loss head) and 3
    backward (the 64-ch map twice, the depth head's ray_feats). The loss
    must fall; the validation render runs through ``Trainer.validate``.
    The last step's two 64-ch map gathers (coarse, fine) are kept and
    timed as backward rows on their real coords (``real_backward_rows``,
    with ``parent`` as in ``backward_row``). Returns the phase's gather
    launches (forward by instantiation, and backward)."""
    from neuray_tpu_torch.models import renderer as R
    from neuray_tpu_torch.train.trainer import Trainer
    cfg = {**TRAIN_PROFILE, **TRAIN_CUTS,
           "output_root": str(root / "build" / "chip_smoke")}
    shutil.rmtree(Path(cfg["output_root"]) / cfg["name"], ignore_errors=True)
    trainer = Trainer(cfg)
    steps = []
    train_step = trainer.train_step

    def timed_step(batch):
        torch.cuda.synchronize()
        fwd, bwd = GA.LAUNCHES, GA.BACKWARD_LAUNCHES
        t0 = time.perf_counter()
        out = train_step(batch)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t0, "loss": out["loss_total"],
                      "fwd": GA.LAUNCHES - fwd,
                      "bwd": GA.BACKWARD_LAUNCHES - bwd,
                      "peak": torch.cuda.max_memory_allocated()})
        if len(steps) == WARMUP_STEPS:
            torch.cuda.reset_peak_memory_stats()
        return out

    n_steps = WARMUP_STEPS + TIMED_STEPS
    gather, captured = R.interpolate_feature_map, []
    fmap = (TRAIN_RFN, TRAIN_H // 4, TRAIN_W // 4, 64)

    def kept_gather(feats, points, mask, *args):
        if (len(steps) == n_steps - 1 and feats.requires_grad
                and tuple(feats.shape) == fmap):
            keep_points(captured, points, mask)
        return gather(feats, points, mask, *args)

    trainer.train_step = timed_step
    R.interpolate_feature_map = kept_gather
    GA.reset_launches()
    try:
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        R.interpolate_feature_map = gather
    launches = dict(GA.LAUNCHES_BY_DTYPE)
    backward = GA.BACKWARD_LAUNCHES

    losses = [s["loss"] for s in steps]
    if len(steps) != n_steps or not np.isfinite(losses).all():
        raise RuntimeError(f"training ran {len(steps)} steps, losses "
                           f"{losses}")
    bad = [(i, s["fwd"], s["bwd"]) for i, s in enumerate(steps)
           if (s["fwd"], s["bwd"]) != (6, 3)]
    if bad:
        raise RuntimeError(f"steps with other gather launches than 6 "
                           f"forward and 3 backward: {bad}")
    val_chunks = -(-TRAIN_H * TRAIN_W // TRAIN_PROFILE["ray_batch_num"])
    if launches["f32"] - 6 * n_steps != 1 + 4 * val_chunks:
        raise RuntimeError(f"validation render launched "
                           f"{launches['f32'] - 6 * n_steps} gathers, "
                           f"expected {1 + 4 * val_chunks}")
    timed = np.array([s["s"] for s in steps[WARMUP_STEPS:]])
    warmup = ", ".join(f"{s['s']:.3f}" for s in steps[:WARMUP_STEPS])
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    val = (Path(cfg["output_root"]) / cfg["name"] / "val-sphere.txt"
           ).read_text().split()
    val_psnr = float(val[val.index("psnr_nr_fine") + 1])
    log(f"training: {n_steps} steps ({WARMUP_STEPS} warm-up) of "
        f"{TRAIN_RFN} views {TRAIN_H}x{TRAIN_W}, {TRAIN_RAYS} rays, "
        f"{DN} + {DN} samples, {TRAIN_DEPTH_COORDS} depth-loss pixels a "
        f"view: step median {np.median(timed):.4f} s = "
        f"{1 / np.median(timed):.2f} steps/s (range {timed.min():.4f}-"
        f"{timed.max():.4f} s; warm-up steps {warmup}), peak memory "
        f"{steps[-1]['peak'] / 2**30:.2f} GiB, run "
        f"{wall:.1f} s with the validation; gather launches a step 6 "
        f"forward + 3 backward (expected 6 + 3), phase {launches} + "
        f"{backward} backward")
    log(f"training loss: mean of the first 10 steps {first:.5f}, of the last "
        f"10 {last:.5f}; validation ({TRAIN_RFN} views {TRAIN_H}x{TRAIN_W}) "
        f"psnr_nr_fine {val_psnr:.3f} dB: {' '.join(val[3:])}")
    if not last < first:
        raise RuntimeError(f"the loss did not fall: {first} -> {last}")
    real_backward_rows(GA, dev, "feats 1/4 res, phase 8's last step",
                       captured, (TRAIN_H, TRAIN_W), *fmap[1:3], parent)
    batch = trainer.to_device(trainer.train_dataset[TIMED_STEPS])
    profile_step(lambda: trainer.train_step(batch))
    grad_check(trainer, dev, weights)
    return launches, backward


def write_gen_checkpoint(weights, output_root, profile=GEN_PROFILE):
    """The gen model of ``profile`` with the trained weights (``weights``:
    the flax tree), saved in ``Trainer._save``'s format where
    ``FtRenderer.init_params`` and the render CLI read it."""
    from neuray_tpu_torch.selfcheck import write_gen_checkpoint as write
    write(output_root, profile, weights)


def ft_step_gathers(nv, h, w):
    """The gathers of one finetuning step from nv reference views of
    (padded) size h x w, by map (shape, takes a gradient): per pass the
    reference images, the [ray_feats | img_feats] map and the query's own
    vis-encoded ray_feats (the self-hit path)."""
    return {((nv, h, w, 3), False): 2,
            ((nv, h // 4, w // 4, 64), True): 2,
            ((1, h // 4, w // 4, 32), True): 2}



def ft_run(GA, R, trainer, what, init_gathers):
    """``trainer.run()`` (an ``FtTrainer``) instrumented and held: the init
    from the gen model timed with its gather launches (``init_gathers``:
    the depth init net's diff gather a view), each step timed on the host
    clock between synchronizations with its gather launches (6 forward:
    rgb, the 64-ch map and the self-hit map in each of the two passes; 4
    backward: the two maps that take a gradient, in each pass) and maps
    (``ft_step_gathers`` at the padded reference images' shape), held
    exactly; the run's launches held to the steps', the init's and the
    validations' (4 a chunk of each val view); every parameter finite;
    the views a step selected (and only those) changed their ray_feats.
    Returns a record: the steps, the init, the launches (forward by
    instantiation, backward), the last step's 64-ch map gathers
    (``captured``: map, points, mask, frame h, w), the validations' steps
    and per-view psnr_nr_fine, the views touched, the run's seconds."""
    ft = trainer.ft
    n_steps = trainer.cfg["total_step"]
    nv = ft.cfg["neighbor_view_num"]
    hp, wp = ft.ref_store["imgs"].shape[1:3]
    step_gathers = ft_step_gathers(nv, hp, wp)
    fmap = (nv, hp // 4, wp // 4, 64)
    init = {}
    init_params = ft.init_params

    def timed_init(*args):
        torch.cuda.synchronize()
        fwd, t0 = GA.LAUNCHES, time.perf_counter()
        init_params(*args)
        torch.cuda.synchronize()
        init.update(s=time.perf_counter() - t0, launches=GA.LAUNCHES - fwd,
                    ray_feats=ft.ray_feats.detach().clone())

    steps, counting = [], []
    train_step = trainer.train_step

    def timed_step(batch):
        ref_idx, _, que_i = batch
        torch.cuda.synchronize()
        fwd, bwd = GA.LAUNCHES, GA.BACKWARD_LAUNCHES
        counting.append({})
        t0 = time.perf_counter()
        out = train_step(batch)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t0, "loss": out["loss_total"],
                      "fwd": GA.LAUNCHES - fwd,
                      "bwd": GA.BACKWARD_LAUNCHES - bwd,
                      "maps": counting.pop(), "peak":
                      torch.cuda.max_memory_allocated(),
                      "views": {int(que_i), *map(int, ref_idx)}})
        if len(steps) == WARMUP_STEPS:
            torch.cuda.reset_peak_memory_stats()
        return out

    gather, captured = R.interpolate_feature_map, []

    def counted_gather(feats, points, mask, *args):
        if counting:
            key = (tuple(feats.shape), feats.requires_grad)
            counting[-1][key] = counting[-1].get(key, 0) + 1
            if len(steps) == n_steps - 1 and key == (fmap, True):
                captured.append((feats.detach().clone(),
                                 points.detach().clone(),
                                 mask.detach().clone(), *args[:2]))
        return gather(feats, points, mask, *args)

    views_psnr, validations = [], []
    metric = trainer.val_metrics[0]
    validate = trainer.validate

    def per_view(data_pr, *args, **kwargs):
        if not all(np.isfinite(v).all() for v in data_pr.values()):
            raise RuntimeError(f"{what} validation render is not finite")
        out = metric(data_pr, *args, **kwargs)
        views_psnr.append(float(out["psnr_nr_fine"][0]))
        return out

    def counted_validate(step):
        validations.append(step)
        return validate(step)

    ft.init_params, trainer.train_step = timed_init, timed_step
    trainer.validate = counted_validate
    trainer.val_metrics[0] = per_view
    R.interpolate_feature_map = counted_gather
    GA.reset_launches()
    try:
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        R.interpolate_feature_map = gather
        ft.init_params, trainer.train_step = init_params, train_step
        trainer.validate, trainer.val_metrics[0] = validate, metric
    launches = dict(GA.LAUNCHES_BY_DTYPE)
    backward = GA.BACKWARD_LAUNCHES

    losses = [s["loss"] for s in steps]
    if len(steps) != n_steps or not np.isfinite(losses).all():
        raise RuntimeError(f"{what} ran {len(steps)} steps, losses "
                           f"{losses}")
    bad = [(i, s["fwd"], s["bwd"], s["maps"]) for i, s in enumerate(steps)
           if (s["fwd"], s["bwd"], s["maps"]) != (6, 4, step_gathers)]
    if bad:
        raise RuntimeError(f"{what} steps with other gathers than 6 "
                           f"forward and 4 backward of {step_gathers}: {bad}")
    n_val = len(ft.val_ids)
    vh, vw = ft.val_info["imgs"].shape[1:3]
    val_chunks = -(-vh * vw // ft.render_cfg.ray_batch_num)
    expected = (init_gathers + 6 * n_steps
                + len(validations) * n_val * 4 * val_chunks)
    if (init["launches"], launches["f32"], backward) != (
            init_gathers, expected, 4 * n_steps):
        raise RuntimeError(
            f"{what} gathers: init {init['launches']}, forward "
            f"{launches['f32']}, backward {backward}; expected "
            f"{init_gathers}, {expected}, {4 * n_steps}")
    if not all(torch.isfinite(p).all() for p in ft.parameters()):
        raise RuntimeError(f"{what}: finetuned parameters are not finite")
    touched = sorted(set().union(*(s["views"] for s in steps)))
    moved = (ft.ray_feats.detach() != init["ray_feats"]).flatten(1).any(1)
    moved = set(torch.nonzero(moved).flatten().tolist())
    if moved != set(touched):
        raise RuntimeError(f"{what}: ray_feats changed in views "
                           f"{sorted(moved)}, the steps selected {touched}")
    return SimpleNamespace(
        steps=steps, init=init, launches=launches, backward=backward,
        captured=captured, validations=validations, views_psnr=views_psnr,
        touched=touched, wall=wall, step_gathers=step_gathers, fmap=fmap,
        val_hw=(vh, vw))


def ft_summary(trainer, rec, what):
    """The log lines of a finetuning run (``ft_run``'s record): its steps
    (median and range after warm-up, the warm-up's), peak memory beside a
    reckoning of the state, the launches, the loss; returns (the median
    step seconds, the last validation's psnr_nr_fine from val.txt)."""
    ft, cfg, steps = trainer.ft, trainer.cfg, rec.steps
    timed = np.array([s["s"] for s in steps[WARMUP_STEPS:]])
    warmup = ", ".join(f"{s['s']:.3f}" for s in steps[:WARMUP_STEPS])
    losses = [s["loss"] for s in steps]
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    n, (fh, fw, c) = len(ft.ref_ids), ft.ray_feats.shape[1:]
    hp, wp = ft.ref_store["imgs"].shape[1:3]
    state_gb = n * fh * fw * c * 4 / 1e9
    store_gb = sum(v.numel() * v.element_size()
                   for v in ft.ref_store.values()) / 1e9
    val = (Path(cfg["output_root"]) / cfg["name"] / "val.txt"
           ).read_text().split()
    val_psnr = float(val[len(val) - 1 - val[::-1].index("psnr_nr_fine") + 1])
    log(f"{what}: {len(steps)} steps ({WARMUP_STEPS} warm-up) of "
        f"{cfg['train_ray_num']} rays from {ft.cfg['neighbor_view_num']} of "
        f"{n} views {wp}x{hp} (padded) + the query's self-hit pass, "
        f"{ft.render_cfg.depth_sample_num} + "
        f"{ft.render_cfg.fine_depth_sample_num} samples: step median "
        f"{np.median(timed):.4f} s = {1 / np.median(timed):.2f} steps/s "
        f"(range {timed.min():.4f}-{timed.max():.4f} s; warm-up steps "
        f"{warmup}), peak memory {steps[-1]['peak'] / 2**30:.2f} GiB "
        f"(reckoning before activations: ray_feats {state_gb:.3f} GB, Adam "
        f"moments {2 * state_gb:.3f} GB, its dense gradient {state_gb:.3f} "
        f"GB, image store {store_gb:.3f} GB); run {rec.wall:.1f} s with "
        f"{len(rec.validations)} validation(s) at steps {rec.validations}; "
        f"gather launches a step 6 forward + 4 backward (expected 6 + 4; "
        f"maps {rec.step_gathers}), phase {rec.launches} + {rec.backward} "
        f"backward; ray_feats changed in exactly the {len(rec.touched)} "
        f"views the steps selected")
    log(f"{what} loss: mean of the first 10 steps {first:.5f}, of the "
        f"last 10 {last:.5f}; validation ({len(ft.val_ids)} view(s) "
        f"{rec.val_hw[1]}x{rec.val_hw[0]}) psnr_nr_fine {val_psnr:.3f} dB "
        f"at the last (by view and validation "
        f"{', '.join(f'{v:.3f}' for v in rec.views_psnr)})")
    return float(np.median(timed)), val_psnr


def ft_phase(GA, R, dev, work, weights, parent=None, profile=FT_PROFILE,
             gen_profile=GEN_PROFILE, init_gathers=None,
             write=True, what="finetuning", label="phase 9"):
    """Phase 9: ``FtTrainer(cfg).run()`` on the card with the finetuning
    config's fields (``FT_PROFILE``) and these cuts (``FT_CUTS``): a
    NeRF-synthetic sphere fabricated under ``work`` (100 train views at
    800x800 with depth maps, the 6 val views) in place of lego; the gen
    model (``GEN_PROFILE``) with the trained ``tools/bench_weights.npz``
    as its checkpoint; 3 warm-up and 30 timed steps; one validation over
    the 6 val views at the end. The run held by ``ft_run`` (gathers a
    step and by map, the init's and the validation's, ray_feats moved
    where selected) and reported by ``ft_summary``; the validation's
    psnr_nr_fine >= ``PSNR_FLOOR``; one profiled step; and one step's
    gradients card vs CPU (``ft_grad_check``). The last step's two 64-ch
    map gathers are timed as backward rows on their real coords
    (``real_backward_rows``). Returns the phase's gather launches (forward
    by instantiation, and backward), the fine pass's row and the median
    step seconds.

    Phase 11 is the same with ``profile`` FT_CV_PROFILE, ``gen_profile``
    GEN_CV_PROFILE and its weights, ``init_gathers`` 0 (the cost-volume
    init gathers nothing; by default one diff gather a reference view)
    and the scene phase 9 wrote (``write`` False).
    """
    from neuray_tpu_torch.data import database as DB
    from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
    from neuray_tpu_torch.train.ft_trainer import FtTrainer
    gc.collect()
    torch.cuda.empty_cache()
    data_root = work / "ft_data"
    t0 = time.perf_counter()
    if write:
        shutil.rmtree(data_root, ignore_errors=True)
        write_nerf_synthetic_sphere(str(data_root), FT_TRAIN_VIEWS, H,
                                    n_test=CLI_TEST_VIEWS)
    t_write = time.perf_counter() - t0
    cfg = {**profile, **FT_CUTS, "output_root": str(work)}
    shutil.rmtree(work / cfg["name"], ignore_errors=True)
    write_gen_checkpoint(weights, work, gen_profile)
    DB.DATA_ROOT = str(data_root)
    t0 = time.perf_counter()
    trainer = FtTrainer(cfg)
    t_build = time.perf_counter() - t0
    ft = trainer.ft
    rec = ft_run(GA, R, trainer, what, len(ft.ref_ids)
                 if init_gathers is None else init_gathers)
    log(f"{what}: scene written in {t_write:.1f} s ({FT_TRAIN_VIEWS} + "
        f"{len(ft.val_ids)} + 1 views {H}x{W}), FtTrainer built in "
        f"{t_build:.1f} s, ray_feats {list(ft.ray_feats.shape)} from the gen "
        f"model's init net in {rec.init['s']:.2f} s ({rec.init['launches']} "
        f"diff gathers)")
    step_s, val_psnr = ft_summary(trainer, rec, what)
    if not val_psnr >= PSNR_FLOOR:
        raise RuntimeError(f"{what} validation psnr_nr_fine "
                           f"{val_psnr:.3f} dB < {PSNR_FLOOR}")
    _, fine = real_backward_rows(
        GA, dev, f"feats 1/4 res, {label}'s last step",
        [c[1:3] for c in rec.captured], (H, W), *rec.fmap[1:3], parent)
    que_i, ref_idx = ft.sample_train_indices(np.random.RandomState(0))
    que = ft._build_que_train(ref_idx, que_i, np.random.RandomState(0))
    profile_step(lambda: trainer.train_step((ref_idx, que, que_i)),
                 f"{what} step")
    ft_grad_check(dev, work, cfg, what)
    return rec.launches, rec.backward, fine, step_s


def ft_grad_check(dev, work, cfg, what="finetuning"):
    """One finetuning step's gradients on the card and on the CPU, every
    parameter ``ray_feats`` included, from the gen model's init (read from
    the checkpoint ``write_gen_checkpoint`` wrote) on a reduced fabricated
    scene (``FT_GRAD_SCENE``, ``FT_GRAD_CHECK``), by
    ``ft_grad_compare``."""
    from neuray_tpu_torch.data import database as DB
    from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
    from neuray_tpu_torch.models.ft import FtRenderer
    root = work / "ft_grad_data"
    shutil.rmtree(root, ignore_errors=True)
    write_nerf_synthetic_sphere(str(root), **FT_GRAD_SCENE)
    DB.DATA_ROOT = str(root)
    cfg = {**cfg, **FT_GRAD_CHECK}
    cpu = FtRenderer(cfg, "cpu")
    cpu.init_params()
    ft_grad_compare(dev, cfg, cpu.state_dict(), what, (
        f"{FT_GRAD_SCENE['n_train']} views {FT_GRAD_SCENE['size']}x"
        f"{FT_GRAD_SCENE['size']}, {cfg['train_ray_num']} rays through the "
        f"sphere from {cfg['neighbor_view_num']} views, {DN} + {DN} "
        f"samples"))


def ft_step(ft, cfg, ref_idx, que_i, fine=None, encoder=False):
    """One finetuning step on ``ft`` (the query's rays from
    RandomState(1), the fine draws from a CPU generator of seed 11, as on
    every side), its fine depths replaced by ``fine`` where given.
    Returns its loss, its gradients (f64 on the CPU), its fine depths and,
    with ``encoder``, each image encoder call's input, output gradient
    and ReLU masks (``relu_tape``) on the CPU (the encoder runs on the
    reference views and on the query's for the self-hit path)."""
    from neuray_tpu_torch.train.losses import build_losses
    seen, own, calls = [], ft.net._fine_depth, []

    def fine_depth(*args):
        d = own(*args) if fine is None else fine[len(seen)].to(
            args[0].device)
        seen.append(d.detach().cpu())
        return d

    def keep(module, inputs, output):
        output.retain_grad()
        calls.append((inputs[0].detach(), output))

    ft.net._fine_depth = fine_depth
    enc = ft.net.image_encoder
    hook = enc.register_forward_hook(keep) if encoder else None
    masks, restore = relu_tape(enc) if encoder else ([], lambda: None)
    try:
        ft.zero_grad(set_to_none=True)
        que = ft._build_que_train(ref_idx, que_i, np.random.RandomState(1))
        out = ft(ref_idx, que, que_i, torch.Generator().manual_seed(11))
        losses = build_losses(cfg)(out, {})
        total = sum(v.mean() for k, v in losses.items()
                    if k.startswith("loss"))
        total.backward()
    finally:
        restore()
        if hook is not None:
            hook.remove()
        del ft.net._fine_depth
    per = len(masks) // max(len(calls), 1)
    io = [(x.cpu(), y.grad.cpu(), masks[i * per:(i + 1) * per])
          for i, (x, y) in enumerate(calls)]
    grads = {n: p.grad.cpu().double() for n, p in ft.named_parameters()
             if p.grad is not None}
    return total.item(), grads, seen, io


def ft_grad_compare(dev, cfg, state, what, scene, witness=False):
    """One finetuning step's gradients from ``state`` in ``cfg`` on the
    CPU and on the card, with the same inputs and fine draws
    (``ft_step``): each parameter within ``GRAD_BOUND`` of its norm plus
    ``GRAD_FLOOR`` (``compare_grads``) with each side's own fine depths,
    and again with the card given the CPU's. The fine sampler turns the
    coarse hit_prob's rounding into a far larger move of the fine depths
    (ROADMAP Queue 3, fault 3), which the second comparison takes out.
    ``witness`` (phase 15's padded birds): the first comparison is
    printed only, and in the second the image encoder's leaves are held,
    as phase 12 holds them, to their f64 witness with the card's own ReLU
    masks and the two exact witnesses to each other (summed over its two
    calls)."""
    from neuray_tpu_torch.models.ft import FtRenderer
    sides = {}
    for device in ("cpu", dev):
        ft = sides[str(device)] = FtRenderer(cfg, device)
        ft.set_ray_feats(state["ray_feats"])
        ft.load_state_dict(state)
    cpu, card = sides["cpu"], sides[str(dev)]
    que_i, ref_idx = cpu.sample_train_indices(np.random.RandomState(0))

    def f64(io):
        """A side's f64 witnesses of the image encoder summed over its
        calls: with f64's own ReLU masks, with the side's, and the count
        of elements where they differ."""
        enc = cpu.net.image_encoder
        exact, replayed, flips = {}, {}, 0
        for x, g, m in io:
            e, _, own_masks = encoder_f64(
                enc, x, g, prefix="net.image_encoder", device=dev)
            r = encoder_f64(enc, x, g, masks=m, prefix="net.image_encoder",
                            device=dev)[0]
            for k in e:
                exact[k] = exact.get(k, 0) + e[k]
                replayed[k] = replayed.get(k, 0) + r[k]
            flips += sum(int((a != b).sum()) for a, b in zip(own_masks, m))
        return exact, replayed, flips

    cpu_r = ft_step(cpu, cfg, ref_idx, que_i, encoder=witness)
    card_r = ft_step(card, cfg, ref_idx, que_i)
    given = ft_step(card, cfg, ref_idx, que_i, cpu_r[2], encoder=witness)
    desc = (f"{what} gradients, card vs CPU ({scene}, ray_feats "
            f"{list(state['ray_feats'].shape)})")
    compare_grads(card_r[1], cpu_r[1], desc + ", each its own fine depths",
                  None, not witness)
    moved = max((a - b).abs().max().item()
                for a, b in zip(card_r[2], cpu_r[2]))
    compare_grads(given[1], cpu_r[1],
                  desc + ", the card given the CPU's fine depths",
                  (f64(given[3]), f64(cpu_r[3])) if witness else None, True)
    log(f"{what} loss, card vs CPU: {card_r[0]:.6f} vs {cpu_r[0]:.6f}; the "
        f"fine depths differ by up to {moved:.3g}")


# phase 12: configs/train/gen/neuray_gen_depth_train.yaml through the port's
# training CLI (``neuray_tpu_torch.run_training.main``), unchanged but for
# GEN_CLI_CUTS (its step count and intervals, the DataLoader's workers, the
# output folder) and, inside the run, its two val sets cut to
# GEN_CLI_VAL_VIEWS view each. The data: one fabricated scene of each of the
# five training families at the size its reader takes for resolution_type
# hr (GSO's 250 views at 512x512; IDR's DTU at 1600x1200; LLFF originals at
# 4032x3024 reduced by 4; RealEstate10K frames at 1280x720 reduced to
# 800x450; Spaces at 800x480), 10 views each; fern (20 JPEG originals at
# 4032x3024, a COLMAP binary model, its 1008x756 cache built on first read)
# and lego (a NeRF-synthetic sphere at 800x800, GEN_CLI_LEGO_VIEWS train
# views) for validation, all under build/chip_smoke/data (NEURAY_DATA_ROOT)
GEN_CLI_CFG = "configs/train/gen/neuray_gen_depth_train.yaml"
GEN_CLI_WARMUP, GEN_CLI_STEPS = 3, 40
GEN_CLI_CUTS = dict(total_step=GEN_CLI_STEPS, val_interval=GEN_CLI_STEPS,
                    save_interval=GEN_CLI_STEPS, worker_num=6)
GEN_CLI_VAL_VIEWS = 1
GEN_CLI_DATA = dict(gso_size=512, dtu=(1200, 1600), iconic=(3024, 4032),
                    estate=(720, 1280), space=(480, 800), n=10)
FERN_VIEWS, FERN_SIZE = 20, (3024, 4032)
GEN_CLI_LEGO_VIEWS = 16
# vis_img: the gt panel's floor (35 dB, the JPEG's loss), and the whole
# image's (read 35.69-47.36 dB on phase 12's early renders, NVIDIA H100
# 80GB HBM3)
VIS_PSNR_FLOOR, VIS_WHOLE_FLOOR = 35.0, 30.0
# the clocks phase 12's gradient check draws its real-estate crops at (the
# sample's seed reads the clock); of 12 clocks from GRAD_SAMPLE_TIME
# (``--grad-sweep 12``), the three with the worst readings: +0 the card
# farthest from its f64 witness (1.61e-3), +2 the card farthest from the
# CPU (1.64e-3), +9 outside the bar with each side's own fine depths
GRAD_SAMPLE_TIME = 1_700_000_000.0
GRAD_SAMPLE_CLOCKS = tuple(GRAD_SAMPLE_TIME + k for k in (0, 2, 9))
# phase 13: configs/train/gen/neuray_gen_cost_volume_train.yaml the same
# way, CV_CLI_STEPS steps, validating on fern only
CV_CLI_CFG = "configs/train/gen/neuray_gen_cost_volume_train.yaml"
CV_CLI_STEPS = 15
CV_CLI_CUTS = dict(GEN_CLI_CUTS, total_step=CV_CLI_STEPS,
                   val_interval=CV_CLI_STEPS, save_interval=CV_CLI_STEPS)


def cut_config(src, dst, cuts):
    """src's YAML text with each top-level key of cuts set to its value
    (a scalar): its line replaced, or a line added. Returns the cut
    lines."""
    import re
    text = Path(src).read_text()
    lines = []
    for key, value in cuts.items():
        line = f"{key}: {value}"
        lines.append(line)
        pattern = re.compile(rf"^{key}:.*$", re.M)
        if pattern.search(text):
            text = pattern.sub(line, text)
        else:
            text = text.rstrip("\n") + "\n" + line + "\n"
    Path(dst).write_text(text)
    return lines


def write_cli_data(data):
    """Phase 12's scenes under data (``GEN_CLI_DATA``, fern, lego);
    returns (family -> seconds to write, and fern's and lego's)."""
    from neuray_tpu_torch.data import fabricate as FB
    from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
    shutil.rmtree(data, ignore_errors=True)
    seconds = FB.write_training_mixture(str(data), **GEN_CLI_DATA)["seconds"]
    t0 = time.perf_counter()
    FB.write_llff_colmap(str(data), n=FERN_VIEWS, h=FERN_SIZE[0],
                         w=FERN_SIZE[1])
    seconds["llff_colmap/fern"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_nerf_synthetic_sphere(str(data), GEN_CLI_LEGO_VIEWS, H, "lego")
    seconds["nerf_synthetic/lego"] = time.perf_counter() - t0
    return seconds


def sample_seconds(cfg, families, n=3):
    """The host's seconds to make one training sample of each family
    (``GeneralRendererDataset`` alone on it, in this process), the median
    of n."""
    from neuray_tpu_torch.data.train_dataset import GeneralRendererDataset
    out = {}
    for family in families:
        ds = GeneralRendererDataset(
            {**cfg, "train_database_types": [family]}, True)
        times = []
        for i in range(n):
            t0 = time.perf_counter()
            ds[i]
            times.append(time.perf_counter() - t0)
        out[family] = float(np.median(times))
    return out


SAMPLE_FAMILIES = ("dtu_train", "real_estate")


def sample_seconds_beside(parent, families=SAMPLE_FAMILIES, n=5):
    """The host's seconds a sample of each family (``sample_seconds``,
    the median of n) made by the parent checkout's data layer and by this
    one's, on phase 12's data, each in a process of its own started in
    its checkout, in turns: parent, this, this, parent. Returns the lines
    it printed."""
    here = Path(__file__).resolve().parent
    data = here / "build" / "chip_smoke" / "data"
    t0 = time.perf_counter()
    write_cli_data(data)
    log(f"phase 12 data written in {time.perf_counter() - t0:.1f} s")
    code = ("import json, sys; sys.path.insert(0, '.'); import chip_smoke as "
            "cs; from neuray_tpu_torch.utils.config import load_cfg; cfg = "
            f"load_cfg({GEN_CLI_CFG!r})['train_dataset_cfg']; print(json."
            f"dumps(cs.sample_seconds(cfg, {list(families)!r}, {n})))")
    lines = []
    for label, root in (("parent", parent), ("this", here), ("this", here),
                        ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=str(root), capture_output=True,
            text=True, env={**os.environ, "NEURAY_DATA_ROOT": str(data)})
        if proc.returncode:
            raise RuntimeError(f"{root}: {proc.stderr[-2000:]}")
        secs = json.loads(proc.stdout.strip().splitlines()[-1])
        lines.append(f"host s a sample ({label}, {root}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in secs.items()))
        log(lines[-1])
    return lines


def cli_training(GA, R, dev, cfg_path, cuts, val_keep, view_cut, what):
    """``run_training.main(["--cfg", cut copy of cfg_path])`` on the card
    with ``cuts`` (printed), its val sets cut to ``val_keep`` (names) and
    ``view_cut`` views each; every step timed on the host clock between
    synchronizations and its gather launches counted; each val view's
    outputs kept; the first 64-channel map gather that takes a gradient of
    each map shape kept (map, points, mask, frame). Returns (trainer,
    steps, launches by instantiation, backward launches, val outputs by
    set, captured gathers, the fern cache's build seconds or None, the
    run's seconds)."""
    from neuray_tpu_torch import run_training
    from neuray_tpu_torch.data.train_dataset import name2dataset
    from neuray_tpu_torch.train.trainer import Trainer
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    cut_path = work / Path(cfg_path).name
    cut_lines = cut_config(Path(__file__).resolve().parent / cfg_path,
                           cut_path, {**cuts, "output_root": str(work)})
    state = {"steps": [], "val": {}, "captured": {}, "cache_s": None}
    own_run = Trainer.run

    def run(trainer):
        state["trainer"] = trainer
        shutil.rmtree(trainer.model_dir, ignore_errors=True)
        os.makedirs(trainer.model_dir)
        trainer.cfg["val_set_list"] = [v for v in trainer.cfg["val_set_list"]
                                       if v["name"] in val_keep]
        for vs in trainer.cfg["val_set_list"]:
            t0 = time.perf_counter()
            ds = name2dataset[vs["type"]](vs.get("cfg", {}), False)
            if vs["cfg"]["val_database_name"].startswith("llff"):
                state["cache_s"] = time.perf_counter() - t0
            ds.que_ids = ds.que_ids[:view_cut]
            ds.num = len(ds.que_ids)
            trainer._val_datasets[vs["name"]] = ds
        train_step, metric = trainer.train_step, trainer.val_metrics[0]

        def timed_step(batch):
            torch.cuda.synchronize()
            fwd, bwd = GA.LAUNCHES, GA.BACKWARD_LAUNCHES
            t0 = time.perf_counter()
            out = train_step(batch)
            torch.cuda.synchronize()
            state["steps"].append({
                "s": time.perf_counter() - t0, "loss": out["loss_total"],
                "fwd": GA.LAUNCHES - fwd, "bwd": GA.BACKWARD_LAUNCHES - bwd,
                "depth_loss": "depth_loss_coords" in batch,
                "shape": tuple(batch["ref"]["imgs"].shape),
                "peak": torch.cuda.max_memory_allocated()})
            if len(state["steps"]) == GEN_CLI_WARMUP:
                torch.cuda.reset_peak_memory_stats()
            return out

        def per_view(data_pr, data_gt, step, **kwargs):
            state["val"].setdefault(kwargs["model_name"], []).append(
                (data_pr, data_gt["que_shape"]))
            return metric(data_pr, data_gt, step, **kwargs)

        trainer.train_step = timed_step
        trainer.val_metrics[0] = per_view
        return own_run(trainer)

    gather = R.interpolate_feature_map

    def kept_gather(feats, points, mask, *args):
        key = tuple(feats.shape)
        if (feats.requires_grad and key[-1] == 64
                and key not in state["captured"]):
            state["captured"][key] = (feats.detach().clone(),
                                      points.detach().clone(),
                                      mask.detach().clone(), *args[:2])
        return gather(feats, points, mask, *args)

    log(f"{what}: python -m neuray_tpu_torch.run_training --cfg {cfg_path} "
        f"with the cuts {'; '.join(cut_lines)}; val sets {list(val_keep)} "
        f"on their first {view_cut} view(s)")
    Trainer.run, R.interpolate_feature_map = run, kept_gather
    GA.reset_launches()
    try:
        t0 = time.perf_counter()
        run_training.main(["--cfg", str(cut_path)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Trainer.run, R.interpolate_feature_map = own_run, gather
    return (state["trainer"], state["steps"], dict(GA.LAUNCHES_BY_DTYPE),
            GA.BACKWARD_LAUNCHES, state["val"], state["captured"],
            state["cache_s"], wall)


def check_cli_steps(steps, n_steps, diff_gather, what):
    """Every step's gather launches: per pass the rgb and 64-ch maps, the
    depth init's diff gather (``diff_gather``), the depth-loss head where
    the sample has depth_loss_coords (GSO's); backward the 64-ch map twice
    and the head. Raises otherwise, or on a step count or loss that is
    off. Returns (median step seconds after warm-up, the launches a step
    with and without the head)."""
    losses = [s["loss"] for s in steps]
    if len(steps) != n_steps or not np.isfinite(losses).all():
        raise RuntimeError(f"{what} ran {len(steps)} steps, losses {losses}")
    bad = [(i, s["fwd"], s["bwd"], s["depth_loss"]) for i, s in
           enumerate(steps) if (s["fwd"], s["bwd"]) != (
               diff_gather + 4 + s["depth_loss"], 2 + s["depth_loss"])]
    if bad:
        raise RuntimeError(f"{what}: steps with other gather launches than "
                           f"expected: {bad}")
    return float(np.median([s["s"] for s in steps[GEN_CLI_WARMUP:]]))


def val_psnr(model_dir, name):
    val = (Path(model_dir) / f"val-{name}.txt").read_text().split()
    return float(val[val.index("psnr_nr_fine") + 1])


def check_vis(model_dir, vis_name, views, step):
    """Each val view's vis_img file of ``step`` exists and holds the
    renders within the JPEG's loss: it decodes to the pixels of the
    rendered images (gt | nr | nr_fine) put through the same codec (a
    PNG: the pixels themselves), and its ground-truth panel (smooth) lies
    within ``VIS_PSNR_FLOOR`` dB of the truth, the whole image within
    ``VIS_WHOLE_FLOOR`` dB of the renders (a JPEG's loss on an early
    model's speckled renders depends on them). Returns the worst PSNR of
    the whole images and of the gt panels."""
    from neuray_tpu_torch.train.metrics import color_map_backward
    from neuray_tpu_torch.utils.codec import decode_jpeg, encode_jpeg
    from neuray_tpu_torch.utils.imageio import imread
    worst, worst_gt = np.inf, np.inf
    for i, (data_pr, (h, w)) in enumerate(views):
        ext = "png" if (h <= 64 and w <= 64) else "jpg"
        path = (Path(model_dir) / "vis_val" / vis_name /
                f"step-{step}-index-{i}.{ext}")
        img = imread(path)
        exact = np.concatenate([color_map_backward(
            np.asarray(data_pr[k]).reshape(h, w, 3)) for k in (
                "pixel_colors_gt", "pixel_colors_nr", "pixel_colors_nr_fine")
            if k in data_pr], 1)
        coded = exact if ext == "png" else decode_jpeg(encode_jpeg(exact))
        if not np.array_equal(img, coded):
            raise RuntimeError(f"vis_img {path} does not hold the renders")
        worst = min(worst, psnr(img / 255, exact / 255))
        worst_gt = min(worst_gt, psnr(img[:, :w] / 255, exact[:, :w] / 255))
    if not worst_gt >= VIS_PSNR_FLOOR:
        raise RuntimeError(f"vis_img {vis_name}: ground truth {worst_gt:.2f}"
                           f" dB from the rendered truth < {VIS_PSNR_FLOOR}")
    if not worst >= VIS_WHOLE_FLOOR:
        raise RuntimeError(f"vis_img {vis_name}: {worst:.2f} dB from the "
                           f"renders < {VIS_WHOLE_FLOOR}")
    return worst, worst_gt


def real_coord_rows(GA, dev, captured, what, parent):
    """Forward and backward rows (``kernel_row``, ``real_backward_rows``)
    on the real coordinates of a step's first 64-ch map gather, at the
    GSO map [8, 128, 128, 64] and the forward-facing crop's
    [8, 100, 152, 64] where the run saw them (else at its first two map
    shapes). Returns (forward rows, backward rows)."""
    keys = [k for k in ((RFN, 128, 128, 64), (RFN, 100, 152, 64))
            if k in captured] or list(captured)
    fwd, bwd = [], []
    for key in keys[:2]:
        feats, points, mask, h, w = captured[key]
        fh, fw = key[1:3]
        at = GA.feature_pixel_coords(points, h, w, fh, fw,
                                     fh == h and fw == w)
        args = (feats, points, mask, h, w, None)
        fwd.append(kernel_row(
            GA, f"{what}, real coords, {h}x{w}", "f32", feats, "fused",
            (GA.gather_feature_map, *args), (GA.gather_feature_map_ref, *args),
            at, True, grid_sample_fn(feats, at)))
        bwd += real_backward_rows(GA, dev, f"{what}, {h}x{w}",
                                  [(points, mask)], (h, w), fh, fw, parent)
    return fwd, bwd


def real_estate_crop(train_cfg, clock):
    """A real-estate training sample (``GeneralRendererDataset`` of the
    mixture's ``train_cfg`` on that family alone, index 0), its seed's
    clock read as ``clock``, its rays moved onto the sphere
    (``sphere_rays``)."""
    from neuray_tpu_torch.data import train_dataset as TD
    own, TD.time = TD.time, SimpleNamespace(time=lambda: clock)
    try:
        sample = TD.GeneralRendererDataset(
            {**train_cfg, "train_database_types": ["real_estate"]}, True)[0]
    finally:
        TD.time = own
    return sphere_rays(sample, train_cfg.get("train_ray_num", 512))


def grad_sweep(dev, n, out_path):
    """``--grad-sweep N``: phase 12's gradient check alone, with the f64
    witness of the image encoder (``grad_check``), on the real-estate crops
    drawn at N clocks (``GRAD_SAMPLE_TIME`` + 0 .. N-1), on phase 12's
    data and config; none raises. One line per clock printed; every
    encoder leaf's errors, and an ``encoder_trace`` at every clock outside
    the bar and at the worst, written to out_path."""
    from neuray_tpu_torch.data import database as DB
    from neuray_tpu_torch.data import fabricate as FB
    from neuray_tpu_torch.models.renderer import NeurayRenderer
    from neuray_tpu_torch.train.trainer import Trainer
    from neuray_tpu_torch.utils.config import load_cfg
    from neuray_tpu_torch.utils.params import (
        load_flax_params, load_params_npz)
    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke"
    data = work / "data"
    shutil.rmtree(data, ignore_errors=True)
    FB.write_training_mixture(str(data), **GEN_CLI_DATA)
    os.environ["NEURAY_DATA_ROOT"] = str(data)
    DB.DATA_ROOT = str(data)
    cfg = {**load_cfg(str(root / GEN_CLI_CFG)), **GEN_CLI_CUTS,
           "output_root": str(work)}
    trainer = Trainer(cfg, dev)
    weights = load_params_npz(str(root / "tools" / "bench_weights.npz"))
    trained = NeurayRenderer(trainer.renderer.cfg)
    load_flax_params(trained, weights)
    records, out = [], []
    for k in range(n):
        clock = GRAD_SAMPLE_TIME + k
        crop = real_estate_crop(cfg["train_dataset_cfg"], clock)
        t0 = time.perf_counter()
        r = grad_check(trainer, dev, weights, crop, f"clock {clock:.0f}",
                       witness=True, strict=False)
        records.append((clock, r))
        log(f"clock {clock:.0f}: fine depths moved {r['moved']:.3g}; "
            + "; ".join(f"{key} {'outside' if r[key]['bad'] else 'inside'}"
                        f" the bar " + str({n: e[0] / e[1] for n, e in
                                            r[key]["bad"].items()})
                        for key in ("own", "given"))
            + f"; {time.perf_counter() - t0:.1f} s")
        for key in ("own", "given"):
            out.append(f"clock {clock:.0f} {key} losses {r['losses']} moved "
                       f"{r['moved']} worst {r[key]['worst']} bad "
                       f"{r[key]['bad']} flips {r[key]['flips']}")
        out.append("  leaf, " + ", ".join(WITNESS_COLUMNS) + ", norm")
        out += [f"  {n} " + " ".join(f"{x:.4g}" for x in e)
                for n, e in r["given"]["witness"].items()]
    worst = max(records, key=lambda cr: max(
        e[3] for e in cr[1]["given"]["witness"].values()
        if e[-1] > 1e3 * GRAD_FLOOR))[0]
    for clock, r in records:
        if r["own"]["bad"] or r["given"]["bad"] or clock == worst:
            out.append(f"encoder trace at clock {clock:.0f} (the CPU's output "
                       "gradient):")
            lines = encoder_trace(trained.image_encoder, dev, r["io"]["in"],
                                  r["io"]["grad"])
            out += ["  " + line for line in lines]
            if clock == worst:
                log(f"encoder trace at the worst clock {clock:.0f}:\n  "
                    + "\n  ".join(lines))
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text("\n".join(out) + "\n")


def gen_cli_phase(GA, R, dev, weights, parent=None):
    """Phase 12: generalization training through the CLI on the fabricated
    five-family mixture (``GEN_CLI_*``): the data written, the host's time
    to make one sample of each family, then ``run_training.main`` on the
    cut config (``cli_training``): 40 steps, every gather and its backward
    through the kernels (``check_cli_steps``), the validation on fern and
    lego (psnr_nr_fine; fern's cache built on first read, timed) and its
    vis_img files (``check_vis``); JPEG reads at 1008x756 and 4032x3024
    timed; one profiled step on a real-estate crop sample (idle share);
    the gradients of the crops of ``GRAD_SAMPLE_CLOCKS`` on the card
    against the CPU's and the ResUNets' against their f64 witness
    (``grad_check``; the witness taken on the card, held to the CPU's on
    the first crop by ``witness_device_check``); the real-coordinate
    kernel rows
    (``real_coord_rows``). Returns (launches by instantiation, backward
    launches, forward rows, backward rows, the median step seconds)."""
    from neuray_tpu_torch.data import database as DB
    from neuray_tpu_torch.utils.codec import read_jpeg
    gc.collect()
    torch.cuda.empty_cache()
    data = Path(__file__).resolve().parent / "build" / "chip_smoke" / "data"
    seconds = write_cli_data(data)
    os.environ["NEURAY_DATA_ROOT"] = str(data)     # the spawned workers'
    DB.DATA_ROOT = str(data)
    log("phase 12 data: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                      seconds.items())
        + f" to write ({GEN_CLI_DATA}; fern {FERN_VIEWS} views "
        f"{FERN_SIZE[1]}x{FERN_SIZE[0]}; lego {GEN_CLI_LEGO_VIEWS} train "
        f"views {H}x{W})")
    from neuray_tpu_torch.utils.config import load_cfg
    train_cfg = load_cfg(str(Path(__file__).resolve().parent /
                             GEN_CLI_CFG))["train_dataset_cfg"]
    families = train_cfg["train_database_types"]
    host = sample_seconds(train_cfg, families)
    log("host seconds to make one training sample (median of 3, one "
        "process): " + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))

    trainer, steps, launches, backward, val, captured, cache_s, wall = \
        cli_training(GA, R, dev, GEN_CLI_CFG, GEN_CLI_CUTS,
                     ("llff_fern", "nerf_lego"), GEN_CLI_VAL_VIEWS,
                     "phase 12")
    step_s = check_cli_steps(steps, GEN_CLI_STEPS, 1, "gen training")
    timed = np.array([s["s"] for s in steps[GEN_CLI_WARMUP:]])
    shapes = sorted({s["shape"] for s in steps})
    fern_psnr = val_psnr(trainer.model_dir, "llff_fern")
    lego_psnr = val_psnr(trainer.model_dir, "nerf_lego")
    vis = {k: check_vis(trainer.model_dir, k, v, GEN_CLI_STEPS)
           for k, v in val.items()}
    fern_dir = data / "llff_colmap" / "fern"
    jpeg_ms = {}
    for name, path in (("1008x756", next((fern_dir / "cache" / "high")
                                         .iterdir())),
                       ("4032x3024", next((fern_dir / "images").iterdir()))):
        read_jpeg(path)
        t0 = time.perf_counter()
        for _ in range(3):
            read_jpeg(path)
        jpeg_ms[name] = 1e3 * (time.perf_counter() - t0) / 3
    n_depth = sum(s["depth_loss"] for s in steps)
    log(f"phase 12 training: {GEN_CLI_STEPS} steps ({GEN_CLI_WARMUP} warm-up)"
        f" on the mixture, ref shapes {shapes}: step median {step_s:.4f} s = "
        f"{1 / step_s:.2f} steps/s (range {timed.min():.4f}-{timed.max():.4f}"
        f" s), peak memory {steps[-1]['peak'] / 2**30:.2f} GiB, run "
        f"{wall:.1f} s with the validation; gather launches a step "
        f"6 forward + 3 backward with the depth-loss head ({n_depth} GSO "
        f"steps), 5 + 2 without; phase {launches} + {backward} backward")
    log(f"phase 12 validation ({GEN_CLI_VAL_VIEWS} view each): fern "
        f"psnr_nr_fine {fern_psnr:.3f} dB (cache/high built in "
        f"{cache_s:.1f} s on first read), lego {lego_psnr:.3f} dB; vis_img "
        f"files hold the renders through the codec, PSNR to them (whole, "
        f"gt panel) " + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f} dB"
                                  for k, v in vis.items())
        + f"; JPEG reads {jpeg_ms['1008x756']:.1f} ms at "
        f"1008x756, {jpeg_ms['4032x3024']:.1f} ms at 4032x3024")
    crops = [real_estate_crop(train_cfg, c) for c in GRAD_SAMPLE_CLOCKS]
    batch = trainer.to_device(crops[0])
    profile_step(lambda: trainer.train_step(batch),
                 "phase 12 step on a real-estate crop")
    for clock, crop in zip(GRAD_SAMPLE_CLOCKS, crops):
        r = grad_check(trainer, dev, weights, crop,
                       f"training gradients, card vs CPU (a real-estate crop "
                       f"sample drawn at clock {clock:.0f}: "
                       f"{list(crop['ref']['imgs'].shape)} ref views, "
                       f"{crop['que']['coords'].shape[1]} rays through the "
                       f"sphere, {DN} + {DN} samples)", witness=True)
        if clock == GRAD_SAMPLE_CLOCKS[0]:
            witness_device_check(dev, trainer.renderer.cfg, weights, r["io"])
    fwd, bwd = real_coord_rows(GA, dev, captured, "phase 12", parent)
    return launches, backward, fwd, bwd, step_s


def cv_cli_phase(GA, R, dev):
    """Phase 13: cost-volume generalization training through the CLI
    (``CV_CLI_*``) on phase 12's data, validating on fern: steps/s, the
    cost-volume init net's share of a step (CUDA-event spans), gather
    launches checked as in phase 12 (no diff gather), psnr_nr_fine and the
    vis_img files. Returns (launches by instantiation, backward
    launches)."""
    gc.collect()
    torch.cuda.empty_cache()
    init_spans = []
    from neuray_tpu_torch.models.cost_volume import CostVolumeInitNet
    own_forward = CostVolumeInitNet.forward

    def timed_init(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = own_forward(self, *args, **kwargs)
        end.record()
        if self.training:
            init_spans.append((start, end))
        return out

    CostVolumeInitNet.forward = timed_init
    try:
        trainer, steps, launches, backward, val, _, _, wall = cli_training(
            GA, R, dev, CV_CLI_CFG, CV_CLI_CUTS, ("llff_fern",),
            GEN_CLI_VAL_VIEWS, "phase 13")
    finally:
        CostVolumeInitNet.forward = own_forward
    step_s = check_cli_steps(steps, CV_CLI_STEPS, 0, "cost-volume training")
    torch.cuda.synchronize()
    init_ms = [a.elapsed_time(b) for a, b in init_spans]
    timed = np.array([s["s"] for s in steps[GEN_CLI_WARMUP:]])
    share = np.median(init_ms[GEN_CLI_WARMUP:len(steps)]) / (1e3 * step_s)
    fern_psnr = val_psnr(trainer.model_dir, "llff_fern")
    vis = {k: check_vis(trainer.model_dir, k, v, CV_CLI_STEPS)
           for k, v in val.items()}
    log(f"phase 13 training: {CV_CLI_STEPS} steps ({GEN_CLI_WARMUP} warm-up)"
        f": step median {step_s:.4f} s = {1 / step_s:.2f} steps/s (range "
        f"{timed.min():.4f}-{timed.max():.4f} s), cost-volume init net "
        f"median {np.median(init_ms[GEN_CLI_WARMUP:len(steps)]):.1f} ms a "
        f"step (share {share:.3f} of the step), peak memory "
        f"{steps[-1]['peak'] / 2**30:.2f} GiB, run {wall:.1f} s; phase "
        f"{launches} + {backward} backward; fern psnr_nr_fine "
        f"{fern_psnr:.3f} dB, vis_img (whole, gt panel) "
        + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f} dB"
                    for k, v in vis.items()))
    return launches, backward


# phase 14: the render and eval CLIs on phase 9's scene (its 800x800
# sphere, 100 train views with depth maps and CLI_TEST_VIEWS test views)
CLI_DATABASE = "nerf_synthetic/sphere/black_800"
CLI_RAY_NUM = 4096            # the render CLI's default --ray_num
CLI_EXACT_FRAMES = 1
CLI_FAST_FRAMES = 2
CLI_FT_POSES = "inter_8"      # its first pose is the first train view's
# the floor of the gen frames' GT-PSNR: with the trained weights this
# scene's eval views render at 19.6-22.4 dB through the CLI (the 8
# nearest of 100 views at lego's field of view, the NeRF-synthetic
# database's depth range (2, 6)), below phase 4's 26.1 dB on its own
# view; a broken route lands far lower. The FT frame, from phase 9's
# finetuned model, is held to PSNR_FLOOR.
CLI_GEN_PSNR_FLOOR = 18.0


def cli_recorder(GA, R, RC):
    """Wrap the render CLI's ``save_renderings``, ``imwrite`` and the
    scene encode to record, for each frame it saves: its outputs, the
    gather launches by instantiation and the encodes since the run began
    (``GA.reset_launches`` at its start), and its seconds since the last
    frame; and each encode's and each JPEG's time. Returns (the record,
    a function that restores the wrapped three)."""
    rec = {}
    save, imwrite, encode = RC.save_renderings, RC.imwrite, R.encode_ref

    def timed_encode(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode(*args, **kw)
        torch.cuda.synchronize()
        rec["encode_s"].append(time.perf_counter() - t0)
        return out

    def timed_imwrite(path, img):
        t0 = time.perf_counter()
        imwrite(path, img)
        if str(path).endswith(".jpg"):
            rec["jpeg_ms"].append(1e3 * (time.perf_counter() - t0))

    def recorded_save(output_dir, qi, out, h, w):
        torch.cuda.synchronize()
        save(output_dir, qi, out, h, w)
        now = time.perf_counter()
        rec["frames"].append({
            "qi": qi, "out": out, "s": now - rec["t"],
            "launches": dict(GA.LAUNCHES_BY_DTYPE),
            "encodes": len(rec["encode_s"])})
        rec["t"] = now

    RC.save_renderings, RC.imwrite, R.encode_ref = (
        recorded_save, timed_imwrite, timed_encode)

    def restore():
        RC.save_renderings, RC.imwrite, R.encode_ref = save, imwrite, encode

    return rec, restore


def cli_run(GA, RC, rec, args):
    """``python -m neuray_tpu_torch.render`` with args (in this process,
    so that its launches are counted); returns the run's seconds, its
    frames and the gather launches by instantiation."""
    GA.reset_launches()
    torch.cuda.synchronize()
    rec.update(frames=[], encode_s=[], jpeg_ms=[], t=time.perf_counter())
    t0 = rec["t"]
    RC.main(["--database_name", CLI_DATABASE, "--ray_num", str(CLI_RAY_NUM),
             *args])
    torch.cuda.synchronize()
    frames, last = [], {"f32": 0, "bf16": 0, "u8": 0}
    for f in rec["frames"]:     # per frame: the launches since the last one
        frames.append({**f, "launches": {k: f["launches"][k] - last[k]
                                         for k in last}})
        last = f["launches"]
    return time.perf_counter() - t0, frames, dict(GA.LAUNCHES_BY_DTYPE)


def same_jpeg(path, out, key, what):
    """The CLI's file at path against the direct driver's frame: equal
    bytes (the encoder is deterministic, so equal uint8 images)."""
    from neuray_tpu_torch.models.renderer import _host
    from neuray_tpu_torch.train.metrics import color_map_backward
    from neuray_tpu_torch.utils.codec import encode_jpeg
    img = color_map_backward(_host(out[key]).reshape(H, W, 3))
    if Path(path).read_bytes() != encode_jpeg(img):
        raise RuntimeError(f"{what}: {path} is not the direct driver's "
                           f"{key} frame")


def cli_phase(GA, R, dev, work, weights):
    """Phase 14: the render and eval CLIs on the card at full width, on
    phase 9's scene (``work/ft_data``) with the trained weights as the
    gen checkpoint (``cli/data/model/neuray_gen_depth/ckpt.pt``, read
    through ``load_ckpt_name`` by the fast profile):
    ``configs/gen/neuray_gen_depth.yaml`` on the first
    ``CLI_EXACT_FRAMES`` eval views, ``neuray_gen_depth_fast.yaml``
    (auto_focus, its audit log) on ``CLI_FAST_FRAMES``, and ``--render_type
    ft`` on the first pose of ``CLI_FT_POSES`` from phase 9's finetuned
    checkpoint; each frame's JPEGs equal to the same driver called
    directly on the same pose, refs and weights; each frame's gather
    launches held to what its chunk counts imply, f32 only, and one
    encode a ref set; a rerun resumes (renders only the frame whose file
    was removed) and rewrites the audit log; ``python -m
    neuray_tpu_torch.eval`` on the exact and fast frames, its PSNR equal
    to ``compute_psnr`` of the files and >= ``CLI_GEN_PSNR_FLOOR``, the FT
    frame's against its train view >= ``PSNR_FLOOR``; then both
    self-checks (``neuray_tpu_torch/selfcheck.py``). Returns the CLI runs'
    gather launches by instantiation."""
    from neuray_tpu_torch import eval as E
    from neuray_tpu_torch import render as RC
    from neuray_tpu_torch.data import database as DB
    from neuray_tpu_torch.data.imgs_info import (
        build_imgs_info, build_render_imgs_info)
    from neuray_tpu_torch.data.render_poses import get_render_poses
    from neuray_tpu_torch.data.view_select import (
        select_working_views, select_working_views_db)
    from neuray_tpu_torch.models import ft as FT
    from neuray_tpu_torch.selfcheck import (
        selfcheck_ft, selfcheck_render, write_cfg)
    from neuray_tpu_torch.train.metrics import compute_psnr
    from neuray_tpu_torch.utils.config import load_cfg
    from neuray_tpu_torch.utils.imageio import imread_color
    from neuray_tpu_torch.utils.params import load_flax_params
    gc.collect()
    torch.cuda.empty_cache()
    repo = Path(__file__).resolve().parent
    cli = work / "cli"
    shutil.rmtree(cli, ignore_errors=True)
    cli.mkdir(parents=True)
    write_gen_checkpoint(weights, cli / "data" / "model", GEN_PROFILE)
    ft_cfg = {**FT_PROFILE, **FT_CUTS, "output_root": str(work)}
    ft_cfg_path = write_cfg(cli / "ft.yaml", ft_cfg)
    exact_cfg = load_cfg(str(repo / "configs" / "gen" /
                              "neuray_gen_depth.yaml"))
    fast_cfg = load_cfg(str(repo / "configs" / "gen" /
                             "neuray_gen_depth_fast.yaml"))
    root, cwd = DB.DATA_ROOT, os.getcwd()
    DB.DATA_ROOT = str(work / "ft_data")
    os.chdir(cli)
    rec, restore = cli_recorder(GA, R, RC)
    n_rays = H * W
    chunks = -(-n_rays // CLI_RAY_NUM)
    stride = fast_cfg["probe_stride"]
    n_probe = -(-H // stride) * -(-W // stride)
    render_dir = Path("data/render") / CLI_DATABASE.replace("/", "_")
    gt_dir = render_dir / "gt"
    total = {"f32": 0, "bf16": 0, "u8": 0}
    try:
        runs = {}
        for what, cfg, args in (
                ("exact", exact_cfg, ["--cfg", str(repo / "configs" / "gen" /
                                                   "neuray_gen_depth.yaml"),
                                      "--re", str(CLI_EXACT_FRAMES)]),
                ("fast", fast_cfg, ["--cfg", str(
                    repo / "configs" / "gen" / "neuray_gen_depth_fast.yaml"),
                    "--re", str(CLI_FAST_FRAMES)]),
                ("ft", ft_cfg, ["--cfg", ft_cfg_path, "--render_type", "ft",
                                "--pose_type", CLI_FT_POSES, "--re", "1"])):
            runs[what] = cli_run(GA, RC, rec, args)
            runs[what] += (list(rec["encode_s"]), list(rec["jpeg_ms"]))
            for k in total:
                total[k] += runs[what][2][k]
            seconds, frames, launches, encode_s, jpeg_ms = runs[what]
            frame_s = ", ".join(f"{f['s']:.3f}" for f in frames)
            log(f"CLI {what} ({cfg['name']}): {len(frames)} frames "
                f"{H}x{W} in {seconds:.2f} s, s a frame {frame_s} (encodes "
                f"and JPEG writes in), encodes {len(encode_s)} "
                f"({', '.join(f'{t:.3f}' for t in encode_s)} s), JPEG write "
                f"ms at {H}x{W} {', '.join(f'{t:.1f}' for t in jpeg_ms)}, "
                f"gather launches {launches}")
            if launches["bf16"] or launches["u8"]:
                raise RuntimeError(f"CLI {what} launched {launches}")
            prev = 0
            for f in frames:
                encoded = f["encodes"] - prev
                prev = f["encodes"]
                if what == "fast":
                    expected = expected_fast_launches(
                        f["out"], n_rays, n_probe, CLI_RAY_NUM) - 1 + encoded
                else:
                    expected = 4 * chunks + (encoded if what == "exact" else 0)
                if f["launches"]["f32"] != expected or encoded > 1:
                    raise RuntimeError(
                        f"CLI {what} frame {f['qi']}: {f['launches']} gather "
                        f"launches and {encoded} encodes, expected "
                        f"{expected} f32 and at most one encode")

        # each frame against its driver called directly
        database = DB.parse_database_name(CLI_DATABASE)
        ref_ids_all = [i for i in database.get_img_ids(True)
                       if i.startswith("tr")]
        test_ids = [i for i in database.get_img_ids() if i.startswith("te")]
        audit = [json.loads(line) for line in (
            render_dir / "neuray_gen_depth_fast-eval" / "auto_audit.jsonl"
        ).read_text().splitlines()]
        fallback = False
        for what, cfg, n in (("exact", exact_cfg, CLI_EXACT_FRAMES),
                             ("fast", fast_cfg, CLI_FAST_FRAMES)):
            renderer = R.NeurayRenderer(R.RenderConfig.from_cfg(
                {**cfg, "ray_batch_num": CLI_RAY_NUM}))
            load_flax_params(renderer, weights)
            renderer = renderer.to(dev).eval()
            for qi, img_id in enumerate(test_ids[:n]):
                pose = database.get_pose(img_id).astype(np.float32)
                refs = select_working_views_db(database, ref_ids_all,
                                               pose[None], 8)[0]
                ref = {k: torch.from_numpy(v).to(dev) for k, v in
                       build_imgs_info(database, list(refs), 16, True,
                                       replace_none_depth=True).items()}
                que = build_render_imgs_info(
                    pose, database.get_K(img_id), (H, W),
                    database.get_depth_range(img_id))
                que.pop("shape")
                que = {k: torch.from_numpy(v).to(dev) for k, v in que.items()}
                ref_c = R.encode_ref(renderer, ref)
                if what == "exact":
                    out = R.render_rays(renderer, ref_c, que,
                                        ("pixel_colors_nr",
                                         "pixel_colors_nr_fine"))
                elif fallback:
                    out = R.render_frame_skip_empty(
                        renderer, ref_c, que,
                        threshold=cfg["skip_empty_threshold"])
                else:
                    start = R._with_probe_sample_num(
                        renderer, audit[qi]["audit_trail"][0][
                            "probe_sample_num"])
                    out = R.render_frame_probe_auto(
                        start, ref_c, que,
                        threshold=cfg["skip_empty_threshold"],
                        image_hw=(H, W), dilate=cfg["probe_dilate"],
                        focus=True, tol=cfg["skip_auto_tol"],
                        probe_stride=cfg["probe_stride"])
                    fallback = out["fallback"] is not None
                for key in ("pixel_colors_nr", "pixel_colors_nr_fine"):
                    same_jpeg(render_dir / f"{cfg['name']}-eval" /
                              f"{qi}-{key[len('pixel_colors_'):]}.jpg",
                              out, key, f"CLI {what} frame {qi}")
            del renderer
        ft = FT.FtRenderer({**ft_cfg, "ray_batch_num": CLI_RAY_NUM}, dev)
        params = FT.load_gen_state(ft_cfg["output_root"], ft_cfg["name"])
        ft.set_ray_feats(params["ray_feats"])
        ft.load_state_dict(params)
        pose = get_render_poses(ft.database, CLI_FT_POSES)[0]
        ref_idx = select_working_views(np.asarray(ft.ref_info["poses"]),
                                       pose[None],
                                       ft.cfg["neighbor_view_num"], True)[0]
        idx = torch.from_numpy(ref_idx).to(dev)
        ref = ft._slice_ref(idx)
        ref["ray_feats_raw"] = ft.ray_feats.detach().index_select(0, idx)
        k0 = ft.database.get_img_ids()[0]
        que = build_render_imgs_info(pose, ft.database.get_K(k0), (H, W),
                                     ft.ref_info["depth_range"][0])
        que.pop("shape")
        que = {k: torch.from_numpy(v).to(dev) for k, v in que.items()}
        out = FT.make_ft_render_fn(ft)(ref, que)
        ft_dir = render_dir / f"{ft_cfg['name']}-{CLI_FT_POSES}"
        for key in ("pixel_colors_nr", "pixel_colors_nr_fine"):
            same_jpeg(ft_dir / f"0-{key[len('pixel_colors_'):]}.jpg", out,
                      key, "CLI ft frame 0")
        ft_psnr = compute_psnr(ft.database.get_image(k0),
                               imread_color(ft_dir / "0-nr_fine.jpg"))
        del ft
        log(f"CLI frames equal the drivers' called directly: "
            f"{CLI_EXACT_FRAMES} exact, {CLI_FAST_FRAMES} fast, 1 ft (its "
            f"JPEG against train view {k0}: {ft_psnr:.3f} dB)")
        if not ft_psnr >= PSNR_FLOOR:
            raise RuntimeError(f"CLI ft frame GT-PSNR {ft_psnr:.3f} dB < "
                               f"{PSNR_FLOOR}")

        # resume: only the frame whose file is gone, the audit log anew
        (render_dir / "neuray_gen_depth_fast-eval" /
         f"{CLI_FAST_FRAMES - 1}-nr_fine.jpg").unlink()
        seconds, frames, launches = cli_run(GA, RC, rec, [
            "--cfg", str(repo / "configs" / "gen" /
                         "neuray_gen_depth_fast.yaml"),
            "--re", str(CLI_FAST_FRAMES)])
        for k in total:
            total[k] += launches[k]
        again = [json.loads(line)["frame"] for line in (
            render_dir / "neuray_gen_depth_fast-eval" / "auto_audit.jsonl"
        ).read_text().splitlines()]
        if [f["qi"] for f in frames] != [CLI_FAST_FRAMES - 1] or \
                again != [CLI_FAST_FRAMES - 1]:
            raise RuntimeError(f"CLI rerun rendered "
                               f"{[f['qi'] for f in frames]}, audit log "
                               f"frames {again}")
        log(f"CLI rerun: resumed, rendered frame {CLI_FAST_FRAMES - 1} alone "
            f"in {seconds:.2f} s, audit log rewritten ({again})")

        for what, name in (("exact", "neuray_gen_depth-eval"),
                           ("fast", "neuray_gen_depth_fast-eval")):
            t0 = time.perf_counter()
            scores = E.evaluate(str(render_dir / name), str(gt_dir),
                                "nr_fine", dev)
            t_eval = time.perf_counter() - t0
            want = [compute_psnr(imread_color(gt_dir / f"{qi}.jpg"),
                                 imread_color(render_dir / name /
                                              f"{qi}-nr_fine.jpg"))
                    for qi in range(len(scores["psnr"]))]
            log(f"CLI eval ({what}): {len(want)} frames in {t_eval:.3f} s, "
                f"GT-PSNR {', '.join(f'{p:.3f}' for p in scores['psnr'])} "
                f"dB, SSIM {', '.join(f'{p:.4f}' for p in scores['ssim'])}")
            if scores["psnr"] != want or len(want) < CLI_EXACT_FRAMES:
                raise RuntimeError(f"eval CLI PSNR {scores['psnr']}, the "
                                   f"files' {want}")
            if not min(want) >= CLI_GEN_PSNR_FLOOR:
                raise RuntimeError(f"CLI {what} GT-PSNR {min(want):.3f} dB "
                                   f"< {CLI_GEN_PSNR_FLOOR}")
    finally:
        restore()
        os.chdir(cwd)
        DB.DATA_ROOT = root
    t0 = time.perf_counter()
    selfcheck_render(work / "selfcheck" / "render", 64, dev)
    selfcheck_ft(work / "selfcheck" / "ft", 64, 20, dev)
    log(f"self-checks (neuray_tpu_torch/selfcheck.py, 64x64): "
        f"{time.perf_counter() - t0:.2f} s")
    return total


# ---------------- phases 15-17 ----------------

# phase 15a: configs/train/gen/neuray_gen_depth_train_fast.yaml (the depth
# init net's diff gather on the half grid) through the training CLI on
# phase 12's data, cut as phase 12 (GEN_CLI_CUTS) at FAST_CLI_STEPS steps
FAST_CLI_CFG = "configs/train/gen/neuray_gen_depth_train_fast.yaml"
FAST_CLI_STEPS = 20
FAST_CLI_CUTS = dict(GEN_CLI_CUTS, total_step=FAST_CLI_STEPS,
                     val_interval=FAST_CLI_STEPS,
                     save_interval=FAST_CLI_STEPS)
# phase 15b: the shipped finetuning configs outside NeRF-synthetic, each on
# a scene fabricated at its reader's real size (data/fabricate.py), from
# the gen model (the trained tools/bench_weights.npz as its checkpoint).
# (name, config, writer, its arguments): birds, 20 LLFF originals
# 4032x3024 read at 1008x756 and padded to 1008x768; fern in the DTU-test
# layout, 49 views 1600x1200 read at 800x600 and padded to 800x608;
# desktop in the example layout, 40 views 1280x720 (a 720p phone frame;
# the reader does not resize), split example_3. The cuts: 3 + 6 steps
# (of 200,000), the validations (the initial one the configs ask for on
# birds alone, FT_DB_INITIAL_VALIDATION, and one at the end) on the first
# of the val views; the gen config's path made absolute
FT_DB_SCENES = (
    ("birds", "configs/train/ft/neuray_ft_depth_birds.yaml",
     "write_llff_colmap", dict(name="birds", n=20, h=3024, w=4032)),
    ("fern", "configs/train/ft/neuray_ft_depth_fern.yaml",
     "write_dtu_test", dict(name="fern", n=49, h=1200, w=1600)),
    ("desktop", "configs/train/ft/example/neuray_ft_desktop_pretrain.yaml",
     "write_example", dict(name="desktop", n=40, h=720, w=1280)))
FT_DB_STEPS = WARMUP_STEPS + 6
FT_DB_CUTS = dict(total_step=FT_DB_STEPS, val_interval=FT_DB_STEPS,
                  train_log_step=10)
# the initial validation the configs ask for runs on birds alone (the
# others' is cut for the run's time, ~8 s each)
FT_DB_INITIAL_VALIDATION = ("birds",)
FT_DB_VAL_VIEWS = 1
# the card-vs-CPU check of one birds step: FT_GRAD_CHECK's rays on 2
# reference views (the CPU steps the padded 1008x768 maps)
FT_DB_GRAD_CHECK = dict(FT_GRAD_CHECK, neighbor_view_num=2)
# phase 17: the direct-rendering branch on phase 4's frame; its colours
# card vs CPU within the CPU test's bound (tests/test_torch_port_dr.py:
# the SH fit's f32 inverse, 5e-4 in max and 1e-4 in mean)
DR_KEEP = ("pixel_colors_nr", "pixel_colors_nr_fine", "pixel_colors_dr",
           "pixel_colors_dr_fine")
DR_BOUND, DR_MEAN_BOUND = 5e-4, 1e-4


# phase 15a validates on fern alone: lego's validation of this config is
# not run (phase 12 validates the default training config on both)
FAST_CLI_VAL_SETS = ("llff_fern",)


def fast_cli_phase(GA, R, dev, gen_step_s, parent=None):
    """Phase 15a: the fast training config through the CLI (``FAST_CLI_*``)
    on phase 12's data (written, ``NEURAY_DATA_ROOT`` set): every step's
    gathers held (``check_cli_steps``), each step's diff gather on the
    half grid of that step's reference images ([rfn, ceil(h/2),
    ceil(w/2), 4]), steps/s beside phase 12's, a profiled step, the
    validation's psnr_nr_fine on fern; the half-grid diff gather of a 400x608 crop
    ([8, 200, 304, 4]) timed on its real coordinates (``kernel_row``),
    and the 64-ch map's rows (``real_coord_rows``). Returns (launches by
    instantiation, backward launches, forward rows, backward rows)."""
    from neuray_tpu_torch.models import init_net as N
    gc.collect()
    torch.cuda.empty_cache()
    diff, kept, own = [], {}, N.gather_bilinear_border

    def seen(feats, pts):
        diff.append(tuple(feats.shape))
        kept.setdefault(tuple(feats.shape), (feats.detach().clone(),
                                             pts.detach().clone()))
        return own(feats, pts)

    N.gather_bilinear_border = seen
    try:
        trainer, steps, launches, backward, val, captured, _, wall = \
            cli_training(GA, R, dev, FAST_CLI_CFG, FAST_CLI_CUTS,
                         FAST_CLI_VAL_SETS, GEN_CLI_VAL_VIEWS, "phase 15a")
    finally:
        N.gather_bilinear_border = own
    step_s = check_cli_steps(steps, FAST_CLI_STEPS, 1, "fast training")
    want = [(v, -(-h // 2), -(-w // 2), 4) for v, h, w, _ in
            (s["shape"] for s in steps)]
    if diff[:len(steps)] != want:
        raise RuntimeError(f"phase 15a diff gathers on maps "
                           f"{diff[:len(steps)]}, the half grids {want}")
    timed = np.array([s["s"] for s in steps[GEN_CLI_WARMUP:]])
    fern_psnr = val_psnr(trainer.model_dir, "llff_fern")
    log(f"phase 15a training ({FAST_CLI_CFG}): {FAST_CLI_STEPS} steps "
        f"({GEN_CLI_WARMUP} warm-up) on the mixture: step median "
        f"{step_s:.4f} s = {1 / step_s:.2f} steps/s (range "
        f"{timed.min():.4f}-{timed.max():.4f} s) beside phase 12's "
        f"{1 / gen_step_s:.2f} steps/s in this run, peak memory "
        f"{steps[-1]['peak'] / 2**30:.2f} GiB, run {wall:.1f} s; every "
        f"step's diff gather on its half grid (maps "
        f"{sorted(set(want))}); phase {launches} + {backward} backward; "
        f"validation psnr_nr_fine fern {fern_psnr:.3f} dB")
    from neuray_tpu_torch.utils.config import load_cfg
    train_cfg = load_cfg(str(Path(__file__).resolve().parent /
                             FAST_CLI_CFG))["train_dataset_cfg"]
    batch = trainer.to_device(real_estate_crop(train_cfg,
                                               GRAD_SAMPLE_CLOCKS[0]))
    profile_step(lambda: trainer.train_step(batch),
                 "phase 15a fast training step on a real-estate crop")
    key = next((k for k in kept if k[1:3] == (TRAIN_H // 2, TRAIN_W // 2)),
               next(iter(kept)))
    feats, pts = kept[key]
    fwd = [kernel_row(
        GA, "phase 15a half-grid diff gather, real coords", "f32", feats,
        "map pixels", (GA.gather_bilinear_border, feats, pts),
        (GA.gather_bilinear_border_ref, feats, pts), pts, False,
        grid_sample_fn(feats, pts))]
    more_fwd, bwd = real_coord_rows(GA, dev, captured, "phase 15a", parent)
    return launches, backward, fwd + more_fwd, bwd


def ft_db_phase(GA, R, dev, work, weights, ft_step_s, parent=None):
    """Phase 15b: each of ``FT_DB_SCENES`` written at its real size under
    ``work`` (timed), then ``FtTrainer(cfg).run()`` with the shipped
    config and ``FT_DB_CUTS``, held by ``ft_run`` (6 forward and 4
    backward gathers a step by map, at the padded shape; the init's diff
    gathers; the validations'; ray_feats moved in exactly the selected
    views) and reported by ``ft_summary``, steps/s beside phase 9's, the
    validation's psnr_nr_fine printed (no floor: the gen weights were
    trained on other scenes), a profiled step, the step's real 64-ch map
    gather timed forward and backward (``real_coord_rows``); on birds one
    step's gradients card vs CPU (``ft_grad_compare``). Returns
    (launches by instantiation, backward launches, forward rows, backward
    rows)."""
    from neuray_tpu_torch.data import database as DB
    from neuray_tpu_torch.data import fabricate as FB
    from neuray_tpu_torch.train.ft_trainer import FtTrainer
    from neuray_tpu_torch.utils.config import load_cfg
    repo = Path(__file__).resolve().parent
    total, backward, fwd, bwd = {"f32": 0, "bf16": 0, "u8": 0}, 0, [], []
    write_gen_checkpoint(weights, work, GEN_PROFILE)
    for name, cfg_path, writer, kwargs in FT_DB_SCENES:
        gc.collect()
        torch.cuda.empty_cache()
        what = f"phase 15 finetuning {name}"
        data = work / "ft_db_data"
        shutil.rmtree(data, ignore_errors=True)
        t0 = time.perf_counter()
        getattr(FB, writer)(str(data), **kwargs)
        t_write = time.perf_counter() - t0
        cfg = load_cfg(str(repo / cfg_path))
        cfg.update(FT_DB_CUTS, gen_cfg=str(repo / cfg["gen_cfg"]),
                   output_root=str(work))
        if name not in FT_DB_INITIAL_VALIDATION:
            cfg["validate_initialization"] = False
        shutil.rmtree(work / cfg["name"], ignore_errors=True)
        DB.DATA_ROOT = str(data)
        t0 = time.perf_counter()
        trainer = FtTrainer(cfg)
        t_build = time.perf_counter() - t0
        ft = trainer.ft
        n_val = len(ft.val_ids)
        ft.val_ids = ft.val_ids[:FT_DB_VAL_VIEWS]
        rec = ft_run(GA, R, trainer, what, len(ft.ref_ids))
        hp, wp = ft.ref_store["imgs"].shape[1:3]
        h, w = ft.ref_info["imgs"].shape[1:3]
        log(f"{what} ({cfg_path}, {cfg['database_name']}, split "
            f"{cfg['database_split']}): scene written in {t_write:.1f} s "
            f"({kwargs}), FtTrainer built in {t_build:.1f} s; "
            f"{len(ft.ref_ids)} reference views {wp}x{hp} as padded from "
            f"their read size by ref_pad_interval "
            f"{ft.cfg['ref_pad_interval']}, {n_val} val views (the first "
            f"validated); ray_feats {list(ft.ray_feats.shape)} from the gen "
            f"model's init net in {rec.init['s']:.2f} s "
            f"({rec.init['launches']} diff gathers)")
        step_s, val_psnr = ft_summary(trainer, rec, what)
        log(f"{what}: {1 / step_s:.2f} steps/s beside phase 9's "
            f"{1 / ft_step_s:.2f} in this run; validation psnr_nr_fine "
            f"{val_psnr:.3f} dB")
        if not np.isfinite(val_psnr):
            raise RuntimeError(f"{what}: validation psnr {val_psnr}")
        for k in total:
            total[k] += rec.launches[k]
        backward += rec.backward
        que_i, ref_idx = ft.sample_train_indices(np.random.RandomState(0))
        que = ft._build_que_train(ref_idx, que_i, np.random.RandomState(0))
        profile_step(lambda: trainer.train_step((ref_idx, que, que_i)),
                     f"{what} step")
        f, b = real_coord_rows(GA, dev, {rec.fmap: rec.captured[0]},
                               f"phase 15 {name}", parent)
        fwd += f
        bwd += b
        if name == "birds":
            # the run's final state at the scene's padded size
            cfg = {**trainer.cfg, **FT_DB_GRAD_CHECK}
            ft_grad_compare(
                dev, cfg, {k: v.detach().cpu()
                           for k, v in trainer.ft.state_dict().items()},
                what, f"{cfg['train_ray_num']} rays from "
                f"{cfg['neighbor_view_num']} views "
                f"{list(ft.ref_store['imgs'].shape[1:3])}", witness=True)
        del trainer, ft
    return total, backward, fwd, bwd


def start_cli_fresh_process(work, weights):
    """Start phase 14's TF32 check (``cli_fresh_process``): the first exact
    eval view rendered by ``python -m neuray_tpu_torch.render`` in a fresh
    process (PyTorch's default flags, which the CLI's ``main`` turns off),
    under its own working directory with the same checkpoint and scene.
    Returns the job (``start_process``)."""
    repo = Path(__file__).resolve().parent
    fresh = work / "cli_fresh"
    shutil.rmtree(fresh, ignore_errors=True)
    write_gen_checkpoint(weights, fresh / "data" / "model", GEN_PROFILE)
    code = (
        "import sys, torch\n"
        "from neuray_tpu_torch import render\n"
        "def flags():\n"
        "    return (torch.backends.cuda.matmul.allow_tf32,"
        " torch.backends.cudnn.allow_tf32)\n"
        "print('flags before main', flags(), flush=True)\n"
        "render.main(sys.argv[1:])\n"
        "print('flags after main', flags(), flush=True)\n")
    args = ["--database_name", CLI_DATABASE, "--ray_num", str(CLI_RAY_NUM),
            "--cfg", str(repo / "configs" / "gen" / "neuray_gen_depth.yaml"),
            "--re", "1"]
    env = {**os.environ, "NEURAY_DATA_ROOT": str(work / "ft_data"),
           "PYTHONPATH": str(repo)}
    return start_process([sys.executable, "-c", code, *args], fresh,
                         "cli", cwd=fresh, env=env)


def cli_fresh_process(work, job):
    """Phase 14, the TF32 repair, finished: the fresh process's JPEGs
    (``start_cli_fresh_process``) equal byte for byte to the frame phase
    14 rendered in this process. Prints both processes' TF32 flags."""
    code, out, err, seconds = finish_process(job)
    if code:
        raise RuntimeError(f"the render CLI in a fresh process failed: "
                           f"{err[-3000:]}")
    lines = [x for x in out.splitlines() if x.startswith("flags")]
    here = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    render_dir = Path("data/render") / CLI_DATABASE.replace("/", "_")
    theirs = work / "cli_fresh" / render_dir / "neuray_gen_depth-eval"
    ours = work / "cli" / render_dir / "neuray_gen_depth-eval"
    for name in ("0-nr.jpg", "0-nr_fine.jpg"):
        if (theirs / name).read_bytes() != (ours / name).read_bytes():
            raise RuntimeError(f"the fresh process's {name} differs from "
                               "this process's")
    log(f"phase 14's CLI in a fresh process (done in {seconds:.1f} s on a "
        f"card shared with phase 20, 19(d) and 18(e)): {'; '.join(lines)}; this process's flags (matmul, "
        f"cudnn) {here}; its 0-nr.jpg and 0-nr_fine.jpg equal this "
        f"process's byte for byte")
    if lines != ["flags before main (False, True)",
                 "flags after main (False, False)"]:
        raise RuntimeError(f"the fresh process's TF32 flags: {lines}")


def hold_cli_exact_frame(launches, what):
    """An exact H x W frame of the render CLI that encodes once launches
    the f32 gather two times a pass, two passes a CLI_RAY_NUM-ray chunk,
    and once for the encode's diff features (phase 14's count)."""
    want = {"f32": 4 * -(-H * W // CLI_RAY_NUM) + 1, "bf16": 0, "u8": 0}
    if launches != want:
        raise RuntimeError(f"{what}: gather launches {launches}, expected "
                           f"{want}")


def ref_ckpt_phase(GA, R, dev, work, weights, weights_cv):
    """Phase 16: the reference's checkpoints. For the depth model
    (``configs/gen/neuray_gen_depth.yaml``, ``tools/bench_weights.npz``)
    and the cost-volume one (``neuray_gen_cost_volume.yaml``,
    ``bench_weights_cv.npz``): the port's state from the ``.npz``
    (``load_flax_params``) renamed to the reference's keys by the
    converter's renames run backwards, saved as a reference
    ``model_best.pth`` (``{"network_state_dict", "step"}``), converted by
    ``python -m neuray_tpu_torch.convert_reference_ckpt`` (a process of
    its own, the two side by side) and held, leaf for leaf, equal to the
    state it came from.
    Then phase 14's first exact eval view through the render CLI from the
    converted depth checkpoint: its JPEGs equal phase 14's byte for byte,
    its gather launches held (``hold_cli_exact_frame``). Returns the
    launches by instantiation."""
    from neuray_tpu_torch import render as RC
    from neuray_tpu_torch.data import database as DB
    from neuray_tpu_torch.models.renderer import NeurayRenderer, RenderConfig
    from neuray_tpu_torch.utils import reference_ckpt as RCK
    from neuray_tpu_torch.utils.config import load_cfg
    from neuray_tpu_torch.utils.params import load_flax_params
    repo = Path(__file__).resolve().parent
    root = work / "ref_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    cli = root / "cli"
    jobs = []
    t0 = time.perf_counter()
    try:
        for name, w in (("neuray_gen_depth", weights),
                        ("neuray_gen_cost_volume", weights_cv)):
            cfg_path = repo / "configs" / "gen" / f"{name}.yaml"
            cfg = load_cfg(str(cfg_path))
            model = NeurayRenderer(RenderConfig.from_cfg(cfg))
            load_flax_params(model, w)
            want = model.state_dict()
            ref_sd, record = RCK.convert_gen_state_dict(
                want, **RCK.gen_flags(cfg), reverse=True)
            pth = root / name / "model_best.pth"
            pth.parent.mkdir(parents=True)
            torch.save({"network_state_dict": ref_sd, "step": 0}, pth)
            out = cli / "data" / "model" / cfg["name"]
            # the two converters run side by side, each a process of its own
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "neuray_tpu_torch.convert_reference_ckpt", "--torch_ckpt",
                 str(pth), "--cfg", str(cfg_path), "--out", str(out)],
                cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
            jobs.append((name, want, ref_sd, record, out, proc))
        for name, want, ref_sd, record, out, proc in jobs:
            _, err = proc.communicate(timeout=600)
            if proc.returncode:
                raise RuntimeError(f"the converter failed: {err[-3000:]}")
            got = torch.load(out / "ckpt_best.pt",
                             weights_only=True)["params"]
            same = set(got) == set(want) and all(
                torch.equal(got[k], v) for k, v in want.items())
            kinds = {}
            for _, _, kind in record:
                kinds[kind] = kinds.get(kind, 0) + 1
            log(f"reference checkpoint {name}: {len(ref_sd)} reference keys"
                f" ({kinds}) written, converted by python -m "
                f"neuray_tpu_torch.convert_reference_ckpt within "
                f"{time.perf_counter() - t0:.1f} s of the first write (the "
                f"two side by side), {len(got)} leaves, equal leaf for leaf "
                f"to load_flax_params of the .npz: {same}")
            if not same:
                raise RuntimeError(f"{name}: the converted checkpoint "
                                   "differs from the .npz weights")
    finally:
        for *_, proc in jobs:
            proc.kill()
            proc.wait()
    render_dir = Path("data/render") / CLI_DATABASE.replace("/", "_")
    root_db, cwd = DB.DATA_ROOT, os.getcwd()
    DB.DATA_ROOT = str(work / "ft_data")
    os.chdir(cli)
    GA.reset_launches()
    try:
        t0 = time.perf_counter()
        RC.main(["--database_name", CLI_DATABASE, "--ray_num",
                 str(CLI_RAY_NUM), "--cfg", str(repo / "configs" / "gen" /
                                                 "neuray_gen_depth.yaml"),
                 "--re", "1"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        DB.DATA_ROOT = root_db
    launches = dict(GA.LAUNCHES_BY_DTYPE)
    hold_cli_exact_frame(launches, "the frame from the converted checkpoint")
    for name in ("0-nr.jpg", "0-nr_fine.jpg"):
        ours = cli / render_dir / "neuray_gen_depth-eval" / name
        theirs = work / "cli" / render_dir / "neuray_gen_depth-eval" / name
        if ours.read_bytes() != theirs.read_bytes():
            raise RuntimeError(f"the frame from the converted checkpoint's "
                               f"{name} differs from phase 14's")
    log(f"render CLI from the converted depth checkpoint: eval view 0 in "
        f"{seconds:.2f} s, gather launches {launches}; its JPEGs equal "
        f"phase 14's byte for byte")
    return launches


def dr_phase(GA, R, dev, work, weights, ref, que, gt, frame, frame_rays_s):
    """Phase 17: the direct-rendering branch (``use_dr_prediction``) on
    phase 4's exact 800x800 frame: warm-up, then a timed frame (encode +
    ray loop, gather launches held to phase 4's count), every output
    finite, ``pixel_colors_nr_fine`` bit-equal to phase 4's ``frame``, the
    GT-PSNR of ``dr`` and ``dr_fine`` printed (the weights were trained
    without the DR loss: no floor), rays/s beside phase 4's, a profiled
    chunk; card vs CPU on ``N_CHECK`` centre rays, each pass from the same
    depths (nr 1e-4; dr ``DR_BOUND`` / ``DR_MEAN_BOUND``); one frame of
    the render CLI with the DR config (phase 14's first eval view) whose
    ``-dr.jpg`` and ``-dr_fine.jpg`` equal its driver's, its gather
    launches held (``hold_cli_exact_frame``); one training
    step with the DR losses card vs CPU (``grad_check``). Returns the
    launches by instantiation."""
    from neuray_tpu_torch import render as RC
    from neuray_tpu_torch.data import database as DB
    from neuray_tpu_torch.data.imgs_info import (
        build_imgs_info, build_render_imgs_info)
    from neuray_tpu_torch.data.view_select import select_working_views_db
    from neuray_tpu_torch.models.renderer import NeurayRenderer, RenderConfig
    from neuray_tpu_torch.ops import sampling as S
    from neuray_tpu_torch.selfcheck import write_cfg
    from neuray_tpu_torch.train.losses import build_losses
    from neuray_tpu_torch.utils.config import load_cfg
    from neuray_tpu_torch.utils.params import load_flax_params
    gc.collect()
    torch.cuda.empty_cache()
    renderer = NeurayRenderer(RenderConfig(**EXACT_PROFILE,
                                           use_dr_prediction=True))
    load_flax_params(renderer, weights)
    renderer = renderer.to(dev).eval()
    n_rays = que["coords"].shape[1]
    n_chunks = -(-n_rays // renderer.cfg.ray_batch_num)
    R.render_full(renderer, ref, R._take_rays(que, np.arange(2 * CHUNK)),
                  DR_KEEP)
    torch.cuda.synchronize()
    GA.reset_launches()
    t0 = time.perf_counter()
    ref_c = R.encode_ref(renderer, ref)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = R.render_rays(renderer, ref_c, que, DR_KEEP)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(GA.LAUNCHES_BY_DTYPE)
    if GA.LAUNCHES != 2 * 2 * n_chunks + 1:
        raise RuntimeError(f"DR frame: {GA.LAUNCHES} gather launches, "
                           f"expected {2 * 2 * n_chunks + 1}")
    bad = [k for k, v in out.items() if not torch.isfinite(v).all()]
    if bad or set(out) != set(DR_KEEP):
        raise RuntimeError(f"DR frame outputs {sorted(out)}, not finite "
                           f"{bad}")
    if not torch.equal(out["pixel_colors_nr_fine"],
                       frame["pixel_colors_nr_fine"]):
        raise RuntimeError("the DR frame's pixel_colors_nr_fine is not "
                           "phase 4's")
    gts = {k: psnr(out[k][0].reshape(H, W, 3).cpu().numpy(), gt)
           for k in DR_KEEP}
    log(f"DR frame: {n_rays} rays, encode {t1 - t0:.3f} s, ray loop "
        f"{t2 - t1:.3f} s = {n_rays / (t2 - t1):.1f} rays/s beside phase "
        f"4's {frame_rays_s:.1f}, gather launches {launches}; "
        f"pixel_colors_nr_fine equal to phase 4's bit for bit; GT-PSNR "
        + ", ".join(f"{k[len('pixel_colors_'):]} {v:.3f} dB"
                    for k, v in gts.items()))
    mid = R._take_rays(que, np.arange(CHUNK) + (n_rays - CHUNK) // 2)
    with torch.inference_mode():
        profile_step(lambda: renderer.render_chunk(ref_c, mid),
                     "DR chunk (1024 rays, coarse + fine)")

    # card vs CPU, each pass from the same depths
    cpu_r = copy.deepcopy(renderer).cpu()
    ref_cpu = {k: v.cpu() for k, v in ref_c.items()}
    idx = np.arange(N_CHECK) + (n_rays - N_CHECK) // 2
    worst = {}
    with torch.inference_mode():
        for part in np.array_split(idx, -(-idx.size // CHUNK)):
            qg = R._take_rays(que, part)
            qc = {k: v.cpu() for k, v in qg.items()}
            depth, _ = S.sample_depth(qg["depth_range"], 1, part.size, DN)
            cg = renderer._render_by_depth(depth, qg, ref_c, False)
            cc = cpu_r._render_by_depth(depth.cpu(), qc, ref_cpu, False)
            fine = renderer._fine_depth(depth, cg["hit_prob_nr"],
                                        qg["depth_range"], DN)
            fg = renderer._render_by_depth(fine, qg, ref_c, True)
            fc = cpu_r._render_by_depth(fine.cpu(), qc, ref_cpu, True)
            for name, a, b in (("coarse", cg, cc), ("fine", fg, fc)):
                for k in ("pixel_colors_nr", "pixel_colors_dr"):
                    d = (a[k].cpu() - b[k]).abs()
                    mx, mean = worst.get(f"{name} {k}", (0.0, 0.0))
                    worst[f"{name} {k}"] = (max(mx, d.max().item()),
                                            max(mean, d.mean().item()))
    log(f"DR in situ: {N_CHECK} rays from #{idx[0]}, card vs CPU (max, "
        "mean): " + ", ".join(f"{k} {v[0]:.3g} / {v[1]:.3g}"
                              for k, v in worst.items()))
    for k, (mx, mean) in worst.items():
        if ("_nr" in k and mx > 1e-4) or ("_dr" in k and (
                mx > DR_BOUND or mean > DR_MEAN_BOUND)):
            raise RuntimeError(f"DR card vs CPU: {k} {mx:.3g} / {mean:.3g}")
    del cpu_r, ref_cpu

    # one frame of the render CLI with the DR config
    repo = Path(__file__).resolve().parent
    cli = work / "cli"
    cfg = {**load_cfg(str(repo / "configs" / "gen" /
                          "neuray_gen_depth.yaml")),
           "name": "neuray_gen_depth_dr", "load_ckpt_name": "neuray_gen_depth",
           "use_dr_prediction": True}
    cfg_path = write_cfg(cli / "dr.yaml", cfg)
    root_db, cwd = DB.DATA_ROOT, os.getcwd()
    DB.DATA_ROOT = str(work / "ft_data")
    os.chdir(cli)
    GA.reset_launches()
    try:
        RC.main(["--database_name", CLI_DATABASE, "--ray_num",
                 str(CLI_RAY_NUM), "--cfg", cfg_path, "--re", "1"])
        torch.cuda.synchronize()
        database = DB.parse_database_name(CLI_DATABASE)
    finally:
        os.chdir(cwd)
        DB.DATA_ROOT = root_db
    hold_cli_exact_frame(dict(GA.LAUNCHES_BY_DTYPE), "CLI DR frame")
    for k in launches:
        launches[k] += GA.LAUNCHES_BY_DTYPE[k]
    DB.DATA_ROOT = str(work / "ft_data")
    try:
        ref_ids = [i for i in database.get_img_ids(True)
                   if i.startswith("tr")]
        img_id = [i for i in database.get_img_ids() if i.startswith("te")][0]
        pose = database.get_pose(img_id).astype(np.float32)
        refs = select_working_views_db(database, ref_ids, pose[None], 8)[0]
        ref_v = {k: torch.from_numpy(v).to(dev) for k, v in build_imgs_info(
            database, list(refs), 16, True, replace_none_depth=True).items()}
        q = build_render_imgs_info(pose, database.get_K(img_id), (H, W),
                                   database.get_depth_range(img_id))
        q.pop("shape")
        q = {k: torch.from_numpy(v).to(dev) for k, v in q.items()}
    finally:
        DB.DATA_ROOT = root_db
    cli_r = NeurayRenderer(RenderConfig.from_cfg(
        {**cfg, "ray_batch_num": CLI_RAY_NUM}))
    load_flax_params(cli_r, weights)
    cli_r = cli_r.to(dev).eval()
    drv = R.render_rays(cli_r, R.encode_ref(cli_r, ref_v), q, DR_KEEP)
    frame_dir = cli / "data" / "render" / CLI_DATABASE.replace("/", "_") / \
        "neuray_gen_depth_dr-eval"
    for key in DR_KEEP:
        same_jpeg(frame_dir / f"0-{key[len('pixel_colors_'):]}.jpg", drv,
                  key, "CLI DR frame 0")
    log("CLI DR frame: 0-nr.jpg, 0-nr_fine.jpg, 0-dr.jpg and 0-dr_fine.jpg "
        "equal its driver's called directly")
    del cli_r, renderer

    # one training step with the DR losses, card vs CPU
    train_cfg = {**TRAIN_PROFILE, "use_dr_prediction": True,
                 "use_dr_loss": True, "use_dr_fine_loss": True}
    grad_check(SimpleNamespace(
        renderer=NeurayRenderer(RenderConfig.from_cfg(train_cfg)),
        loss_fn=build_losses(train_cfg)), dev, weights,
        what=f"DR training gradients (use_dr_loss, use_dr_fine_loss), card "
        f"vs CPU ({GRAD_CHECK_DATA}, {DN} + {DN} samples, rays through the "
        f"sphere)")
    return launches


# ---------------- phase 18: multi-GPU ----------------

# phase 18: the ranks of parallel/spawn.py (torchrun's counterpart for a
# script), MG_RANKS of them, rank r on cuda:(r % cards): on one card they
# share it over gloo (nccl refuses two ranks on one device), on two or more
# each has its own over nccl (parallel/sharding.py: make_mesh)
MG_RANKS = 2
MG_WORKERS = 2            # DataLoader workers a rank (phase 12: 6)
MG_GEN_STEPS = 4          # data-parallel gen steps: the first held, 3 timed
MG_FT_STEPS = 4           # ray-sharded finetuning steps, likewise
MG_CLI_STEPS = 3          # the training CLI's finetuning steps
# the training CLIs' logged losses, each printed to 5 decimals: two
# roundings of 5e-6 and 1e-5 left for the sharded run's own rounding
MG_CLI_LOSS_BOUND = 2e-5
# after the first update, the share of the update's effect on the loss
# (the one-process CLI against itself at lr 0) by which the sharded CLI
# may differ: Adam's first steps move a coordinate by lr whatever its
# gradient's size, so rounding-level gradients of the other sign part two
# runs (on the CPU, the one-process CLI at 1 thread against 8 parted by
# 0.4% of the effect after 1 update and 0.9% after 2)
MG_CLI_UPDATE_SHARE = 0.1
MG_TIMEOUT = 600          # the ranks' run, after which they are killed
MG_FRAME_BOUND = 1e-5     # the sharded exact frame against phase 4's
# a sharded step's gradient against the one-process step's on the same
# inputs: within MG_GRAD_BOUND of each leaf's norm plus MG_GRAD_FLOOR (the
# rounding left in the exactly-zero gradients of conv biases that feed an
# InstanceNorm); the backward's long bins add with global atomics, so two
# runs on one card differ in the last bits
MG_GRAD_BOUND, MG_GRAD_FLOOR = 1e-5, 1e-7
# the ranks' device: None for the cards (a CPU rehearsal sets "cpu")
MG_DEVICE = None


def mg_cards_label():
    n = torch.cuda.device_count()
    return (f"{MG_RANKS} ranks on one card" if n < MG_RANKS
            else f"{MG_RANKS} ranks on {MG_RANKS} cards")


def mg_grad_error(got, want):
    """The worst leaf of got against want (name -> tensor), relative to
    the leaf's norm, over leaves above 1000 floors; and the leaves outside
    MG_GRAD_BOUND * norm + MG_GRAD_FLOOR."""
    err = {n: ((got[n].float() - w.float()).norm().item(),
               w.float().norm().item()) for n, w in want.items()}
    rel = {n: d / g for n, (d, g) in err.items() if g > 1e3 * MG_GRAD_FLOOR}
    worst = max(rel, key=rel.get)
    bad = {n: e for n, e in err.items()
           if not e[0] <= MG_GRAD_BOUND * e[1] + MG_GRAD_FLOOR}
    return {"worst": rel[worst], "leaf": worst, "leaves": len(err),
            "bad": bad}


def mg_same_on_every_rank(mesh, tensors):
    """Whether the flat concatenation of tensors equals rank 0's, bit for
    bit (one broadcast)."""
    import torch.distributed as dist
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    return bool(torch.equal(flat, ref))


def mg_rank(mesh, work, spec):
    """Phase 18 on one rank (a spawned process; ``spec`` from
    ``multi_gpu_phase``): (a) phase 4's exact frame and (b) phase 7's
    bench default with ``mesh``, (c) data-parallel steps of phase 12's
    config, (d) ray-sharded steps of phase 9's; writes its report (and
    rank 0 the frames) under ``work``."""
    from neuray_tpu_torch.data import database as DB
    from neuray_tpu_torch.data.synthetic import make_query, make_sphere_scene
    from neuray_tpu_torch.models import renderer as R
    from neuray_tpu_torch.ops import gather as GA
    from neuray_tpu_torch.parallel import sharding as P
    from neuray_tpu_torch.train.ft_trainer import FtTrainer
    from neuray_tpu_torch.train.losses import build_losses
    from neuray_tpu_torch.train.trainer import Trainer
    from neuray_tpu_torch.utils.config import load_cfg
    from neuray_tpu_torch.utils.params import (
        load_flax_params, load_params_npz)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    GA.load_library()                  # built by the parent: found built
    rep = {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend}

    def sync():
        torch.cuda.synchronize(dev)
        mesh.barrier()

    def counts():
        return {**GA.LAUNCHES_BY_DTYPE, "backward": GA.BACKWARD_LAUNCHES}

    # (a), (b): the frames
    weights = load_params_npz(spec["weights"])
    rng = np.random.RandomState(0)
    ref_np = make_sphere_scene(rng, RFN, H, W)
    que_np = make_query(rng, H, W, 0, full_image=True)
    que_np.pop("imgs")
    ref = {k: torch.from_numpy(v).to(dev) for k, v in ref_np.items()}
    que = {k: torch.from_numpy(v).to(dev) for k, v in que_np.items()}
    exact = R.NeurayRenderer(R.RenderConfig(**EXACT_PROFILE))
    load_flax_params(exact, weights)
    exact = exact.to(dev).eval()
    render = P.make_sharded_render_fn(exact, mesh, R.DEFAULT_KEEP)
    render(ref, dict(que, coords=que["coords"][:, :CHUNK * mesh.size]))
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    GA.reset_launches()
    t0 = time.perf_counter()
    out = render(ref, que)
    sync()
    rep["exact"] = {"s": time.perf_counter() - t0, "launches": counts(),
                    "peak": torch.cuda.max_memory_allocated(dev)}
    if mesh.is_main:
        torch.save({k: v.cpu() for k, v in out.items()},
                   Path(work) / "exact.pt")
    del out, exact, render

    bench = R.NeurayRenderer(R.RenderConfig(**BENCH_PROFILE))
    load_flax_params(bench, weights)
    bench = bench.to(dev).eval()

    def bench_frame():
        return R.render_frame_probe_focus(bench, R.encode_ref(bench, ref),
                                          que, image_hw=(H, W), mesh=mesh,
                                          **BENCH_ARGS)

    bench_frame()
    sync()
    GA.reset_launches()
    t0 = time.perf_counter()
    out = bench_frame()
    sync()
    rep["bench"] = {"s": time.perf_counter() - t0, "launches": counts(),
                    "kept": out["kept_rays"]}
    if mesh.is_main:
        torch.save({"keep_mask": out["keep_mask"],
                    "pixel_colors_nr_fine": out["pixel_colors_nr_fine"]},
                   Path(work) / "bench.pt")
    del out, bench, ref, que
    gc.collect()
    torch.cuda.empty_cache()

    def own_grads(trainer, losses, module):
        """The one-process gradient of losses (this process alone)."""
        total = sum(v.mean() for k, v in losses.items()
                    if k.startswith("loss"))
        trainer.optimizer.zero_grad(set_to_none=True)
        total.backward()
        return {n: (p.grad.detach().clone() if p.grad is not None
                    else torch.zeros_like(p))
                for n, p in module.named_parameters()}

    def run_steps(trainer, module, batches, n):
        times, per_step = [], []
        for _ in range(n):
            batch = next(batches)
            sync()
            before = counts()
            t0 = time.perf_counter()
            trainer.train_step(batch)
            sync()
            times.append(time.perf_counter() - t0)
            per_step.append({k: v - before[k] for k, v in counts().items()})
        return times, per_step

    # (c): data-parallel gen steps, each rank its own sample
    trainer = Trainer(load_cfg(spec["gen_cfg"]), mesh=mesh)
    trainer._start()
    batches = trainer._batches(0)
    batch = next(batches)
    state = trainer.generator.get_state()
    own = own_grads(trainer, trainer._losses(batch), trainer.renderer)
    torch.save({n: g.cpu() for n, g in own.items()},
               Path(work) / f"gen_own{mesh.rank}.pt")
    trainer.generator.set_state(state)
    torch.cuda.reset_peak_memory_stats(dev)
    GA.reset_launches()
    trainer.train_step(batch)
    first = counts()
    avg = {n: p.grad.detach().clone()
           for n, p in trainer.renderer.named_parameters()}
    sync()
    if mesh.is_main:
        parts = [torch.load(Path(work) / f"gen_own{r}.pt")
                 for r in range(mesh.size)]
        mean = {n: sum(p[n] for p in parts).to(dev) / mesh.size
                for n in parts[0]}
        rep["gen_grads"] = mg_grad_error(avg, mean)
    times, per_step = run_steps(trainer, trainer.renderer, batches,
                                MG_GEN_STEPS - 1)
    rep["gen"] = {"times": times, "first": first, "per_step": per_step,
                  "launches": counts(), "shape": tuple(
                      batch["ref"]["imgs"].shape),
                  "same": mg_same_on_every_rank(
                      mesh, list(trainer.renderer.parameters())),
                  "peak": torch.cuda.max_memory_allocated(dev)}
    del trainer, batches, batch, own, avg
    gc.collect()
    torch.cuda.empty_cache()

    # (d): ray-sharded finetuning steps on phase 9's scene
    DB.DATA_ROOT = spec["ft_data"]
    t0 = time.perf_counter()
    trainer = FtTrainer(dict(spec["ft_cfg"]), mesh=mesh)
    trainer._start()
    sync()
    build_s = time.perf_counter() - t0
    batches = trainer._batches(0)
    batch = next(batches)
    state = trainer.generator.get_state()
    if mesh.is_main:
        ref_idx, que_b, que_i = batch
        one = own_grads(trainer, build_losses(trainer.cfg)(
            trainer.ft(ref_idx, que_b, que_i, trainer.generator), {}),
            trainer.ft)
        trainer.generator.set_state(state)
    torch.cuda.reset_peak_memory_stats(dev)
    GA.reset_launches()
    trainer.train_step(batch)
    first = counts()
    if mesh.is_main:
        rep["ft_grads"] = mg_grad_error(
            {n: p.grad for n, p in trainer.ft.named_parameters()}, one)
        del one
    times, per_step = run_steps(trainer, trainer.ft, batches,
                                MG_FT_STEPS - 1)
    rep["ft"] = {"times": times, "first": first, "per_step": per_step,
                 "launches": counts(), "build_s": build_s,
                 "rays": trainer.cfg["train_ray_num"],
                 "same": mg_same_on_every_rank(
                     mesh, list(trainer.ft.parameters())),
                 "peak": torch.cuda.max_memory_allocated(dev)}
    del trainer, batches, batch
    torch.save(rep, Path(work) / f"report{mesh.rank}.pt")


def mg_torchrun(args):
    """``torchrun --standalone --nproc_per_node MG_RANKS -m <args>``, as
    ``python -m torch.distributed.run`` (torchrun's module)."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(MG_RANKS), "-m", *args]


def mg_wait(jobs, timeout=420):
    """Wait for ``start_mg_cli``'s processes, against one deadline
    ``timeout`` s after the first started; the seconds from each one's
    start to its end. Raises with the end of a failing one's output, or
    naming one still running at the deadline; stops them all either
    way."""
    deadline = min(j.t0 for j in jobs.values()) + timeout
    seconds = {}
    try:
        for what, job in jobs.items():
            try:
                code, out, err, seconds[what] = finish_process(
                    job, max(deadline - time.perf_counter(), 0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"phase 18: {what} still running after "
                                   f"{timeout} s") from None
            if code != 0:
                raise RuntimeError(f"phase 18 {what} failed ({code}):\n"
                                   f"{out[-2500:]}\n{err[-2500:]}")
    finally:
        for job in jobs.values():
            stop_process(job)
    return seconds


def train_log(path):
    """A train.txt's loss values by step (one line a logged step, the
    log's 5 decimals)."""
    rows = [line.split() for line in Path(path).read_text().splitlines()]
    return {int(v[2]): {k: float(x) for k, x in zip(v[3::2], v[4::2])
                        if k.startswith("loss")} for v in rows}


def check_cli_losses(logs, steps, what):
    """Hold the sharded training CLI's logged losses (``logs["two"]``) to
    the one-process CLI's (``"one"``), with a one-process run at lr 0
    (``"zero"``) as the control: step 1, taken before any update, within
    MG_CLI_LOSS_BOUND in every loss; each later step's loss_total within
    MG_CLI_UPDATE_SHARE of the one-process update's effect on it (one
    against zero), or MG_CLI_LOSS_BOUND where that is less. The update
    must move some step's loss_total by 10 bounds, else the check shows
    nothing. Returns {step: (two - one, one - zero)} of loss_total."""
    if any(sorted(v) != list(range(1, steps + 1)) for v in logs.values()):
        raise RuntimeError(f"{what}: logged steps " + ", ".join(
            f"{k} {sorted(v)}" for k, v in logs.items()))
    first = {k: v[1] for k, v in logs.items()}
    if not first["two"].keys() == first["one"].keys() == first["zero"].keys():
        raise RuntimeError(f"{what}: step 1 logged {first}")
    apart = max(abs(v[n] - first["one"][n]) for v in first.values()
                for n in v)
    if not apart <= MG_CLI_LOSS_BOUND:
        raise RuntimeError(f"{what}: step 1's losses apart by {apart}")
    out = {}
    for st in range(2, steps + 1):
        t = {k: v[st]["loss_total"] for k, v in logs.items()}
        out[st] = (t["two"] - t["one"], t["one"] - t["zero"])
    for st, (d, effect) in out.items():
        if not abs(d) <= max(MG_CLI_UPDATE_SHARE * abs(effect),
                             MG_CLI_LOSS_BOUND):
            raise RuntimeError(f"{what}: step {st}'s loss_total {d} from "
                               f"the one-process CLI's, whose update moved "
                               f"it {effect}")
    if not max(abs(e) for _, e in out.values()) >= 10 * MG_CLI_LOSS_BOUND:
        raise RuntimeError(f"{what}: the update moved no loss ({out})")
    return out


def start_mg_cli(work, weights):
    """Start phase 18(e) (``mg_cli``): both CLIs under torchrun on phase
    14's scene, side by side with two one-process training CLIs (they
    run beside phase 20). Returns {what: its job} (``start_process``)."""
    from neuray_tpu_torch.selfcheck import write_cfg
    repo = Path(__file__).resolve().parent
    cli = work / "mg_cli"
    shutil.rmtree(cli, ignore_errors=True)
    cli.mkdir(parents=True)
    write_gen_checkpoint(weights, cli / "data" / "model", GEN_PROFILE)
    env = {**os.environ, "NEURAY_DATA_ROOT": str(work / "ft_data"),
           "PYTHONPATH": str(repo)}
    runs = {}
    for kind in ("two", "one", "zero"):
        root = cli / kind
        write_gen_checkpoint(weights, root, GEN_PROFILE)
        lr = FT_PROFILE["lr_cfg"]
        runs[kind] = write_cfg(cli / f"{kind}.yaml", {
            **FT_PROFILE, **FT_CUTS, "output_root": str(root),
            "total_step": MG_CLI_STEPS, "save_interval": MG_CLI_STEPS,
            "train_log_step": 1, "use_validation": False,
            "lr_cfg": dict(lr, lr_init=0.0) if kind == "zero" else lr})
    one_process = [sys.executable, "-m", "neuray_tpu_torch.run_training",
                   "--cfg"]
    cmds = {
        "render CLI": mg_torchrun([
            "neuray_tpu_torch.render", "--database_name", CLI_DATABASE,
            "--cfg", str(repo / "configs" / "gen" / "neuray_gen_depth.yaml"),
            "--re", "1"]),
        "training CLI": mg_torchrun(["neuray_tpu_torch.run_training",
                                     "--cfg", runs["two"]]),
        "one-process training CLI": one_process + [runs["one"]],
        "one-process training CLI at lr 0": one_process + [runs["zero"]]}
    return {what: start_process(cmd, cli, what.replace(" ", "_"), cwd=cli,
                                env=env) for what, cmd in cmds.items()}


def mg_cli(work, jobs, smi):
    """Phase 18(e), finished (``start_mg_cli``): the render CLI's first
    exact eval view under torchrun, its JPEGs against phase 14's
    one-process ones byte for byte; the training CLI finetuning phase 9's
    config for MG_CLI_STEPS steps on MG_RANKS ranks beside the
    one-process CLI on the same config and the one-process CLI at lr 0:
    the same files, and each step's logged losses held by
    ``check_cli_losses``."""
    s = mg_wait(jobs)
    cli = work / "mg_cli"
    label = mg_cards_label()
    rel = Path("data/render") / CLI_DATABASE.replace("/", "_")
    names = [f"neuray_gen_depth-eval/0-{k}.jpg" for k in ("nr", "nr_fine")]
    for name in names + ["gt/0.jpg"]:
        if (cli / rel / name).read_bytes() != \
                (work / "cli" / rel / name).read_bytes():
            raise RuntimeError(f"phase 18 render CLI: {name} differs from "
                               "phase 14's")
    log(f"phase 18 render CLI under torchrun ({label}; side by side with "
        f"the training CLIs and phase 20, a shared card's time): the first "
        f"exact eval view {H}x{W} in {s['render CLI']:.1f} s (2 process "
        f"starts in); its "
        f"JPEGs equal "
        f"phase 14's byte for byte ({smi})")
    s_two, s_one = s["training CLI"], s["one-process training CLI"]
    dirs = {k: cli / k / FT_PROFILE["name"] for k in ("two", "one", "zero")}
    files = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
    if files["two"] != files["one"]:
        raise RuntimeError(f"phase 18 training CLI wrote {files['two']}, "
                           f"the one-process CLI {files['one']}")
    ckpt = {k: torch.load(d / "ckpt.pt", map_location="cpu",
                          weights_only=True) for k, d in dirs.items()}
    if {c["step"] for c in ckpt.values()} != {MG_CLI_STEPS}:
        raise RuntimeError("phase 18 training CLI: steps " + ", ".join(
            f"{k} {c['step']}" for k, c in ckpt.items()))
    a, b = ckpt["two"]["params"], ckpt["one"]["params"]
    if a.keys() != b.keys() or any(a[k].shape != b[k].shape for k in a):
        raise RuntimeError("phase 18 training CLI: the checkpoints differ "
                           "in their parameters")
    logs = {k: train_log(d / "train.txt") for k, d in dirs.items()}
    out = check_cli_losses(logs, MG_CLI_STEPS, "phase 18 training CLI")
    log(f"phase 18 training CLI under torchrun ({label}): {MG_CLI_STEPS} "
        f"finetuning steps of {FT_PROFILE['name']} ray-sharded in {s_two:.1f}"
        f" s, the one-process CLI in {s_one:.1f} s (side by side on the "
        f"card with the render CLI, the one-process CLI at lr 0 and phase "
        f"20: a shared card's times, not the scaling; each "
        f"with its process starts, FtTrainer build and ray_feats init); "
        f"files {files['two']} alike; step 1's losses equal to train.txt's "
        f"5 decimals (bound {MG_CLI_LOSS_BOUND:g}); loss_total sharded / "
        f"one process / at lr 0: " + ", ".join(
            f"step {st} {logs['two'][st]['loss_total']:.5f} / "
            f"{logs['one'][st]['loss_total']:.5f} / "
            f"{logs['zero'][st]['loss_total']:.5f} (apart {d:+.5f}, the "
            f"update's effect {e:+.5f})" for st, (d, e) in out.items())
        + f"; bound {MG_CLI_UPDATE_SHARE:g} of the effect ({smi})")


def multi_gpu_phase(GA, dev, work, weights, exact_out, bench_frame, smi,
                    one):
    """Phase 18: multi-GPU. MG_RANKS spawned ranks (``run_ranks``; the
    kernel built here before they start, a free port on 127.0.0.1, each
    rank's launches its own) run ``mg_rank``: (a) phase 4's exact frame
    with ``make_sharded_render_fn``, within MG_FRAME_BOUND of phase 4's
    ``exact_out`` (and whether byte-equal); (b) the bench default with
    ``mesh``, phase 7's keep set (``bench_frame``); (c) data-parallel steps
    of phase 12's config on its data (MG_WORKERS workers a rank), the first
    step's averaged gradients against the mean of each rank's one-process
    gradient; (d) ray-sharded steps of phase 9's config on its scene, the
    first step's against the one-process step on rank 0; parameters the
    same on every rank. (e), both CLIs under torchrun (``start_mg_cli``,
    ``mg_cli``), runs beside phase 20. Times are labelled with how the
    ranks sit on the cards, and each printed beside the one-process time
    of its phase in this run (``one``:
    phase 4's ray loop s, phase 7's encode + render s, phases 12's and
    9's median step s): the scaling. Returns the ranks' gather launches
    (forward by instantiation, and backward)."""
    from neuray_tpu_torch.parallel.spawn import run_ranks
    if MG_DEVICE is None:
        mode = subprocess.run(
            ["nvidia-smi", "--query-gpu=compute_mode",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.split()
        if (torch.cuda.device_count() < MG_RANKS
                and "Exclusive_Process" in mode):
            raise RuntimeError(f"phase 18: the card's compute mode is "
                               f"{mode[0]}: {MG_RANKS} ranks cannot share it")
    label = mg_cards_label()
    out = work / "mg"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    gen_cfg = out / Path(GEN_CLI_CFG).name
    cut_config(Path(__file__).resolve().parent / GEN_CLI_CFG, gen_cfg, {
        "total_step": MG_GEN_STEPS, "worker_num": MG_WORKERS,
        "output_root": str(out)})
    write_gen_checkpoint(weights, out, GEN_PROFILE)
    spec = {"weights": str(Path(__file__).resolve().parent / "tools" /
                           "bench_weights.npz"),
            "gen_cfg": str(gen_cfg), "ft_data": str(work / "ft_data"),
            "ft_cfg": {**FT_PROFILE, **FT_CUTS, "output_root": str(out),
                       "total_step": MG_FT_STEPS}}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_ranks(mg_rank, MG_RANKS, (str(out), spec), timeout=MG_TIMEOUT,
              device=MG_DEVICE)
    wall = time.perf_counter() - t0
    reps = [torch.load(out / f"report{r}.pt", weights_only=False)
            for r in range(MG_RANKS)]
    log(f"phase 18: {MG_RANKS} ranks ({label}; " + ", ".join(
        f"rank {r['rank']} on {r['device']}" for r in reps) +
        f", backend {reps[0]['backend']}) ran parts a-d in {wall:.1f} s "
        f"({smi})")

    # (a) the exact frame
    n_rays = H * W
    sharded = torch.load(out / "exact.pt")
    if sharded.keys() != exact_out.keys():
        raise RuntimeError(f"phase 18 exact frame keys {sorted(sharded)}")
    err = max((sharded[k].float() - exact_out[k].cpu().float()).abs().max()
              .item() for k in sharded)
    byte_equal = all(torch.equal(sharded[k], exact_out[k].cpu())
                     for k in sharded)
    per = -(-n_rays // (MG_RANKS * CHUNK))
    for r in reps:
        want = {"f32": 2 * 2 * per + 1, "bf16": 0, "u8": 0, "backward": 0}
        if r["exact"]["launches"] != want:
            raise RuntimeError(f"phase 18 exact frame rank {r['rank']}: "
                               f"launches {r['exact']['launches']}, "
                               f"expected {want}")
    s = max(r["exact"]["s"] for r in reps)
    log(f"phase 18a exact frame ({label}): {n_rays} rays in {s:.3f} s = "
        f"{n_rays / s:.1f} rays/s (encode on every rank in), "
        f"{one['frame'] / s:.2f}x phase 4's ray loop in this run "
        f"({n_rays / one['frame']:.1f} rays/s); against phase "
        f"4's frame max |diff| {err:.3g} (bound {MG_FRAME_BOUND:g}), "
        f"byte-equal {byte_equal}; gather launches a rank " + ", ".join(
            f"{r['exact']['launches']['f32']}" for r in reps) + "; peak "
        "memory a rank " + ", ".join(
            f"{r['exact']['peak'] / 2**30:.2f} GiB" for r in reps))
    if not err <= MG_FRAME_BOUND:
        raise RuntimeError(f"phase 18 exact frame differs by {err}")

    # (b) the bench default
    bench_out = bench_frame["out"]
    b = torch.load(out / "bench.pt", weights_only=False)
    flips = int((b["keep_mask"] != bench_out["keep_mask"]).sum())
    if flips:
        raise RuntimeError(f"phase 18 bench frame: keep set differs from "
                           f"phase 7's in {flips} rays")
    berr = float(np.abs(b["pixel_colors_nr_fine"]
                        - bench_out["pixel_colors_nr_fine"]).max())
    s = max(r["bench"]["s"] for r in reps)
    log(f"phase 18b bench default ({label}): encode + probe + render "
        f"{s:.3f} s = {n_rays / s:.1f} rays/s, {one['bench'] / s:.2f}x "
        f"phase 7's in this run ({one['bench']:.3f} s), phase 7's keep set "
        f"({reps[0]['bench']['kept']} rays), colours against phase 7's max "
        f"|diff| {berr:.3g}; gather launches a rank " + ", ".join(
            str({k: v for k, v in r["bench"]["launches"].items() if v})
            for r in reps))
    if not all(r["bench"]["launches"]["u8"] > 0 for r in reps):
        raise RuntimeError("phase 18 bench frame: a rank launched no u8 "
                           "gather")

    # (c), (d) the steps
    for part, key, what in (("c", "gen", "data-parallel gen steps"),
                            ("d", "ft", "ray-sharded finetuning steps")):
        g = reps[0][f"{key}_grads"]
        same = all(r[key]["same"] for r in reps)
        times = np.asarray([max(r[key]["times"][i] for r in reps)
                            for i in range(len(reps[0][key]["times"]))])
        fwd = [r[key]["first"] for r in reps]
        log(f"phase 18{part} {what} ({label}): {len(times) + 1} steps, the "
            f"timed {len(times)} median {np.median(times):.4f} s = "
            f"{1 / np.median(times):.2f} steps/s (range "
            f"{times.min():.4f}-{times.max():.4f} s), "
            f"{one[key] / np.median(times):.2f}x phase "
            f"{12 if key == 'gen' else 9}'s steps/s in this run "
            f"({1 / one[key]:.2f})"
            + (f", {reps[0]['ft']['rays']} rays a step over the ranks, "
               f"FtTrainer built with its ray_feats in "
               f"{reps[0]['ft']['build_s']:.1f} s" if key == "ft" else
               f", one sample a rank ({reps[0]['gen']['shape']})")
            + f"; the first step's averaged gradients against the "
            f"one-process step on the same inputs: worst leaf "
            f"{g['worst']:.3g} of its norm ({g['leaf']}, {g['leaves']} "
            f"leaves, bound {MG_GRAD_BOUND:g} + {MG_GRAD_FLOOR:g}); "
            f"parameters the same on every rank {same}; first step's gather "
            f"launches a rank {fwd}; peak memory a rank " + ", ".join(
                f"{r[key]['peak'] / 2**30:.2f} GiB" for r in reps))
        if g["bad"] or not same:
            raise RuntimeError(f"phase 18 {what}: leaves outside the bound "
                               f"{g['bad']}, parameters the same {same}")
        for r in reps:
            first = r[key]["first"]
            if not (first["f32"] > 0 and first["backward"] > 0):
                raise RuntimeError(f"phase 18 {what} rank {r['rank']}: "
                                   f"gather launches {first}")
    launches = {"f32": 0, "bf16": 0, "u8": 0, "backward": 0}
    for r in reps:
        for part in ("exact", "bench"):
            for k in launches:
                launches[k] += r[part]["launches"][k]
        for key in ("gen", "ft"):
            for k in launches:
                launches[k] += r[key]["launches"][k]
    return launches


# ---------------- phase 19: the analytic scenes ----------------

# the auto driver's start on the scenes (the quality tools' --auto: probe
# 8, focus 16 + 32) and its arguments on the bench route, bf16 + u8
SCENE_AUTO_PROFILE = dict(
    use_hierarchical_sampling=True, use_vis=False, fine_use_vis=False,
    ray_batch_num=CHUNK, probe_sample_num=8, focus_sample_num=16,
    focus_fine_sample_num=32, use_bf16=True, gather_quant="u8")
SCENE_AUTO_ARGS = dict(threshold=0.01, dilate=1, probe_stride=2, tol=0.02,
                       win_tol_db=0.05)
# the blobs' auto frame may lose this much GT-PSNR against its exact frame
SCENE_AUTO_GT_TOL = 0.5
# the trainer's run in a fresh process: steps at 400 px (the tool's other
# defaults: 512 rays, 64 + 64 samples on the card), and the card-vs-CPU
# gradient check's size, rays and samples
TRAIN_SCENE_STEPS = 40
SCENE_GRAD = dict(size=64, rays=256, dn=64)


def scene_exact_frame(GA, R, dev, name, weights, capture=False):
    """The named scene's exact f32 frame (``scene_frame``,
    ``EXACT_PROFILE``): encode + ``render_rays``, its gather launches held
    to 2 a chunk pass plus the encode's diff gather, outputs finite, GT-PSNR
    on the whole frame and on ``scene_psnr_rays`` within SCENE_PSNR_TOL of
    the JAX package's. With ``capture`` the first chunk's coarse 64-ch map
    gather's points and mask are kept. Returns (renderer, ref, que, gt,
    the frame's outputs, rays/s, GT-PSNR, captured)."""
    from neuray_tpu_torch.utils.params import load_flax_params
    ref_np, que_np, gt = scene_frame(name)
    ref, que = ({k: torch.from_numpy(v).to(dev) for k, v in d.items()}
                for d in (ref_np, que_np))
    renderer = R.NeurayRenderer(R.RenderConfig(**EXACT_PROFILE))
    load_flax_params(renderer, weights)
    renderer = renderer.to(dev).eval()
    n_rays = que["coords"].shape[1]
    n_chunks = -(-n_rays // CHUNK)
    gather, captured = R.interpolate_feature_map, []

    def capture_first(feats, *args):
        if feats.shape[-1] == 64 and not captured:
            keep_points(captured, *args[:2])
        return gather(feats, *args)

    GA.reset_launches()
    t0 = time.perf_counter()
    if capture:
        R.interpolate_feature_map = capture_first
    try:
        ref_c = R.encode_ref(renderer, ref)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = R.render_rays(renderer, ref_c, que)
        torch.cuda.synchronize()
    finally:
        R.interpolate_feature_map = gather
    t2 = time.perf_counter()
    launches = dict(GA.LAUNCHES_BY_DTYPE)
    if launches != {"f32": 4 * n_chunks + 1, "bf16": 0, "u8": 0}:
        raise RuntimeError(f"{name} exact frame: gather launches {launches}, "
                           f"expected {4 * n_chunks + 1} f32")
    for k, v in out.items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise RuntimeError(f"{name} exact frame: {k} is not finite")
    img = out["pixel_colors_nr_fine"][0].cpu().numpy().reshape(H, W, 3)
    frame_psnr = psnr(img, gt)
    sub = scene_psnr_rays()
    sub_psnr = psnr(img.reshape(-1, 3)[sub], gt.reshape(-1, 3)[sub])
    rays_s = n_rays / (t2 - t1)
    log(f"{name} exact frame (f32, {SCENE_WEIGHTS[name]}): {n_rays} rays, "
        f"encode {t1 - t0:.3f} s, ray loop {t2 - t1:.3f} s = {rays_s:.1f} "
        f"rays/s, gather launches {launches}; GT-PSNR fine {frame_psnr:.3f} "
        f"dB, on the {sub.size} rays of every {SCENE_PSNR_STRIDE}th pixel "
        f"and row {sub_psnr:.4f} dB, the JAX package's (CPU) "
        f"{SCENE_JAX_GT_PSNR[name]:.4f} dB")
    if not abs(sub_psnr - SCENE_JAX_GT_PSNR[name]) <= SCENE_PSNR_TOL:
        raise RuntimeError(f"{name} GT-PSNR {sub_psnr:.4f} dB is "
                           f"{SCENE_PSNR_TOL} dB or more from the JAX "
                           f"package's {SCENE_JAX_GT_PSNR[name]:.4f} dB")
    return renderer, ref, que, gt, out, rays_s, frame_psnr, captured


def scene_auto_frame(GA, R, renderer, ref, que, gt, name):
    """``render_frame_probe_auto`` with focus on the bench route
    (``SCENE_AUTO_PROFILE``, ``SCENE_AUTO_ARGS``) after its encode, the
    renderer's weights: its gather launches held to what its chunk counts
    imply (``expected_fast_launches``; the encode's diff gather f32, the
    rest u8). Returns (its renderer, encoded maps, frame dict, rays/s,
    GT-PSNR, launches)."""
    auto = R.NeurayRenderer(R.RenderConfig(**SCENE_AUTO_PROFILE))
    auto.load_state_dict(renderer.state_dict())
    auto = auto.to(ref["imgs"].device).eval()
    n_rays = que["coords"].shape[1]
    stride = SCENE_AUTO_ARGS["probe_stride"]
    n_probe = -(-H // stride) * -(-W // stride)
    GA.reset_launches()
    t0 = time.perf_counter()
    ref_c = R.encode_ref(auto, ref)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = R.render_frame_probe_auto(auto, ref_c, que, image_hw=(H, W),
                                    focus=True, **SCENE_AUTO_ARGS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(GA.LAUNCHES_BY_DTYPE)
    expected = {"f32": 1, "bf16": 0,
                "u8": expected_fast_launches(out, n_rays, n_probe) - 1}
    img = out["pixel_colors_nr_fine"][0].reshape(H, W, 3)
    if not np.isfinite(img).all():
        raise RuntimeError(f"{name} auto frame is not finite")
    gt_psnr = psnr(img, gt)
    rays_s = n_rays / (t2 - t1)
    log(f"{name} auto_focus frame (bf16 + u8, probe from "
        f"{SCENE_AUTO_PROFILE['probe_sample_num']}, {SCENE_AUTO_ARGS}): "
        f"encode {t1 - t0:.3f} s, probe + audits + render {t2 - t1:.3f} s "
        f"= {rays_s:.1f} rays/s; accepted probe {out['probe_sample_num']}, "
        f"false-skip rate {out['false_skip_rate']:.5f}, window clip "
        f"{out.get('window_clip')}, clip {out.get('window_clip_db')} dB, "
        f"fallback {out['fallback']}, kept {out['kept_rays'] / n_rays:.4f} "
        f"of the rays, GT-PSNR fine {gt_psnr:.3f} dB, gather launches "
        f"{launches} (expected {expected}); audit trail "
        f"{json.dumps(out['audit_trail'])}")
    if launches != expected:
        raise RuntimeError(f"{name} auto frame: gather launches {launches}, "
                           f"expected {expected}")
    return auto, ref_c, out, rays_s, gt_psnr, launches


def replayed_grad_check(model, dev, tree, sample, loss_fn, what):
    """One training step's gradients on the card against the CPU's, from
    the flax tree ``tree`` loaded into ``model``'s config, on ``sample``
    (ref, que: numpy), the card given the CPU's fine depths and diff
    features (as ``grad_check``) and the CPU's masks of every ReLU of the
    step (``relu_tape`` over the whole forward, ``_Seq``'s relu final
    included): each leaf within GRAD_BOUND of its norm plus GRAD_FLOOR
    (``compare_grads``). On weights trained moments before, ReLU inputs
    within rounding of zero flip between the card's and the CPU's f32
    forwards in the ResUNets and also in the vis encoder and the
    aggregation nets (phase 19(d) read 6.9e-3 on a vis encoder leaf with
    the ResUNets' flips under their f64 witness), so only the masks'
    replay leaves the two summation orders to compare. The card's own
    step (its fine depths and masks) is printed beside it, not held."""
    from neuray_tpu_torch.models import init_net as N
    from neuray_tpu_torch.models.renderer import NeurayRenderer
    from neuray_tpu_torch.utils.params import load_flax_params
    F = torch.nn.functional
    trained = NeurayRenderer(model.cfg)
    load_flax_params(trained, tree)
    ref = {k: torch.from_numpy(v) for k, v in sample["ref"].items()}
    diff = N.get_diff_feats(
        ref["imgs"], N.extract_depth_for_init(ref["depth_range"],
                                              ref["depth"]),
        ref["depth_range"], ref["poses"], ref["Ks"])

    def step(device, fine=None, masks=None):
        """(loss, gradients, fine depths, ReLU masks) of the step on
        device, the fine depths and masks replaced where given."""
        renderer = copy.deepcopy(trained).to(device).train()
        for m in renderer.modules():
            if getattr(m, "final", None) is F.relu:
                m.final = lambda x: F.relu(x)
        seen, own = [], renderer._fine_depth

        def fine_depth(*args):
            d = own(*args) if fine is None else fine[len(seen)].to(device)
            seen.append(d.detach().cpu())
            return d

        renderer._fine_depth = fine_depth
        batch = {k: {n: torch.from_numpy(x).to(device) for n, x in v.items()}
                 for k, v in sample.items()}
        used, restore = relu_tape(replay=masks)
        try:
            out = renderer(batch["ref"], batch["que"], True, None,
                           torch.Generator().manual_seed(11))
            total = sum(v.mean() for k, v in loss_fn(out).items()
                        if k.startswith("loss"))
            total.backward()
        finally:
            restore()
        if masks is not None and len(used) != len(masks):
            raise RuntimeError(f"{what}: the card made {len(used)} ReLU "
                               f"calls, the CPU {len(masks)}")
        grads = {n: p.grad.cpu().double()
                 for n, p in renderer.named_parameters() if p.grad is not None}
        return total.item(), grads, seen, used

    own_diff = N.get_diff_feats
    N.get_diff_feats = lambda imgs, *args: diff.to(imgs.device)
    try:
        cpu = step(torch.device("cpu"))
        card = step(dev)
        given = step(dev, cpu[2], cpu[3])
    finally:
        N.get_diff_feats = own_diff
    flips = sum(int((a != b).sum()) for a, b in zip(card[3], cpu[3]))
    compare_grads(card[1], cpu[1], f"{what}, the card's own fine depths and "
                  f"ReLU masks ({flips} elements flipped)", None, False)
    compare_grads(given[1], cpu[1], f"{what}, the card given the CPU's fine "
                  f"depths and ReLU masks")
    log(f"{what}: loss card vs CPU {given[0]:.6f} vs {cpu[0]:.6f}")


# phase 19(d)'s fresh process: the trainer's ``main`` (what ``python -m
# neuray_tpu_torch.make_bench_weights`` runs) on the command's arguments,
# then in the same process the round trip: the written npz read back by
# ``load_params_npz`` into a new model renders a CHUNK-ray chunk of the
# first query view equal, bit for bit, to the trained model in memory with
# its weights rounded to f16 (the file's leaves). The last line a JSON
# record of that, the line before it the trainer's record.
TRAINER_ROUND_TRIP = f"""
import json, sys
import torch
from neuray_tpu_torch import make_bench_weights as MB
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.utils.params import load_flax_params, load_params_npz
model, record = MB.main(sys.argv[1:])
flags = MB.parse_args(sys.argv[1:])
flags.n_que = 1
dev = next(model.parameters()).device
read, ref, _, ques = MB.build(flags, dev)
load_flax_params(read, load_params_npz(record['out']))
model.load_state_dict({{k: v.half().float()
                       for k, v in model.state_dict().items()}})
size = ref['imgs'].shape[1]
xs = torch.arange({CHUNK}, device=dev, dtype=torch.float32)
que = dict(ques[0], coords=torch.stack(
    [xs % size, size * 3 // 8 + xs // size], -1)[None])
with torch.inference_mode():
    a = read.eval().render_chunk(R.encode_ref(read, ref), que)
    b = model.eval().render_chunk(R.encode_ref(model, ref), que)
print(json.dumps({{"rays": {CHUNK}, "rows_from": size * 3 // 8,
                  "equal": {{k: bool(torch.equal(a[k], b[k])) for k in a}}}}))
"""


def start_scene_trainer(work):
    """Start phase 19(d)'s fresh process (``scene_trainer``). Returns the
    job (``start_process``)."""
    work.mkdir(parents=True, exist_ok=True)
    out_npz = work / "bench_weights_blobs.npz"
    out_npz.unlink(missing_ok=True)
    return start_process(
        [sys.executable, "-c", TRAINER_ROUND_TRIP, "--scene", "blobs",
         "--steps", str(TRAIN_SCENE_STEPS), "--out", str(out_npz)], work,
        "trainer", cwd=Path(__file__).resolve().parent)


def scene_trainer(GA, dev, work, job):
    """Phase 19(d): the bench-weights trainer's ``main`` with ``--scene
    blobs`` in a fresh process (``TRAINER_ROUND_TRIP``, started by
    ``start_scene_trainer``; it runs beside phase 20, so its steps/s are
    those of a shared card), cut to
    TRAIN_SCENE_STEPS steps at 400 px: steps/s and the loss printed, its
    gather launches held to 5 forward (the diff, then rgb and the 64-ch map
    in each pass) and 2 backward a step; its npz round trip held bit for
    bit in that process; one step's gradients card vs CPU (``SCENE_GRAD``)
    from the written weights within GRAD_BOUND of each leaf's norm, the
    card given the CPU's fine depths (Queue 3, fault 3), diff features and
    ReLU masks (``replayed_grad_check``; hazard j: the trained file varies
    from run to run with the backward's summation order, and so do the
    ReLU inputs that round across zero). Returns the gather launches of
    the fresh process's run (forward by instantiation, and backward)."""
    import argparse
    from neuray_tpu_torch import make_bench_weights as MB
    from neuray_tpu_torch.train.losses import render_loss
    from neuray_tpu_torch.utils.params import load_params_npz
    code, out, err, wall = finish_process(job)
    if code != 0:
        raise RuntimeError(f"make_bench_weights exited {code}: "
                           f"{err[-3000:]}")
    lines = out.strip().splitlines()
    for line in lines[:-2]:
        log(f"make_bench_weights: {line}")
    record, round_trip = map(json.loads, lines[-2:])
    steps = record["steps"]
    log(f"make_bench_weights --scene blobs in a fresh process (on a card "
        f"shared with phase 20 and phase 18(e)'s CLIs): done in {wall:.1f} s"
        f", {steps} steps at {record['size']} px in "
        f"{record['seconds']:.2f} s = {record['steps_per_s']:.2f} steps/s "
        f"(shared card), "
        f"loss {record['first_loss']:.5f} -> {record['last_loss']:.5f}, "
        f"gather launches {record['gather_launches']} forward, "
        f"{record['backward_launches']} backward")
    want = {"f32": 5 * steps, "bf16": 0, "u8": 0}
    if (record["gather_launches"] != want
            or record["backward_launches"] != 2 * steps):
        raise RuntimeError(f"make_bench_weights gather launches "
                           f"{record['gather_launches']} forward, "
                           f"{record['backward_launches']} backward; "
                           f"expected {want}, {2 * steps}")
    if not np.isfinite([record["first_loss"], record["last_loss"]]).all():
        raise RuntimeError("make_bench_weights: a loss is not finite")
    log(f"make_bench_weights' npz ({record['mb']} MB), read back by "
        f"load_params_npz in its process, renders {round_trip['rays']} rays "
        f"from row {round_trip['rows_from']} equal to the trained model's "
        f"with f16-rounded weights bit for bit: {round_trip['equal']}")
    if not all(round_trip["equal"].values()):
        raise RuntimeError(f"the npz's render differs from the model's: "
                           f"{round_trip['equal']}")
    tree = load_params_npz(str(work / "bench_weights_blobs.npz"))

    # one step's gradients from the written weights
    g_flags = argparse.Namespace(size=SCENE_GRAD["size"], init="depth",
                                 scene="blobs", rays=SCENE_GRAD["rays"],
                                 n_que=1)
    model, ref, _, ques = MB.build(g_flags, torch.device("cpu"),
                                   SCENE_GRAD["dn"])
    sample = {"ref": {k: v.numpy() for k, v in ref.items()},
              "que": {**{k: v.numpy() for k, v in ques[0].items()},
                      "coords": MB.step_coords(np.random.RandomState(7),
                                               SCENE_GRAD["size"],
                                               SCENE_GRAD["rays"])}}
    loss = render_loss(MB.LOSS_CFG)
    replayed_grad_check(model, dev, tree, sample, lambda out: loss(out, {}),
                        f"make_bench_weights step ({SCENE_GRAD}) gradients, "
                        f"card vs CPU")
    return record["gather_launches"], record["backward_launches"]


def scenes_phase(GA, R, dev, work, parent=None):
    """Phase 19: the analytic scenes and the skip renderer's audits on
    them. (a) the blobs: the exact f32 frame (``scene_exact_frame``), then
    ``render_frame_probe_auto`` on the bench route (``scene_auto_frame``),
    its GT-PSNR no more than SCENE_AUTO_GT_TOL below the exact frame's.
    (b) the room with its strong weights: the exact frame, the same auto
    frame, which must reject the windows and fall back to the two-phase
    render, its frame bit-equal to ``render_frame_skip_empty`` on the same
    route; the two-phase frame on the bf16 route and on the bf16 + u8 route
    against the exact f32 frame, each >= BF16_PSNR_FLOOR. (c) the pan
    trajectory (``check_trajectory_escalation``, its defaults): no frame
    before the rods enter accepts a larger probe than frame 0, and the run
    escalates or falls back at or after that frame. Then the
    real-coordinate gathers of the room frame's first chunk and of a pan
    frame timed as forward rows (``kernel_row``). (d), the bench-weights
    trainer (``scene_trainer``), runs beside phase 20. Returns (the gather
    launches of its counted runs by instantiation, the forward rows)."""
    from neuray_tpu_torch import check_trajectory_escalation as TE
    from neuray_tpu_torch.utils.params import load_params_npz
    gc.collect()
    torch.cuda.empty_cache()
    tools = Path(__file__).resolve().parent / "tools"
    counted = []

    # (a) the blobs
    t0 = time.perf_counter()
    weights = load_params_npz(str(tools / SCENE_WEIGHTS["blobs"]))
    renderer, ref, que, gt, _, _, exact_psnr, _ = scene_exact_frame(
        GA, R, dev, "blobs", weights)
    counted.append(dict(GA.LAUNCHES_BY_DTYPE))
    _, _, out, _, auto_psnr, launches = scene_auto_frame(
        GA, R, renderer, ref, que, gt, "blobs")
    counted.append(launches)
    log(f"phase 19(a) blobs: auto frame GT-PSNR {auto_psnr:.3f} dB against "
        f"the exact frame's {exact_psnr:.3f} dB "
        f"({time.perf_counter() - t0:.1f} s)")
    if not auto_psnr >= exact_psnr - SCENE_AUTO_GT_TOL:
        raise RuntimeError(f"blobs auto frame GT-PSNR {auto_psnr:.3f} dB is "
                           f"more than {SCENE_AUTO_GT_TOL} dB below the exact "
                           f"frame's {exact_psnr:.3f}")
    del renderer, ref, que, out

    # (b) the room
    t0 = time.perf_counter()
    weights = load_params_npz(str(tools / SCENE_WEIGHTS["room"]))
    renderer, ref, que, gt, exact, _, exact_psnr, captured = \
        scene_exact_frame(GA, R, dev, "room", weights, capture=True)
    counted.append(dict(GA.LAUNCHES_BY_DTYPE))
    room_map = R.encode_ref(renderer, ref)["feats"]
    auto, ref_c, out, _, auto_psnr, launches = scene_auto_frame(
        GA, R, renderer, ref, que, gt, "room")
    counted.append(launches)
    if out["fallback"] != "two_phase":
        raise RuntimeError(f"room auto frame: fallback {out['fallback']}, "
                           "expected the window audit to reject every probe "
                           "size (two_phase)")
    direct = R.render_frame_skip_empty(auto, ref_c, que,
                                       SCENE_AUTO_ARGS["threshold"])
    same = {k: bool(np.array_equal(out[k], direct[k]))
            for k in ("pixel_colors_nr", "pixel_colors_nr_fine",
                      "keep_mask")}
    exact_img = exact["pixel_colors_nr_fine"][0].cpu().numpy()
    bf16 = R.NeurayRenderer(R.RenderConfig(**{
        **SCENE_AUTO_PROFILE, "gather_quant": "none"}))
    bf16.load_state_dict(renderer.state_dict())
    bf16 = bf16.to(dev).eval()
    two_phase = {"bf16": R.render_frame_skip_empty(
        bf16, R.encode_ref(bf16, ref), que, SCENE_AUTO_ARGS["threshold"]),
        "bf16 + u8": direct}
    vs_f32 = {k: psnr(f["pixel_colors_nr_fine"][0], exact_img)
              for k, f in two_phase.items()}
    kept = {k: f["kept_rays"] / exact_img.shape[0]
            for k, f in two_phase.items()}
    log(f"phase 19(b) room: auto frame equal to render_frame_skip_empty on "
        f"the same route bit for bit {same}; GT-PSNR {auto_psnr:.3f} dB, "
        f"the exact f32 frame's {exact_psnr:.3f} dB; the two-phase frame "
        f"against the exact f32 frame: " + ", ".join(
            f"{k} {v:.3f} dB (kept {kept[k]:.4f})" for k, v in vs_f32.items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    if not all(same.values()):
        raise RuntimeError(f"room auto frame differs from "
                           f"render_frame_skip_empty: {same}")
    if not all(v >= BF16_PSNR_FLOOR for v in vs_f32.values()):
        raise RuntimeError(f"room two-phase frames against f32 {vs_f32} < "
                           f"{BF16_PSNR_FLOOR} dB")
    del renderer, auto, bf16, ref, ref_c, que, out, direct, two_phase, exact

    # (c) the pan trajectory, its first 64-ch map gather kept
    t0 = time.perf_counter()
    gather, pan = R.interpolate_feature_map, []

    def capture_first(feats, *args):
        if feats.shape[-1] == 64 and not pan:
            pan.append((feats, *(a.detach().clone() for a in args[:2]),
                        *args[2:]))
        return gather(feats, *args)

    GA.reset_launches()
    R.interpolate_feature_map = capture_first
    try:
        rows, verdict = TE.run(TE.parse_args([]), dev, log=lambda *a, **k:
                               log(*a))
    finally:
        R.interpolate_feature_map = gather
    counted.append(dict(GA.LAUNCHES_BY_DTYPE))
    first = verdict["first_thin_frame"]
    base = rows[0]["accepted_psn"]
    before = all(r["fallback"] is None and r["accepted_psn"] is not None
                 and r["accepted_psn"] <= base for r in rows[:first or 0])
    after = first is not None and any(
        r["fallback"] or (r["accepted_psn"] or 0) > base
        for r in rows[first:])
    log(f"phase 19(c) pan trajectory: rods first in the frustum at frame "
        f"{first}, accepted {verdict['accepted_sequence']}, fallbacks "
        f"{verdict['fallbacks']}; no larger probe before the rods "
        f"{before}, escalated at or after them {after} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not (before and after):
        raise RuntimeError(f"pan trajectory: {verdict}")

    # the real-coordinate gathers
    fh, fw = room_map.shape[1:3]
    points, mask = captured[0]
    pix = GA.feature_pixel_coords(points, H, W, fh, fw, False)
    what = "room exact frame, first chunk, coarse pass"
    rows = [kernel_row(GA, what, "f32", room_map, "map pixels",
                       (GA.gather_bilinear_border, room_map, pix),
                       (GA.gather_bilinear_border_ref, room_map, pix), pix,
                       False, grid_sample_fn(room_map, pix))]
    args = (room_map, points, mask, H, W, None)
    rows.append(kernel_row(GA, what, "f32", room_map, "fused",
                           (GA.gather_feature_map, *args),
                           (GA.gather_feature_map_ref, *args), pix, True,
                           None))
    feats, points, mask, h, w, dq = pan[0]
    pix = GA.feature_pixel_coords(points, h, w, *feats.shape[1:3], False)
    args = (feats, points, mask, h, w, dq)
    rows.append(kernel_row(GA, "pan frame 0, first chunk's 64-ch gather",
                           "u8", feats, "fused",
                           (GA.gather_feature_map, *args),
                           (GA.gather_feature_map_ref, *args), pix, True,
                           None))
    return counted, rows


# ---------------- processes beside the main path ----------------

def start_process(cmd, out_dir, name, **kw):
    """Start cmd as a process of its own, its stdout and stderr written to
    ``out_dir/<name>.out`` and ``.err`` (a pipe read only at the end
    would fill and stall it), and a thread that notes when it ends.
    Returns the job for ``finish_process``."""
    import threading
    out_dir.mkdir(parents=True, exist_ok=True)
    files = [open(out_dir / f"{name}.{k}", "w") for k in ("out", "err")]
    try:
        proc = subprocess.Popen(cmd, stdout=files[0], stderr=files[1],
                                text=True, **kw)
    except BaseException:
        for f in files:
            f.close()
        raise
    job = SimpleNamespace(proc=proc, files=files, t0=time.perf_counter(),
                          t1=None)

    def watch():
        proc.wait()
        job.t1 = time.perf_counter()

    job.watcher = threading.Thread(target=watch, daemon=True)
    job.watcher.start()
    return job


def stop_process(job):
    """Kill a started process that still runs, and close its files."""
    if job.proc.poll() is None:
        job.proc.kill()
        job.proc.wait()
    for f in job.files:
        f.close()


def finish_process(job, timeout=600):
    """Wait for a started process (killed at the timeout). Returns (its
    exit code, stdout, stderr, seconds from its start to its end)."""
    try:
        job.proc.wait(timeout=timeout)
    finally:
        stop_process(job)
    job.watcher.join()
    out, err = (Path(f.name).read_text() for f in job.files)
    return job.proc.returncode, out, err, job.t1 - job.t0


# ---------------- phase 20: the diagnostic and profiling tools -------------

# the tools in phase 20: their card flags but for depth, and the depth
# set on the parsed namespace (``tool_flags``): one timed call or frame
# each; the skip profiler without its warm-up frame (phases 4-19 warmed
# every kernel of its frames) and, in two-phase mode, without its
# profiled frame (twice a frame's time; the bench default's is kept); 4
# chunks a pass of the stage profiler, one timed pass
TOOLS = {"encode": (["--iters", "1"], {}),
         "skip": (["--iters", "1"], {"warmup": 0, "profile_frames": 0}),
         "focus": (["--focus", "--iters", "1"], {"warmup": 0}),
         "stages": (["--k", "4"], {"iters": 1})}


def tool_flags(module, name):
    """The tool's parsed flags with phase 20's depth (TOOLS)."""
    argv, depth = TOOLS[name]
    flags = module.parse_args(argv)
    vars(flags).update(depth)
    return flags


# profile_stages' card outputs against the CPU's: each gather by ``hold``
# (its name there), the bf16 modules by ``lossy_held``, the rest in f32
# (the projection's coordinates beside their rounding, ``hold_projection``)
STAGE_HOLD = {"gather": "f32", "fused": "bf16", "fused_u8": "u8 fused"}
STAGE_TOL = 1e-4
# the f32 ulps of its terms' summed magnitude by which a camera-space
# coordinate of the projection stage may stray on either device
# (``projection_rounding``)
PROJ_ULPS = 16


def lossy_held(name, card, cpu_bf16, cpu_f32):
    """The lossy-mode rule of tests/test_torch_port_bf16.py with the CPU's
    modules as the references: the card's bf16 output against the CPU's
    f32 twin within 1.5x of the CPU bf16 output's own error against it,
    in mean and max, and the card against the CPU's bf16 within 2x.
    Returns the card-vs-CPU-bf16 max."""
    c, b, f = (x.detach().cpu().double().numpy()
               for x in (card, cpu_bf16, cpu_f32))
    own, ours, d = np.abs(b - f), np.abs(c - f), np.abs(c - b)
    log(f"  {name}: CPU bf16 vs f32 mean {own.mean():.3g} max "
        f"{own.max():.3g}; card bf16 vs CPU f32 mean {ours.mean():.3g} max "
        f"{ours.max():.3g}; card vs CPU bf16 mean {d.mean():.3g} max "
        f"{d.max():.3g}")
    if not (np.isfinite(c).all() and ours.mean() <= 1.5 * own.mean()
            and ours.max() <= 1.5 * own.max() and d.mean() <= 2 * own.mean()
            and d.max() <= 2 * own.max()):
        raise RuntimeError(f"profile_stages {name}: the card's bf16 output "
                           "fails the lossy-mode rule against the CPU's")
    return d.max()


def projection_rounding(poses, Ks, points):
    """Each camera-space coordinate's f32 rounding bound [rfn, pn, 3]:
    PROJ_ULPS f32 ulps of the sum of its terms' magnitudes (K @ pose, then
    its dot with the homogeneous point), from which the card's and the
    CPU's sums may each stray."""
    krt = (Ks.double() @ poses.double()).abs()
    p = torch.cat([points.double().abs(),
                   torch.ones(points.shape[0], 1, dtype=torch.float64)], -1)
    return PROJ_ULPS * 2.0 ** -24 * (krt[:, None] @ p[None, :, :, None])[
        ..., 0]


def hold_projection(card, cpu, size, rounding):
    """The projection stage card vs CPU, each coordinate within
    STAGE_TOL plus its rounding (``projection_rounding``: the division by
    the depth turns the camera-space rounding into (dxy + |xy| dz) / |z|,
    large near a camera plane, where the random poses put some points).
    A point whose |depth| lies within its rounding of the projection's
    degenerate-depth cut (1e-4: the depth is replaced by 1e-3 and the
    point masked) may fall on either side on the two devices: such points
    are counted and left out. The mask equal but where a coordinate lies
    within its bound of the image's edge. Returns the max abs error off
    the cut."""
    dirs, pts, depth, mask = (v.cpu() for v in card)
    d_card, d_cpu = depth[..., 0], cpu[2][..., 0]
    dxy, dz = rounding[..., :2], rounding[..., 2]
    cut = (d_card == 1e-3) != (d_cpu == 1e-3)
    kept_depth = torch.where(d_cpu == 1e-3, d_card, d_cpu)
    if not ((kept_depth.abs() - 1e-4).abs() <= dz)[cut].all():
        raise RuntimeError("profile_stages projection: a point's depth is "
                           "cut on one device and not on the other away "
                           "from the cut")
    ok = ~cut
    pts_bound = STAGE_TOL + ((dxy + cpu[1].abs() * dz[..., None])
                             / d_cpu.abs()[..., None]).float()
    worst = 0.0
    for name, a, b, bound in (("dir", dirs, cpu[0], STAGE_TOL),
                              ("pts", pts, cpu[1], pts_bound),
                              ("depth", depth, cpu[2],
                               STAGE_TOL + dz[..., None].float())):
        err = (a - b).abs()
        worst = max(worst, err[ok].max().item())
        if (err > bound)[ok].any():
            i = ((err > bound) & ok[..., None]).nonzero()[0].tolist()
            raise RuntimeError(f"profile_stages projection {name}: card vs "
                               f"CPU at {i}: {a[tuple(i)].item()} vs "
                               f"{b[tuple(i)].item()}")
    flips = ((mask != cpu[3]) & ok).nonzero(as_tuple=True)
    xy, bound = cpu[1][flips], pts_bound[flips]
    edge = torch.tensor([-0.5, size - 0.5])
    near_edge = (xy[..., None] - edge).abs() <= bound[..., None]
    if not near_edge.flatten(1).any(-1).all():
        raise RuntimeError("profile_stages projection: the card's mask "
                           "differs from the CPU's away from the image edge")
    log(f"  projection: card vs CPU max {worst:.3g} off the depth cut; "
        f"points at the cut {int(cut.sum())}, mask flips at the edge "
        f"{flips[0].numel()}")
    return worst


def check_stages(PT, flags, dev, x):
    """profile_stages' first-chunk card outputs against the CPU's stage
    functions on the same inputs (the gathers against their plain
    versions). Returns the gathers' max abs errors by instantiation."""
    from neuray_tpu_torch.utils.params import load_params_npz
    from neuray_tpu_torch.utils.tool_setup import BENCH_WEIGHTS
    sh = PT.shapes(flags, dev)
    cpu = torch.device("cpu")
    params = load_params_npz(BENCH_WEIGHTS)
    tags = set(x["outputs"])
    plain = PT.build_stages(x["inputs"], sh, tags.__contains__, cpu, params)
    f32 = PT.build_stages(x["inputs"], sh, {"dist", "agg"}.__contains__, cpu,
                          params, dtype=None)
    errors = {}
    with torch.inference_mode():
        for tag, card in x["outputs"].items():
            fn, args = plain[tag]
            ref = fn(*args[0])
            if tag == "proj":
                hold_projection(card, ref, sh.size, projection_rounding(
                    *(torch.from_numpy(x["inputs"][k]) for k in ("poses",
                                                                  "Ks")),
                    torch.from_numpy(x["inputs"]["pts"][0]).reshape(-1, 3)))
            elif tag in STAGE_HOLD:
                name = STAGE_HOLD[tag]
                for a, b in zip(card, ref):
                    err = hold(name, a.cpu(), b)
                    key = name.split()[0]
                    errors[key] = max(errors.get(key, 0.0), err)
                log(f"  {PT.STAGES[tag][0]}: the kernel vs its plain "
                    f"version max {errors[name.split()[0]]:.3g}")
            elif tag in ("dist", "agg"):
                fn32, args32 = f32[tag]
                for i, (a, b, c) in enumerate(zip(card, ref,
                                                  fn32(*args32[0]))):
                    lossy_held(f"{PT.STAGES[tag][0]} output {i}", a, b, c)
            else:
                err = (card.cpu() - ref).abs().max().item()
                log(f"  {PT.STAGES[tag][0]}: card vs CPU max {err:.3g}")
                if not err <= STAGE_TOL:
                    raise RuntimeError(f"profile_stages {tag}: card vs CPU "
                                       f"{err:.3g} > {STAGE_TOL}")
    return errors


def tools_phase(GA, R, dev):
    """Phase 20: the diagnostic and profiling tools on the card, in
    process, at their card defaults (800x800, 8 views, 64 + 64 samples,
    the bench route, ``tools/bench_weights.npz``) but for TOOLS'
    depth, each tool's gather launches held to what its chunk counts
    imply. (a) ``diag_probe_score``: its scores bit-equal to
    ``probe_rays`` and ``render_coarse_rays`` called directly on its
    encode. (b) ``profile_encode``: the staged gather maps bit-equal to
    ``encode_ref``'s; then ``python -m neuray_tpu_torch.profile_encode`` in
    a fresh process, its record's keys and device times. (c)
    ``profile_skip_phases``: the two-phase frame's keep set equal to
    ``render_frame_skip_empty``'s, and with ``--focus`` the merged frame
    bit-equal to ``render_frame_probe_focus`` at its settings, both on the
    tool's encode. (d) ``profile_stages``: each stage's first chunk card
    vs CPU (``check_stages``). Returns (the gather launches of each tool
    by instantiation, the kernel-vs-plain errors of (d) by
    instantiation)."""
    gc.collect()
    torch.cuda.empty_cache()
    # (b)'s fresh process runs beside (a) and (b)
    fresh = start_process(
        [sys.executable, "-m", "neuray_tpu_torch.profile_encode",
         *TOOLS["encode"][0]], Path(__file__).resolve().parent / "build"
        / "chip_smoke" / "tools", "profile_encode",
        cwd=Path(__file__).resolve().parent)
    try:
        return tools_run(GA, R, dev, fresh)
    finally:
        stop_process(fresh)


def tools_run(GA, R, dev, fresh):
    """``tools_phase``'s body; ``fresh``: the job of (b)'s fresh
    process."""
    from neuray_tpu_torch import diag_probe_score as DP
    from neuray_tpu_torch import profile_encode as PE
    from neuray_tpu_torch import profile_skip_phases as PS
    from neuray_tpu_torch import profile_stages as PT
    counted = []

    def launched(what, x, diff, passes=()):
        """Hold the launches since the last reset: ``diff`` f32 diff
        gathers (one an encode) and 2 (rgb, then the 64-ch map) per chunk
        of the ``passes`` (ray counts) on the route of the tool's config
        (``x["renderer"].cfg``)."""
        expected = {"f32": diff, "bf16": 0, "u8": 0}
        if passes:
            cfg = x["renderer"].cfg
            route = ("f32" if not cfg.use_bf16 else
                     "u8" if cfg.gather_quant == "u8" else "bf16")
            expected[route] += 2 * sum(-(-n // cfg.ray_batch_num)
                                       for n in passes)
        got = dict(GA.LAUNCHES_BY_DTYPE)
        if got != expected:
            raise RuntimeError(f"{what}: gather launches {got}, expected "
                               f"{expected}")
        counted.append(got)
        return got

    # (a) the probe-score diagnosis: an encode, the probe and the coarse
    # pass over every ray
    t0 = time.perf_counter()
    GA.reset_launches()
    rec, x = DP.run(DP.parse_args([]), dev)
    n_rays = x["que"]["coords"].shape[1]
    got = launched("diag_probe_score", x, 1, (n_rays, n_rays))
    r, ref_c, que = x["renderer"], x["ref_c"], x["que"]
    probe = R._host(R.probe_rays(r, ref_c, que))[0]
    net = R._host(R.render_coarse_rays(r, ref_c, que, ("hit_prob_nr",))[
        "hit_prob_nr"].sum(-1))[0]
    same = {"probe": bool(np.array_equal(probe, x["probe"])),
            "net": bool(np.array_equal(net, x["net"]))}
    log(f"phase 20(a) diag_probe_score: {json.dumps(rec)}")
    log(f"phase 20(a): scores bit-equal to probe_rays and "
        f"render_coarse_rays on its encode {same}; launches {got} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not all(same.values()):
        raise RuntimeError(f"diag_probe_score's scores differ from direct "
                           f"calls: {same}")
    del x, r, ref_c, que

    # (b) the encode profiler: an f32 diff gather in each call's init net
    # and in its fused encode
    t0 = time.perf_counter()
    GA.reset_launches()
    flags = tool_flags(PE, "encode")
    rec, outputs = PE.run(flags, dev)
    got = launched("profile_encode", None, 2 * (1 + flags.iters))
    staged, fused = outputs["gather_cache"], outputs["fused_encode"]
    same = staged.keys() == fused.keys() and all(
        torch.equal(staged[k], fused[k]) for k in fused)
    log(f"phase 20(b) profile_encode: {json.dumps(rec)}; the staged maps "
        f"bit-equal to encode_ref's {same}; launches {got} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise RuntimeError("profile_encode's staged maps differ from "
                           "encode_ref's")
    del outputs, staged, fused
    code, out, err, seconds = finish_process(fresh)
    if code:
        raise RuntimeError(f"python -m neuray_tpu_torch.profile_encode: exit "
                           f"{code}: {err[-2000:]}")
    fresh = json.loads(out.strip().splitlines()[-1])
    log(f"phase 20(b) python -m neuray_tpu_torch.profile_encode (on a card "
        f"shared with (a), (b), phase 19(d)'s trainer and phase 18(e)'s "
        f"CLIs; its times are a shared card's), done in {seconds:.1f} s: "
        f"{json.dumps(fresh)}")
    if fresh.keys() != rec.keys() or not all(
            fresh[f"{s}_device_ms"] > 0 for s in PE.STAGES):
        raise RuntimeError(f"profile_encode in a fresh process: keys "
                           f"{sorted(fresh)}, expected {sorted(rec)}")

    # (c) the skip profiler: its frames, each an encode and its passes
    for focus in (False, True):
        t0 = time.perf_counter()
        GA.reset_launches()
        flags = tool_flags(PS, "focus" if focus else "skip")
        rec, x = PS.run(flags, dev)
        # the warm-up, the timed and (on the card) the profiled frames
        frames = (flags.warmup + flags.iters
                  + (dev.type == "cuda") * flags.profile_frames)
        kept = rec["kept"]
        r, ref_c, que = x["renderer"], x["ref_c"], x["que"]
        h, w = x["image_hw"]
        if focus:
            n_probe = -(-h // PS.STRIDE) * -(-w // PS.STRIDE)
            got = launched("profile_skip_phases --focus", x, frames,
                           (n_probe, kept, kept) * frames)
            direct = R.render_frame_probe_focus(
                r, ref_c, que, threshold=flags.threshold, image_hw=(h, w),
                dilate=PS.DILATE, probe_stride=PS.STRIDE)
            keys = ("keep_mask", "pixel_colors_nr", "pixel_colors_nr_fine")
        else:
            got = launched("profile_skip_phases", x, frames,
                           (h * w, kept) * frames)
            direct = R.render_frame_skip_empty(r, ref_c, que,
                                               flags.threshold)
            keys = ("keep_mask",)
        same = {k: bool(np.array_equal(x["frame"][k], direct[k]))
                for k in keys}
        what = "--focus" if focus else "two-phase"
        log(f"phase 20(c) profile_skip_phases {what}: {json.dumps(rec)}")
        log(f"phase 20(c) {what}: equal to the driver's frame {same}; "
            f"launches {got} ({time.perf_counter() - t0:.1f} s)")
        if not all(same.values()):
            raise RuntimeError(f"profile_skip_phases {what} differs from the "
                               f"driver's frame: {same}")
        del x, r, ref_c, que, direct

    # (d) the stage profiler: the warm-up, timed and (on the card)
    # profiled passes over its chunks, two gathers a chunk on each map
    t0 = time.perf_counter()
    GA.reset_launches()
    flags = tool_flags(PT, "stages")
    rec, x = PT.run(flags, dev, log=lambda *a, **k: log(*a))
    n = 2 * (1 + flags.iters + (dev.type == "cuda")) * PT.shapes(flags,
                                                                 dev).k
    got = dict(GA.LAUNCHES_BY_DTYPE)
    if got != {"f32": n, "bf16": n, "u8": n}:
        raise RuntimeError(f"profile_stages: gather launches {got}, "
                           f"expected {n} of each map")
    counted.append(got)
    log(f"phase 20(d) profile_stages: {json.dumps(rec)}; launches {got}")
    errors = check_stages(PT, flags, dev, x)
    log(f"phase 20(d): {time.perf_counter() - t0:.1f} s")
    return counted, errors


def load_gather(root):
    """``neuray_tpu_torch/ops/gather.py`` of the checkout at root, as a
    module of its own (it builds its kernel under root/build)."""
    import importlib.util
    path = Path(root).resolve() / "neuray_tpu_torch" / "ops" / "gather.py"
    spec = importlib.util.spec_from_file_location(
        f"gather_{abs(hash(str(path)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit: time "
                    "its backward beside this one's on every backward row")
    ap.add_argument("--grad-sweep", type=int, default=0, metavar="N",
                    help="run only phase 12's gradient check, with its f64 "
                    "witness, on the crops of N clocks (grad_sweep)")
    ap.add_argument("--out", help="--grad-sweep's table, a file")
    ap.add_argument("--sample-seconds", metavar="DIR",
                    help="only time the host's making of dtu_train and "
                    "real_estate samples by DIR's data layer (a checkout "
                    "of an earlier commit) and this one's, in turns "
                    "(sample_seconds_beside)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device")
    t_start = time.perf_counter()
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
    if a.grad_sweep:
        grad_sweep(dev, a.grad_sweep, a.out)
        return
    if a.sample_seconds:
        sample_seconds_beside(Path(a.sample_seconds).resolve())
        return
    parent = None
    if a.parent:
        parent = load_gather(a.parent)
        parent.load_library()
        log(f"parent: {a.parent}'s gather built")

    t0 = time.perf_counter()
    _, kernel_stats = check_kernel(GA, dev)
    backward_stats = check_backward(GA, dev, parent)
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")

    # ---- full frame ----
    t_frame = time.perf_counter()
    rng = np.random.RandomState(0)
    ref_np = make_sphere_scene(rng, RFN, H, W)
    que_np = make_query(rng, H, W, 0, full_image=True)
    gt = que_np.pop("imgs")[0]
    ref = {k: torch.from_numpy(v).to(dev) for k, v in ref_np.items()}
    que = {k: torch.from_numpy(v).to(dev) for k, v in que_np.items()}
    renderer = R.NeurayRenderer(R.RenderConfig(**EXACT_PROFILE))
    weights = load_params_npz(
        str(Path(__file__).resolve().parent / "tools" / "bench_weights.npz"))
    load_flax_params(renderer, weights)
    renderer = renderer.to(dev).eval()
    n_rays = que["coords"].shape[1]
    n_chunks = -(-n_rays // CHUNK)

    t0 = time.perf_counter()
    warm = R.render_full(
        renderer, ref,
        dict(que, coords=que["coords"][:, :WARMUP_CHUNKS * CHUNK]))
    # the frame's outputs, allocated once and freed: the timed frame's
    # concatenations then reuse the allocator's blocks, as they would
    # after a whole warm-up frame
    frame_sized = [torch.empty((1, n_rays) + v.shape[2:], dtype=v.dtype,
                               device=dev) for v in warm.values()]
    del warm, frame_sized
    torch.cuda.synchronize()
    log(f"warm-up ({WARMUP_CHUNKS} chunks and the frame's output "
        f"allocations): {time.perf_counter() - t0:.2f} s")

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
    frame_rays_s = n_rays / (t2 - t1)
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
    log(f"phases 4-5: {time.perf_counter() - t_frame:.1f} s")

    t0 = time.perf_counter()
    counted.append(fast_profile(R, GA, renderer, ref, que, gt, img))
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bench_launches, bench_frame = bench_profile(R, GA, renderer, ref, que,
                                                gt)
    counted += bench_launches
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_launches, backward_launches = train_phase(
        GA, dev, Path(__file__).resolve().parent, weights, parent)
    counted.append(train_launches)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    t0 = time.perf_counter()
    ft_launches, ft_backward, ft_fine, ft_step_s = ft_phase(
        GA, R, dev, work, weights, parent)
    counted.append(ft_launches)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    weights_cv = load_params_npz(str(
        Path(__file__).resolve().parent / "tools" / "bench_weights_cv.npz"))
    t0 = time.perf_counter()
    cv_launches, cv_rows = cv_phase(GA, R, dev, weights_cv)
    counted += cv_launches
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cv_ft_launches, cv_ft_backward, cv_ft_fine, _ = ft_phase(
        GA, R, dev, work, weights_cv, parent, FT_CV_PROFILE, GEN_CV_PROFILE,
        0, False, "finetuning from the cost volume", "phase 11")
    counted.append(cv_ft_launches)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gen_launches, gen_backward, gen_rows, gen_bwd_rows, gen_step_s = \
        gen_cli_phase(GA, R, dev, weights, parent)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cv_cli_launches, cv_cli_backward = cv_cli_phase(GA, R, dev)
    counted += [gen_launches, cv_cli_launches]
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counted.append(cli_phase(GA, R, dev, work, weights))
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fast_launches, fast_backward, fast_rows, fast_bwd_rows = fast_cli_phase(
        GA, R, dev, gen_step_s, parent)
    log(f"phase 15a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    db_launches, db_backward, db_rows, db_bwd_rows = ft_db_phase(
        GA, R, dev, work, weights, ft_step_s, parent)
    log(f"phase 15b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ref_launches = ref_ckpt_phase(GA, R, dev, work, weights, weights_cv)
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dr_launches = dr_phase(GA, R, dev, work, weights, ref, que, gt, out,
                           frame_rays_s)
    log(f"phase 17: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mg_launches = multi_gpu_phase(
        GA, dev, work, weights, out, bench_frame, smi, {
            "frame": n_rays / frame_rays_s,
            "bench": bench_frame["encode"] + bench_frame["render"],
            "gen": gen_step_s, "ft": ft_step_s})
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    scene_launches, scene_rows = scenes_phase(GA, R, dev, work / "scenes")
    log(f"phase 19(a-c): {time.perf_counter() - t0:.1f} s")
    # phase 19(d)'s trainer, phase 14's fresh-process CLI and phase 18(e)'s
    # CLIs, processes of their own, run beside phase 20
    t0 = time.perf_counter()
    jobs = [start_scene_trainer(work / "scenes"),
            start_cli_fresh_process(work, weights)]
    mg_jobs = {}
    try:
        mg_jobs = start_mg_cli(work, weights)
        tools_launches, tools_errors = tools_phase(GA, R, dev)
        log(f"phase 20: {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        train_fwd, scene_backward = scene_trainer(GA, dev, work / "scenes",
                                                  jobs[0])
        cli_fresh_process(work, jobs[1])
        mg_cli(work, mg_jobs, smi)
        log(f"phases 19(d), 14's fresh process and 18(e), after phase 20: "
            f"{time.perf_counter() - t1:.1f} s")
    finally:
        for job in jobs + list(mg_jobs.values()):
            stop_process(job)
    log(f"phases 19(d), 14's fresh process, 18(e) and 20: "
        f"{time.perf_counter() - t0:.1f} s")
    counted += [fast_launches, db_launches, ref_launches, dr_launches,
                mg_launches, *scene_launches, train_fwd, *tools_launches]
    for name in ("f32", "bf16", "u8"):
        kernel_stats[name]["max_abs_err"] = max(
            [kernel_stats[name]["max_abs_err"], tools_errors.get(name, 0.0)]
            + [r["max_abs_err"] for r in cv_rows + gen_rows + fast_rows
               + db_rows + scene_rows if r["dtype"] == name])
    backward_stats["max_abs_err"] = max(
        [backward_stats["max_abs_err"], ft_fine["max_abs_err"],
         cv_ft_fine["max_abs_err"]]
        + [r["max_abs_err"] for r in gen_bwd_rows + fast_bwd_rows
           + db_bwd_rows])

    source = "neuray_tpu_torch/csrc/gather_bilinear_border.cu"
    log(json.dumps({"kernels": [{
        "name": f"gather_bilinear_border_{k}", "route": "cuda",
        "source": source, "replaces": "neuray_tpu/ops/pallas/gather.py:85",
        "launches": sum(c[k] for c in counted),
        **kernel_stats[k]} for k in ("f32", "bf16", "u8")] + [{
        "name": "gather_bilinear_border_backward_f32", "route": "cuda",
        "source": source, "replaces": "neuray_tpu/ops/interpolate.py:115",
        "launches": (backward_launches + ft_backward + cv_ft_backward
                     + gen_backward + cv_cli_backward + fast_backward
                     + db_backward + mg_launches["backward"]
                     + scene_backward),
        **backward_stats,
        "real_ft_fine": {"shape": ft_fine["shape"],
                         "points": ft_fine["points"],
                         "max_abs_err": ft_fine["max_abs_err"],
                         **row_stats(ft_fine)}}]}))
    log(f"chip_smoke.py: the whole run took "
        f"{time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
