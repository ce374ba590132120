"""Train the generalization renderer on an analytic scene and save its
weights (port of ``tools/make_bench_weights.py``):

    python -m neuray_tpu_torch.make_bench_weights [--scene sphere|blobs|
        room|pan] [--init depth|cost_volume] [--steps 1500] [--size 400]
        [--rays 512] [--lr 5e-4] [--n-que 16] [--out FILE] [--device cpu]

The skip renderer's gates read the coarse hit probability, which only
separates surface from background once the model has learned the scene:
the quality tools (``check_skip_quality``, ``check_trajectory_escalation``)
render with weights trained here. The recipe is the JAX tool's: 8
reference views of the scene from ``RandomState(0)`` (the poses of
``bench.py``'s frame at any size), ``n_que`` training query views from
``RandomState(100 + i)``, a step of ``rays`` random pixels of query view
``i % n_que`` (coordinates from ``RandomState(7)``), the render loss on
the coarse and fine colours under the ray mask, Adam with optax's
``exponential_decay(lr, steps, 0.05)``. ``--init cost_volume`` trains
the cost-volume config: the refs are their own source views, each with
its 3 nearest other refs by camera centre as ``nn_ids``, and the size is
rounded down to a multiple of 32 (MVSNet's U-Net).

The model starts from flax's initializers (``utils/params.py:
init_like_flax`` under ``torch.manual_seed(0)``); the fine sampler's
draws come from a CPU generator seeded with 7. It trains in f32 with
TF32 off, on the card unless ``--device cpu`` is given, where the size
is capped at 64 px and the samples at 16 + 16 (the JAX tool's ``--cpu``
shapes; the card takes 64 + 64). Every gather and its backward run
through the hand-written kernels on the card.

The weights go to a flax-layout npz (f16 leaves, ``utils/params.py:
save_params_npz``) that the JAX package's ``load_params_npz`` and the
port's both read: by default ``build/bench_weights/bench_weights[_<scene>]
[_cv].npz`` under the checkout, never ``tools/`` (the shipped weights
there belong to the JAX package). The last line is a JSON record: steps,
steps/s, the first and last loss, the gather kernel's launches (forward
by the map's dtype, and backward), the file.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from neuray_tpu_torch.data.synthetic import (
    SCENES, make_query, make_sphere_scene, named_scene)
from neuray_tpu_torch.models.renderer import NeurayRenderer, RenderConfig
from neuray_tpu_torch.ops import gather as GA
from neuray_tpu_torch.train.losses import render_loss
from neuray_tpu_torch.train.trainer import adam_update
from neuray_tpu_torch.utils.device import full_f32, resolve_device
from neuray_tpu_torch.utils.params import (
    init_like_flax, save_params_npz, torch_to_flax)

ROOT = Path(__file__).resolve().parents[1]
LOSS_CFG = {"use_nr_fine_loss": True, "use_ray_mask": True}
LOG_EVERY = 100         # steps between the loss lines


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--rays", type=int, default=512)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--out", default=None,
                    help="the npz to write (default: default_out)")
    ap.add_argument("--scene", default="sphere", choices=SCENES,
                    help="blobs: 5 spheres, one thin (r 0.08); room: the "
                    "blobs inside a textured room sphere, every ray hits "
                    "geometry; pan: the trajectory tool's anchor and rods")
    ap.add_argument("--init", default="depth",
                    choices=["depth", "cost_volume"])
    ap.add_argument("--n-que", type=int, default=16,
                    help="training query views (the room needs more)")
    ap.add_argument("--device", default=None,
                    help="cpu: the small CPU shapes (default: CUDA)")
    return ap.parse_args(argv)


def default_out(scene: str, init: str) -> Path:
    """build/bench_weights/bench_weights[_<scene>][_cv].npz under the
    checkout."""
    name = "bench_weights"
    if scene != "sphere":
        name += f"_{scene}"
    if init == "cost_volume":
        name += "_cv"
    return ROOT / "build" / "bench_weights" / f"{name}.npz"


def lr_at(lr: float, steps: int, step: int) -> float:
    """optax's ``exponential_decay(lr, steps, 0.05)`` at update ``step``
    (0-based, not staircased)."""
    return lr * 0.05 ** (step / steps)


def train_size(size: int, init: str, device: torch.device) -> int:
    """The training views' side: capped at 64 on the CPU, rounded down to
    a multiple of 32 under the cost volume."""
    if device.type == "cpu":
        size = min(size, 64)
    if init == "cost_volume" and size % 32:
        size -= size % 32
    return size


def build(flags, device: torch.device, dn: int | None = None):
    """(renderer, ref, src, ques): the f32 renderer at flax's init on
    device, the 8 reference views (and under the cost volume their
    ``nn_ids`` and the source views ``src``, the refs themselves), and the
    training query views without coords, all as tensors on device. ``dn``:
    the coarse and fine samples (default 16 on the CPU, 64 on the card)."""
    size = train_size(flags.size, flags.init, device)
    if dn is None:
        dn = 16 if device.type == "cpu" else 64
    cfg = RenderConfig(
        init_net_type=flags.init, use_hierarchical_sampling=True,
        depth_sample_num=dn, fine_depth_sample_num=dn,
        ray_batch_num=flags.rays, use_vis=False, fine_use_vis=False)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        renderer = NeurayRenderer(cfg)
        init_like_flax(renderer)
    renderer = renderer.to(device).train()

    spheres, depth_range = named_scene(flags.scene)
    ref_np = make_sphere_scene(np.random.RandomState(0), 8, size, size,
                               spheres, depth_range)
    src = None
    if flags.init == "cost_volume":
        centers = np.stack([-p[:, :3].T @ p[:, 3] for p in ref_np["poses"]])
        ref_np["nn_ids"] = np.stack([
            np.argsort(np.linalg.norm(centers - centers[i], axis=1))[1:4]
            for i in range(len(centers))]).astype(np.int32)
    ref = {k: torch.from_numpy(v).to(device) for k, v in ref_np.items()}
    if flags.init == "cost_volume":
        ref["nn_ids"] = ref["nn_ids"].long()
        src = {k: ref[k] for k in ("imgs", "poses", "Ks", "depth_range")}
    ques = []
    for i in range(flags.n_que):
        q = make_query(np.random.RandomState(100 + i), size, size, 0,
                       spheres=spheres, depth_range=depth_range)
        ques.append({k: torch.from_numpy(v).to(device)
                     for k, v in q.items() if k != "coords"})
    return renderer, ref, src, ques


def step_coords(host_rng: np.random.RandomState, size: int,
                rays: int) -> np.ndarray:
    """One step's query pixels [1, rays, 2] (x, y)."""
    return np.stack([host_rng.randint(0, size, rays),
                     host_rng.randint(0, size, rays)],
                    -1)[None].astype(np.float32)


def train_step(renderer, optimizer, ref, src, que, lr: float,
               generator: torch.Generator):
    """One Adam update at lr on one query batch: the training forward,
    the render loss (coarse + fine colours under the ray mask) and
    ``adam_update``. Returns the loss values; the gradients stay in the
    parameters' ``.grad``."""
    out = renderer(ref, que, True, None, generator, src)
    return adam_update(optimizer, list(renderer.parameters()), lr,
                       render_loss(LOSS_CFG)(out, {}))


def train(flags, device: torch.device, log=print):
    """Train as the module's doc says. Returns (renderer, record); the
    record counts the gather kernel's launches, forward by the map's dtype
    and backward (``ops/gather.py``; none on the CPU)."""
    renderer, ref, src, ques = build(flags, device)
    GA.reset_launches()
    size = ref["imgs"].shape[1]
    params = list(renderer.parameters())
    optimizer = torch.optim.Adam(params, lr=flags.lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    generator = torch.Generator().manual_seed(7)
    host_rng = np.random.RandomState(7)
    losses = []
    t0 = time.perf_counter()
    for i in range(flags.steps):
        que = dict(ques[i % flags.n_que], coords=torch.from_numpy(
            step_coords(host_rng, size, flags.rays)).to(device))
        loss = train_step(renderer, optimizer, ref, src, que,
                          lr_at(flags.lr, flags.steps, i),
                          generator)["loss_total"]
        losses.append(loss)
        if i % LOG_EVERY == 0 or i == flags.steps - 1:
            log(f"step {i:5d} loss {loss:.5f}  "
                f"({time.perf_counter() - t0:.1f}s)", flush=True)
    seconds = time.perf_counter() - t0
    return renderer, {"steps": flags.steps, "size": size,
                      "seconds": seconds,
                      "steps_per_s": flags.steps / seconds,
                      "first_loss": losses[0], "last_loss": losses[-1],
                      "gather_launches": dict(GA.LAUNCHES_BY_DTYPE),
                      "backward_launches": GA.BACKWARD_LAUNCHES}


def main(argv=None):
    """Train, write the npz and print the record. Returns (the trained
    renderer, the record)."""
    flags = parse_args(argv)
    full_f32()
    device = resolve_device(flags.device)
    out = Path(flags.out) if flags.out else default_out(flags.scene,
                                                         flags.init)
    renderer, record = train(flags, device)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_params_npz(str(out), torch_to_flax(renderer))
    record.update(scene=flags.scene, init=flags.init, out=str(out),
                  mb=round(out.stat().st_size / 1e6, 1))
    print(json.dumps(record), flush=True)
    return renderer, record


if __name__ == "__main__":
    main()
