"""Generalization training steps through the port's
``Trainer.train_step`` (forward, losses, backward through the gather
kernel's hand-written backward, Adam), on a pool of synthetic sphere
samples made from the seed and staged on the card during set-up, taken
in turn; ``steps_per_s`` is the window's completed steps over its
seconds.

Set-up builds the one trainer, loads the configuration's weights into
it by the port's loader, seeds its fine sampler's generator, and drives
its first three steps (samples 0, 1, 2: the check's steps, which also
warm up every shape); the window's steps go on from there. The check
repeats those three steps in the plain reference and compares each
step's loss, each leaf's first gradient (read back from Adam's first
moment after one step) and each leaf's change over the three steps
(``compare``).

The cell's ``traffic``: ``pool``, ``views``, ``view_hw``, ``rays``,
``depth_pixels``.
"""
from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from pb import core, counts, program, scene

CHECK_STEPS = 3
BETA1 = 0.9


def make_pool(rng: np.random.Generator, tr: Dict, device) -> List[Dict]:
    """``pool`` training samples: the views of the sphere with their true
    depth, a query view's ``rays`` random pixels and its image, and
    ``depth_pixels`` random pixels a view for the depth loss."""
    h, w = tr["view_hw"]
    v = tr["views"]
    out = []
    for _ in range(tr["pool"]):
        ref = scene.make_views(rng, v, h, w, device)
        ref["true_depth"] = ref["depth"]
        qp, qk, _ = scene.make_queries(rng, 1, h, w, device)
        img, _ = scene.render_views(qp, qk, h, w)
        px = np.stack([rng.integers(0, w, tr["rays"]),
                       rng.integers(0, h, tr["rays"])], -1)[None]
        dl = np.stack([rng.integers(0, w, (v, tr["depth_pixels"])),
                       rng.integers(0, h, (v, tr["depth_pixels"]))], -1)
        que = {"coords": torch.from_numpy(px).float().to(device),
               "poses": qp, "Ks": qk, "imgs": img,
               "depth_range": torch.tensor([scene.DEPTH_RANGE],
                                           device=device)}
        out.append({"ref": ref, "que": que,
                    "depth_loss_coords": torch.from_numpy(dl).float().to(
                        device),
                    "is_gso": torch.zeros([], device=device)})
    return out


def step_counts(S, tr):
    """A step's FLOPs (three times the forward) and backward gather
    bytes (the coarse and fine passes' 64-channel map, the depth head's
    32-channel one)."""
    v, (h, w), rays, px = (tr["views"], tr["view_hw"], tr["rays"],
                           tr["depth_pixels"])
    fwd = (counts.encode(S, v, h, w, False)
           + counts.render_pass(S, rays, 64, v, False)
           + counts.render_pass(S, rays, 64, v, True)
           + counts.depth_head(S, v, px))
    fh, fw = h // 4, w // 4
    bwd = (2 * counts.gather_backward_bytes(v, rays * 64, 64, fh, fw)
           + counts.gather_backward_bytes(v, px, 32, fh, fw))
    return {"flops": 3 * fwd, "gather_bwd_bytes": bwd, "steps": 1}


def flax_name(torch_name: str) -> str:
    """The port's parameter name -> the weight file's flax path (the
    leaf's kind does not matter: only norms are compared)."""
    *mods, leaf = torch_name.split(".")
    return "/".join(["params", *mods, leaf])


def by_leaf(tensors: Dict[str, torch.Tensor]):
    """The port's per-parameter tensors keyed by ``leaf_key``."""
    return {leaf_key(flax_name(k)): v for k, v in tensors.items()}


def leaf_key(path: str) -> str:
    """A leaf's key independent of the naming of its kind: the module
    path without flax's ``Conv_0`` level, and ``w`` for a kernel, a
    weight or a scale."""
    parts = [p for p in path.split("/") if p != "Conv_0"]
    if parts[-1] in ("kernel", "weight", "scale"):
        parts[-1] = "w"
    return "/".join(parts)


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep) -> Dict[str, float]:
    """Each leaf's gap between the program's and the reference's norm, of
    the leaves ``keep``, against the larger of the leaf's reference norm
    and the median leaf's."""
    norms = {k: float(ref[k].norm()) for k in keep}
    med = statistics.median(norms.values())
    return {k: abs(float(prog[k].norm()) - norms[k])
            / max(norms[k], med, 1e-30) for k in keep}


def compare(p_losses, p_grad, p_change, r_losses, r_grad, r_change
            ) -> Dict[str, float]:
    """The check's numbers: the widest relative gap of the three steps'
    losses (``loss_gap``), and over the leaves the gaps of the first
    gradient's and of the change's norm, each leaf's against the larger
    of its reference norm and the median leaf's: the 90th percentile
    leaf's (``grad_gap_p90``, ``change_gap_p90``), the median's and,
    read for the record, the worst leaf's (``grad_gap``, ``change_gap``:
    a small norm bias or a kernel under a ReLU that rounds across zero,
    ROADMAP hazard j, reads as far for the program as for its TF32
    control); the worst leaves are printed to standard error."""
    ref_norms = {k: float(v.norm()) for k, v in r_grad.items()}
    med = statistics.median(ref_norms.values())
    # leaves whose reference gradient is nought to rounding (a conv bias
    # under an instance norm) move under Adam by round-off alone
    keep = [k for k, n in ref_norms.items() if n >= 1e-3 * med]
    loss = [abs(a - b) / abs(b) for a, b in zip(p_losses, r_losses)]
    grad = leaf_gaps(p_grad, r_grad, keep)
    change = leaf_gaps(p_change, r_change, keep)
    for name, gaps in (("grad", grad), ("change", change)):
        worst = sorted(gaps, key=gaps.get)[-2:]
        print(f"{name}_gap worst leaves: "
              + ", ".join(f"{k} {gaps[k]:.3g}" for k in worst),
              file=sys.stderr)
    out = {"loss_gap": max(loss), "loss_gap_first": loss[0]}
    for name, gaps in (("grad", grad), ("change", change)):
        v = sorted(gaps.values())
        out[f"{name}_gap"] = v[-1]
        out[f"{name}_gap_median"] = statistics.median(v)
        out[f"{name}_gap_p90"] = v[int(0.9 * (len(v) - 1))]
    return out


class Steps:
    """The trainer, its pool and the seed of its fine draws."""

    def __init__(self, ctx: core.Ctx, device, build_program=True):
        from neuray_tpu_torch.train.trainer import Trainer
        self.ctx, self.device = ctx, device
        tr = self.tr = ctx.workload["traffic"]
        program.set_precision()
        torch.zeros(1, device=device)
        ctx.mark("device")
        rng = np.random.default_rng(ctx.seed)
        self.pool = make_pool(rng, tr, device)
        program.sync(device)
        ctx.mark("samples")
        self.draw_seed = int(rng.integers(0, 2 ** 62))
        self.weights = ctx.weights_path()
        self.lr = ctx.config["train"]["lr_cfg"]["lr_init"]
        if not build_program:
            return
        h, w = tr["view_hw"]
        cfg = dict(ctx.config["train"], train_dataset_type="synthetic",
                   train_dataset_cfg={"rfn": tr["views"], "h": h, "w": w},
                   val_metric=["psnr_ssim"], worker_num=0,
                   output_root=str(core.ROOT / "build" / "portbench"))
        cfg.update(ctx.workload.get("route", {}))
        self.trainer = Trainer(cfg, device=device)
        from neuray_tpu_torch.utils.params import (load_flax_params,
                                                   load_params_npz)
        load_flax_params(self.trainer.renderer,
                         load_params_npz(str(self.weights)))
        self.trainer.generator.manual_seed(self.draw_seed)
        ctx.mark("program")

    def draws(self, n):
        """The fine sampler's first n steps' draws, as the trainer's
        generator makes them (one [1, rays, 64] uniform draw a step)."""
        g = torch.Generator().manual_seed(self.draw_seed)
        return [torch.rand((1, self.tr["rays"], 64), generator=g).to(
            self.device) for _ in range(n)]

    def reference(self, keep_rays=None, precision="f32"):
        from reference import model as M
        from reference import train as T
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        W = M.load_weights(str(self.weights), self.device)
        losses, grad, change = T.train(
            W, self.pool[:CHECK_STEPS], self.draws(CHECK_STEPS), self.lr,
            CHECK_STEPS, keep_rays, M.Precision(precision))
        key = {k: leaf_key(k) for k in W}
        return (losses, {key[k]: v for k, v in grad.items()},
                {key[k]: v for k, v in change.items()})


def run(ctx: core.Ctx) -> core.Measured:
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    s = Steps(ctx, device)
    t = s.trainer
    named = dict(t.renderer.named_parameters())
    theta0 = {k: p.detach().clone() for k, p in named.items()}
    p_losses, p_grad = [], None
    for i in range(CHECK_STEPS):
        p_losses.append(t.train_step(s.pool[i])["loss_total"])
        if i == 0:
            state = t.optimizer.state
            # a step that moved no moment leaves no gradient to read
            p_grad = by_leaf({
                k: state[p]["exp_avg"].detach() / (1 - BETA1)
                if "exp_avg" in state.get(p, {}) else torch.zeros_like(p)
                for k, p in named.items()})
    p_change = by_leaf({k: p.detach() - theta0[k]
                                    for k, p in named.items()})
    del theta0
    program.sync(device)
    ctx.mark("3 steps")
    setup_s = ctx.setup_s()
    per_step = step_counts(counts.file_shapes(s.weights), s.tr)
    step_s, n_fail = [], 0
    with ctx.window(lambda: program.sync(device)) as win:
        i = CHECK_STEPS
        while True:
            t0 = time.perf_counter()
            with win.span("step"):
                out = t.train_step(s.pool[i % len(s.pool)])
            step_s.append(time.perf_counter() - t0)
            n_fail += not np.isfinite(out["loss_total"])
            i += 1
            if win.elapsed() >= ctx.seconds:
                break
    n = len(step_s)
    cnt = {k: v * n for k, v in per_step.items()}

    def release():
        s.trainer = None
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def check():
        r = s.reference()
        return compare(p_losses, p_grad, p_change, *r)

    return core.Measured(
        e2e={"steps_per_s": n / win.seconds}, attempted=n, failed=n_fail,
        setup_s=setup_s, window=win, counters=cnt, spans={"step": step_s},
        check=check, release=release)


def control(ctx: core.Ctx, n_frames: int, against: str):
    """The control's readings: the reference at ``against`` precision in
    the program's place."""
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    s = Steps(ctx, device, build_program=False)
    return compare(*s.reference(precision=against), *s.reference())


def fault(ctx: core.Ctx, name: str):
    """A fault planted in the reference put in the program's place:
    ``half_batch`` (the losses over the first half of the rays), or
    ``unchanged`` (a step that leaves the state as it was)."""
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    s = Steps(ctx, device, build_program=False)
    good = s.reference()
    if name == "half_batch":
        bad = s.reference(keep_rays=s.tr["rays"] // 2)
    elif name == "unchanged":
        bad = (good[0], good[1], {k: torch.zeros_like(v)
                                  for k, v in good[2].items()})
    else:
        raise ValueError(name)
    return compare(*bad, *good)
