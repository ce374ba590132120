"""Per-scene finetuning steps through the port's normal path:
``FtTrainer`` built from the configuration's fields, its state made by
``FtTrainer._start`` (no checkpoint, so ``FtRenderer.init_params`` loads
the generalization model, written from the configuration's weight file,
and draws every view's ``ray_feats`` from its depth init net), then
``FtTrainer.train_step`` on the batches of ``FtTrainer._batches``, as
``FtTrainer.run`` drives them, its logs, validations and saves left out.
``steps_per_s`` is the window's completed steps over its seconds; a step
includes its batch's host work (the query and its views drawn, its rays
drawn from the query view's mask).

The scene: the port's fabricated NeRF-synthetic sphere (``traffic``:
``scene``, ``train_views``, ``size``), written once per checkout under
``build/portbench/ft_scenes/`` by ``write_nerf_synthetic_sphere`` and
read by every later run. The seed picks where the batch stream starts:
the batches (views, rays and fine draws) of a job resumed at step
``seed mod resume_modulus``.

Set-up runs the first three steps (the check's steps, which also warm up
every shape, their fine depths kept); the window's steps go on from the
fourth. The check repeats them in the plain reference (``reference/ft.py``)
from the weight file, the scene's files and the reference's own initial
rows of the views they touch, on the same batches and fine draws, its fine
passes at the program's fine depths: where a ray's coarse hit probability
is flat, rounding alone moves its fine samples (ROADMAP Queue 3 fault 3),
and one such ray reads as far as the TF32 control (PERF.md §4). The fine
depths are compared on their own (``compare``).

The cell's ``traffic``: ``scene``, ``train_views``, ``size``,
``resume_modulus``; a test's workload may add ``route`` (fields over the
configuration's).
"""
from __future__ import annotations

import gc
import os
import shutil
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from pb import core, counts, ft_counts, program
from traffic import train_steps as TS

CHECK_STEPS = 3
BETA1 = 0.9
FAULTS = ("no_consist", "frozen_ray_feats", "shifted_views")
# a ray's fine depths are off where one sample's relative gap passes this
FINE_TOL = 1e-4


def scene_root(tr: Dict) -> Path:
    return (core.ROOT / "build" / "portbench" / "ft_scenes"
            / f"{tr['scene']}_{tr['train_views']}x{tr['size']}")


def write_scene(tr: Dict) -> Path:
    """The scene's folder, written first if this checkout has none (into
    a folder of its own, renamed once whole)."""
    root = scene_root(tr)
    if not (root / "written").exists():
        from neuray_tpu_torch.data.synthetic import (
            write_nerf_synthetic_sphere)
        tmp = root.with_name(f"{root.name}.{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        write_nerf_synthetic_sphere(str(tmp), tr["train_views"], tr["size"],
                                    tr["scene"])
        (tmp / "written").write_text("")
        shutil.rmtree(root, ignore_errors=True)
        os.replace(tmp, root)
    return root


def views_of(batch: Dict) -> List[int]:
    return sorted({int(batch["que_i"]), *map(int, batch["ref_idx"])})


class Side(NamedTuple):
    """One side of the comparison: each step's total loss, the network
    leaves' first gradient and three steps' change (by ``leaf_key``),
    the ``ray_feats`` rows' first gradient and change and their initial
    values (by view), the largest change of a row no check step selected,
    and each step's fine depths drawn from its own coarse pass."""
    losses: List[float]
    grad: Dict[str, torch.Tensor]
    change: Dict[str, torch.Tensor]
    rf_grad: Dict[int, torch.Tensor]
    rf_change: Dict[int, torch.Tensor]
    init: Dict[int, torch.Tensor]
    untouched: float
    fine: List[torch.Tensor]


def rel_gap(a: Dict[int, torch.Tensor], b: Dict[int, torch.Tensor],
            views) -> float:
    """||a - b|| / ||b|| over the rows ``views`` (a row a lacks reads
    0)."""
    num = den = 0.0
    for v in views:
        num += float((a[v] - b[v]).pow(2).sum()) if v in a else float(
            b[v].pow(2).sum())
        den += float(b[v].pow(2).sum())
    return (num / max(den, 1e-300)) ** 0.5


def compare(prog: Side, ref: Side, record: List[Dict]) -> Dict[str, float]:
    """The check's numbers: ``train_steps.compare``'s over the network
    leaves (``loss_gap``, ``grad_gap_median``, ``change_gap_median``,
    ...); ``ray_feats_grad_gap``, the relative L2 gap of the first
    gradient over the rows step 1 selected; ``ray_feats_change_gap``, of
    the three steps' change over the rows they selected;
    ``untouched_change``, the program's largest change of any other row;
    ``init_gap``, of the selected rows' initial values;
    ``fine_depth_off_share``, the share of the steps' rays whose fine
    depths differ by more than ``FINE_TOL`` of the reference's."""
    out = TS.compare(prog.losses, prog.grad, prog.change, ref.losses,
                     ref.grad, ref.change)
    touched = sorted(set().union(*map(views_of, record)))
    out["ray_feats_grad_gap"] = rel_gap(prog.rf_grad, ref.rf_grad,
                                        views_of(record[0]))
    out["ray_feats_change_gap"] = rel_gap(prog.rf_change, ref.rf_change,
                                          touched)
    out["untouched_change"] = prog.untouched
    out["init_gap"] = rel_gap(prog.init, ref.init, touched)
    off = [((a - b).abs() / b.abs()).amax(-1) > FINE_TOL
           for a, b in zip(prog.fine, ref.fine)]
    out["fine_depth_off_share"] = float(torch.cat(off, -1).float().mean())
    return out


def moment(optimizer, p: torch.Tensor) -> torch.Tensor:
    """A parameter's first gradient read back from Adam's first moment
    after one step (zero where the step left it no moment)."""
    state = optimizer.state.get(p, {})
    return (state["exp_avg"].detach() / (1 - BETA1) if "exp_avg" in state
            else torch.zeros_like(p))


def by_leaf(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The FT network's tensors (``net.`` names) keyed by ``leaf_key``."""
    return TS.by_leaf({k[len("net."):]: v for k, v in tensors.items()})


class Steps:
    """The trainer, its batch stream, the record of the check's steps
    and the reference that repeats them."""

    def __init__(self, ctx: core.Ctx, device, build_state: bool = True):
        from neuray_tpu_torch.data import database as DB
        from neuray_tpu_torch.selfcheck import write_gen_checkpoint
        from neuray_tpu_torch.train.ft_trainer import FtTrainer
        from neuray_tpu_torch.utils.params import load_params_npz
        self.device = device
        tr = self.tr = ctx.workload["traffic"]
        program.set_precision()
        torch.zeros(1, device=device)
        ctx.mark("device")
        self.root = write_scene(tr)
        ctx.mark("scene")
        self.weights = ctx.weights_path()
        gen_name = ctx.config["gen_config"]
        gen = core.load_json(core.HERE / "configs" / f"{gen_name}.json")
        gen_cfg = dict(gen["render"], name=gen_name)
        out = core.ROOT / "build" / "portbench" / "ft_out"
        write_gen_checkpoint(out, gen_cfg, load_params_npz(str(self.weights)))
        self.cfg = {**ctx.config["ft_defaults"],
                    **ctx.config["render_defaults"], **ctx.config["train"],
                    **ctx.workload.get("route", {}),
                    "database_name": f"nerf_synthetic/{tr['scene']}/black_800",
                    "gen_cfg": gen_cfg, "output_root": str(out)}
        DB.DATA_ROOT = str(self.root)
        self.trainer = FtTrainer(self.cfg, device)
        ctx.mark("program")
        if build_state:
            step, _ = self.trainer._start()
            if step:
                raise core.Refused(f"{self.trainer.model_dir} holds a "
                                   "checkpoint: the run would resume it")
            program.sync(device)
            ctx.mark("state")
        self.batches = self.trainer._batches(ctx.seed % tr["resume_modulus"])
        self.record: List[Dict] = []
        self.draw_state = None
        self.scene = None

    def next_batch(self, keep: bool = False):
        """The trainer's next batch; ``keep``: recorded for the check
        (with the fine sampler's state before the first)."""
        batch = next(self.batches)
        if keep:
            if self.draw_state is None:
                self.draw_state = self.trainer.generator.get_state()
            ref_idx, que, que_i = batch
            self.record.append({"ref_idx": np.array(ref_idx),
                                "que_i": int(que_i),
                                "coords": que["coords"].detach().clone()})
        return batch

    def draws(self) -> List[torch.Tensor]:
        """The check steps' fine draws, as the trainer's generator makes
        them (one [1, rays, fdn] uniform draw a step)."""
        g = torch.Generator()
        g.set_state(self.draw_state)
        shape = (1, self.record[0]["coords"].shape[1],
                 self.cfg["fine_depth_sample_num"])
        return [torch.rand(shape, generator=g).to(self.device)
                for _ in self.record]

    def reference(self, precision: str = "f32", fault=None,
                  fine=None) -> Side:
        """The check's steps repeated by the plain reference at
        ``precision``, or with a planted ``fault`` (``FAULTS``), its fine
        passes at ``fine`` (each step's fine depths) where given."""
        from reference import ft as FT
        from reference import model as M
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        pr = M.Precision(precision)
        if self.scene is None:
            self.scene = FT.Scene(self.root, self.tr["scene"], self.device)
        n = len(self.scene)
        batches = [dict(b, ref_idx=(b["ref_idx"] + 1) % n)
                   if fault == "shifted_views" else b for b in self.record]
        W = M.load_weights(str(self.weights), self.device)
        views = sorted(set().union(*map(views_of, batches)))
        rows0 = FT.init_ray_feats(W, self.scene, views,
                                  self.cfg["init_view_num"], pr)
        losses, grad, change, rf_grad, rf_change, own = FT.train(
            W, rows0, self.scene, batches, self.draws(),
            self.cfg["lr_cfg"], len(batches),
            self.cfg["depth_sample_num"], self.cfg["fine_depth_sample_num"],
            pr, fault != "no_consist", fault == "frozen_ray_feats", fine)
        touched = set().union(*map(views_of, self.record))
        untouched = max([float(v.abs().max()) for k, v in rf_change.items()
                         if k not in touched], default=0.0)
        return Side(losses, {TS.leaf_key(k): v for k, v in grad.items()},
                    {TS.leaf_key(k): v for k, v in change.items()},
                    rf_grad, rf_change, rows0, untouched, own)


def run(ctx: core.Ctx) -> core.Measured:
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    s = Steps(ctx, device)
    t, ft = s.trainer, s.trainer.ft
    named = {k: p for k, p in ft.named_parameters() if k != "ray_feats"}
    theta0 = {k: p.detach().clone() for k, p in named.items()}
    rows0 = ft.ray_feats.detach().clone()
    p_losses, p_grad, p_rf_grad, p_fine = [], None, None, []
    fine_depth = ft.net._fine_depth

    def kept(*args):
        out = fine_depth(*args)
        p_fine.append(out.detach().clone())
        return out

    ft.net._fine_depth = kept
    for i in range(CHECK_STEPS):
        p_losses.append(t.train_step(s.next_batch(True))["loss_total"])
        if i == 0:
            p_grad = by_leaf({k: moment(t.optimizer, p)
                              for k, p in named.items()})
            first = moment(t.optimizer, ft.ray_feats)
            p_rf_grad = {v: first[v].clone() for v in views_of(s.record[0])}
            del first
    del ft.net._fine_depth
    touched = sorted(set().union(*map(views_of, s.record)))
    p_change = by_leaf({k: p.detach() - theta0[k] for k, p in named.items()})
    rows = ft.ray_feats.detach()
    p_rf_change = {v: rows[v] - rows0[v] for v in touched}
    p_init = {v: rows0[v].clone() for v in touched}
    moved = (rows - rows0).abs_().amax(dim=(1, 2, 3))
    moved[touched] = 0
    untouched = float(moved.max())
    del theta0, rows0, rows, moved
    program.sync(device)
    ctx.mark("3 steps")
    setup_s = ctx.setup_s()
    h, w = ft.ref_store["imgs"].shape[1:3]
    flops = 3 * ft_counts.forward(
        counts.file_shapes(s.weights), len(s.record[0]["ref_idx"]), h, w,
        s.record[0]["coords"].shape[1], s.cfg["depth_sample_num"],
        s.cfg["fine_depth_sample_num"])
    step_s, n_fail = [], 0
    with ctx.window(lambda: program.sync(device)) as win:
        while True:
            t0 = time.perf_counter()
            with win.span("step"):
                out = t.train_step(s.next_batch())
            step_s.append(time.perf_counter() - t0)
            n_fail += not np.isfinite(out["loss_total"])
            if win.elapsed() >= ctx.seconds:
                break
    n = len(step_s)
    prog = Side(p_losses, p_grad, p_change, p_rf_grad, p_rf_change, p_init,
                untouched, p_fine)
    del t, ft, named

    def release():
        s.trainer = s.batches = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def check():
        return compare(prog, s.reference(fine=prog.fine), s.record)

    return core.Measured(
        e2e={"steps_per_s": n / win.seconds}, attempted=n, failed=n_fail,
        setup_s=setup_s, window=win,
        counters={"flops": flops * n, "steps": n}, spans={"step": step_s},
        check=check, release=release)


def recorded_steps(ctx: core.Ctx) -> Steps:
    """The check's batches and fine draws as the program would draw
    them, with no state made and no step run."""
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    s = Steps(ctx, device, build_state=False)
    for _ in range(CHECK_STEPS):
        s.next_batch(True)
    s.trainer = s.batches = None
    return s


def control(ctx: core.Ctx, n_frames: int, against: str):
    """The control's readings: the reference at ``against`` precision in
    the program's place."""
    s = recorded_steps(ctx)
    bad = s.reference(against)
    return compare(bad, s.reference(fine=bad.fine), s.record)


def fault(ctx: core.Ctx, name: str):
    """A fault planted in the reference put in the program's place:
    ``no_consist`` (the consistency loss left out), ``frozen_ray_feats``
    (Adam skips ``ray_feats``), ``shifted_views`` (each step's reference
    views shifted by one)."""
    if name not in FAULTS:
        raise ValueError(name)
    s = recorded_steps(ctx)
    bad = s.reference(fault=name)
    print(f"fault {name}:", file=sys.stderr)
    return compare(bad, s.reference(fine=bad.fine), s.record)
