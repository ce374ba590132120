"""Generalization training: a step-based loop with Adam, checkpoint and
resume, periodic validation, best-model selection and txt logs (port of
``neuray_tpu/train/trainer.py``; reference train/trainer.py and
train/train_valid.py). ``BaseTrainer`` holds what it shares with the
finetuning trainer (``train/ft_trainer.py``).

On more than one rank (``torchrun``, or a ``mesh`` from
``parallel.sharding.make_mesh``) training is data-parallel, as the JAX
trainer's ``pmap`` step: rank r takes samples r, r + size, r + 2 size,
... of the index order, one a step, and the gradients and loss values
are averaged over the ranks before Adam (``average_gradients``, one
``all_reduce`` a step), so the parameters stay the same on every rank.
Rank 0 alone writes checkpoints, logs and ``vis_val`` images and keeps
the best model; a resumed state is rank 0's, broadcast; validation
renders shard the rays over every rank (``make_sharded_render_fn``) and
rank 0 scores them. ``n_devices``, when set, must be the world size. The
JAX trainer stacks same-shape samples for ``pmap`` (``_collect_batch``);
ranks here build their own graphs, so that is not ported.

What differs from the JAX trainer:
  * the device (``device``: CUDA unless the caller asks for the CPU;
    ``cuda:LOCAL_RANK`` on several ranks);
  * ``torch.optim.Adam`` with optax's defaults (betas 0.9 / 0.999, eps
    1e-8), its learning rate set before every update from the schedule at
    the update count, as optax counts; a parameter without a gradient gets
    a zero one, so every Adam moment moves as optax's does;
  * samples come in index order from ``torch.utils.data.DataLoader``
    (``worker_num`` spawned processes; 0 loads in this process), not from
    the JAX trainer's Prefetcher;
  * the fine sampler's draws come from a CPU ``torch.Generator`` seeded
    with 7 (7 + rank on several ranks), so a run on the card and one on
    the CPU draw the same u;
  * checkpoints are ``torch.save`` files (``ckpt.pt``, ``ckpt_best.pt``)
    of the step, the best metric, the parameters and the optimizer state.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterable, Iterator

import numpy as np
import torch
import torch.nn as nn

from neuray_tpu_torch.data.train_dataset import name2dataset
from neuray_tpu_torch.models.renderer import NeurayRenderer, RenderConfig
from neuray_tpu_torch.parallel import sharding as P
from neuray_tpu_torch.train.losses import build_losses
from neuray_tpu_torch.train.lr import name2lr_manager
from neuray_tpu_torch.train.metrics import name2key_metrics, name2metrics
from neuray_tpu_torch.utils.device import resolve_device
from neuray_tpu_torch.utils.params import init_like_flax
from neuray_tpu_torch.utils.profiling import count, recording, span

# the bytes an Adam step must move a parameter, whatever implements it:
# the parameter and its two moments, each f32, read and written once (the
# gradient's read is left out: a fused update need not materialise it)
ADAM_BYTES = 24

VAL_KEEP = ("pixel_colors_nr", "pixel_colors_nr_fine", "pixel_colors_dr",
            "pixel_colors_dr_fine")


def sample_loader(dataset, order, workers: int,
                  pin_memory: bool = False) -> Iterator[Any]:
    """The samples ``dataset[i]`` for i in ``order``, in order: made by
    ``workers`` spawned ``DataLoader`` processes, or in this one for 0
    (the trainers' loader; ``bench_input_pipeline`` times it)."""
    if workers == 0:
        return (dataset[i] for i in order)
    return iter(torch.utils.data.DataLoader(
        dataset, batch_size=None, sampler=order, num_workers=workers,
        multiprocessing_context="spawn", pin_memory=pin_memory))


class Logger:
    """Scalars appended to ``<model_dir>/<prefix>.txt`` (nothing where not
    ``enabled``: the ranks other than 0)."""

    def __init__(self, model_dir: str, enabled: bool = True):
        if enabled:
            os.makedirs(model_dir, exist_ok=True)
        self.model_dir = model_dir
        self.enabled = enabled

    def log(self, data: Dict[str, float], prefix: str, step: int,
            verbose: bool = False):
        if not self.enabled:
            return
        msg = f"{prefix} step {step} " + " ".join(
            f"{k} {float(v):.5f}" for k, v in data.items())
        with open(f"{self.model_dir}/{prefix}.txt", "a") as f:
            f.write(msg + "\n")
        if verbose:
            print(msg, flush=True)


class BaseTrainer:
    """What the generalization and the finetuning trainer share: the
    config, the device, the logger, the schedule, the losses, the val
    metrics, one ``torch.optim.Adam`` over ``model``'s parameters,
    ``torch.save`` checkpoints with a strict resume, and the loop of
    steps, logs, validations, best-model selection and saves.

    A subclass sets ``model`` (the module whose state is saved and whose
    parameters are trained) and supplies ``_init_state`` (a fresh state,
    with no checkpoint to resume), ``_load_state`` (a checkpoint's
    ``params``), ``_batches`` (the batches from a step to ``total_step``),
    ``_losses`` (a batch -> its losses) and ``_val_sets`` (each val set's
    log name, the name of its ``vis_img`` folder and its views'
    outputs). On several ranks (``mesh``) the module docstring's rules
    hold: rank 0 writes, the gradients are averaged."""

    default_cfg: Dict[str, Any] = {}
    # also validate at the last step (the gen trainer does; finetuning
    # validates only every val_interval steps, as in the JAX package)
    val_at_last_step = False

    def __init__(self, cfg: Dict[str, Any], device=None,
                 mesh: P.Mesh | None = None):
        self.cfg = {**self.default_cfg, **cfg}
        unknown = set(self.cfg["val_metric"]) - set(name2metrics)
        if unknown:
            raise NotImplementedError(f"val metrics {sorted(unknown)} are "
                                      "not ported yet")
        self.mesh = (mesh if mesh is not None
                     else P.make_mesh(resolve_device(device)))
        n = self.cfg["n_devices"]
        if n and n != self.mesh.size:
            raise ValueError(
                f"n_devices is {n} but this run has {self.mesh.size} "
                f"rank(s): launch it with torchrun --nproc_per_node {n} -m "
                "neuray_tpu_torch.run_training --cfg <config>")
        self.device = self.mesh.device
        self.model_dir = f'{self.cfg["output_root"]}/{self.cfg["name"]}'
        self.logger = Logger(self.model_dir, self.mesh.is_main)
        self.schedule = name2lr_manager[self.cfg["lr_type"]](
            self.cfg["lr_cfg"])
        self.loss_fn = build_losses(self.cfg)
        self.val_metrics = [name2metrics[m](self.cfg)
                            for m in self.cfg["val_metric"]]
        self.key_metric = name2key_metrics[self.cfg["key_metric_name"]]
        self.generator = torch.Generator()
        self.optimizer = None
        self.opt_count = 0       # Adam updates made with this state

    # ---------------- state ----------------

    def build_optimizer(self) -> None:
        """A fresh Adam over ``model``'s parameters as they stand."""
        self.params = list(self.model.parameters())
        self.optimizer = torch.optim.Adam(self.params, lr=self.schedule(0),
                                          betas=(0.9, 0.999), eps=1e-8)
        self.opt_count = 0

    def _save(self, step: int, best_metric: float, path: str = "ckpt.pt"):
        if not self.mesh.is_main:
            return
        torch.save({"step": int(step), "best_metric": float(best_metric),
                    "params": self.model.state_dict(),
                    "opt_state": self.optimizer.state_dict(),
                    "opt_count": self.opt_count},
                   f"{self.model_dir}/{path}")

    def _start(self) -> tuple[int, float]:
        """Resume from ``ckpt.pt`` if there is one (its optimizer state
        strictly unless ``resume_reset_opt``), else a fresh state; then a
        fresh optimizer. On several ranks the checkpoint is rank 0's,
        broadcast, and a fresh state is rank 0's too. Returns (step, best
        metric)."""
        path = f"{self.model_dir}/ckpt.pt"
        restored = None
        if self.mesh.is_main and os.path.exists(path):
            restored = torch.load(path, map_location="cpu",
                                  weights_only=True)
        restored = self.mesh.broadcast_object(restored)
        if restored is None:
            self._init_state()
            P.broadcast_module(self.model, self.mesh)
            self.build_optimizer()
            return 0, -1e9
        self._load_state(restored["params"])
        self.build_optimizer()
        if _restore_opt_state(self.optimizer, restored["opt_state"],
                              strict=not self.cfg.get("resume_reset_opt",
                                                      False)):
            self.opt_count = restored["opt_count"]
        step = int(restored["step"])
        if self.mesh.is_main:
            print(f"resumed from step {step}", flush=True)
        return step, float(restored["best_metric"])

    def _init_state(self) -> None:
        raise NotImplementedError

    def _load_state(self, params: Dict[str, torch.Tensor]) -> None:
        raise NotImplementedError

    # ---------------- steps ----------------

    def _batches(self, step: int) -> Iterator[Any]:
        raise NotImplementedError

    def _losses(self, batch) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def train_step(self, batch) -> Dict[str, float]:
        """One Adam update on one batch: the training forward and losses
        (``_losses``), total = the sum of the means of the ``loss*``
        entries, backward, step. Returns each loss's mean and
        ``loss_total``. The forward and losses are the span
        ``step.forward`` (``utils/profiling.py``)."""
        with span("step.forward"):
            losses = self._losses(batch)
        metrics = adam_update(self.optimizer, self.params,
                              self.schedule(self.opt_count), losses,
                              self.mesh, self.loss_fn.names)
        self.opt_count += 1
        return metrics

    # ---------------- main loop ----------------

    def run(self) -> nn.Module:
        cfg = self.cfg
        step, best_metric = self._start()
        if step == 0 and cfg.get("validate_initialization", False):
            self.validate(0)
        train_results: Dict[str, list] = {}
        t0 = time.time()
        for batch in self._batches(step):
            metrics = self.train_step(batch)
            step += 1
            for k, v in metrics.items():
                train_results.setdefault(k, []).append(v)

            if step % cfg["train_log_step"] == 0:
                logs = {k: float(np.mean(v))
                        for k, v in train_results.items()}
                logs["steps_per_sec"] = cfg["train_log_step"] / (
                    time.time() - t0)
                self.logger.log(logs, "train", step, verbose=True)
                train_results = {}
                t0 = time.time()

            if step % cfg["val_interval"] == 0 or (
                    self.val_at_last_step and step == cfg["total_step"]):
                val_metric = self.validate(step)
                if val_metric is not None and val_metric > best_metric:
                    best_metric = val_metric
                    self._save(step, best_metric, "ckpt_best.pt")
                t0 = time.time()

            if step % cfg["save_interval"] == 0:
                self._save(step, best_metric)
        self._save(step, best_metric)
        return self.model

    # ---------------- validation ----------------

    def _val_sets(self) -> Iterator[tuple]:
        raise NotImplementedError

    def validate(self, step: int):
        """Each val set's views (``_val_sets``: outputs as numpy with
        ``pixel_colors_gt``, and the image's (h, w)) through the val
        metrics (``vis_img`` writes under ``<model_dir>/vis_val``); log
        their means to ``<name>.txt`` and return the key metric of the last
        set (None without val sets). Every rank renders the views; rank 0
        scores them (None on the others)."""
        key_vals = []
        for name, vis_name, views in self._val_sets():
            results: Dict[str, list] = {}
            t0 = time.time()
            for i, (outputs, que_shape) in enumerate(views):
                if not self.mesh.is_main:
                    continue
                for metric in self.val_metrics:
                    for k, v in metric(
                            outputs, {"que_shape": que_shape}, step,
                            data_index=i, model_name=vis_name,
                            output_root=f"{self.model_dir}/vis_val").items():
                        results.setdefault(k, []).append(v)
            if not results:
                continue
            logs = {k: float(np.mean(np.concatenate(v)))
                    for k, v in results.items()}
            logs["eval_time"] = time.time() - t0
            self.logger.log(logs, name, step, verbose=True)
            key_vals.append(self.key_metric(
                {k: np.concatenate(v) for k, v in results.items()}))
        return key_vals[-1] if key_vals else None


class Trainer(BaseTrainer):
    default_cfg = {
        "name": "neuray_tpu_model",
        "total_step": 400000,
        "train_log_step": 20,
        "val_interval": 10000,
        "save_interval": 500,
        "lr_type": "exp_decay",
        "lr_cfg": {"lr_init": 1.0e-4, "decay_step": 100000,
                   "decay_rate": 0.5},
        "loss": ["render"],
        "val_metric": ["psnr_ssim"],
        "key_metric_name": "psnr_nr",
        "train_dataset_type": "gen",
        "train_dataset_cfg": {},
        "val_set_list": [],
        "output_root": "data/model",
        "n_devices": None,
        "worker_num": 8,
    }
    val_at_last_step = True

    def __init__(self, cfg: Dict[str, Any], device=None,
                 mesh: P.Mesh | None = None):
        super().__init__(cfg, device, mesh)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.renderer = NeurayRenderer(RenderConfig.from_cfg(self.cfg))
            init_like_flax(self.renderer)
        self.renderer.to(self.device).train()
        self.build_optimizer()

        dataset_type = self.cfg["train_dataset_type"]
        if dataset_type not in name2dataset:
            raise NotImplementedError(f"train dataset {dataset_type!r} is "
                                      "not ported yet")
        self.train_dataset = name2dataset[dataset_type](
            self.cfg.get("train_dataset_cfg", {}), True)
        self._val_datasets: Dict[str, Any] = {}

    @property
    def model(self) -> NeurayRenderer:
        return self.renderer

    # ---------------- state ----------------

    def _init_state(self) -> None:
        """The trainer's own init, made when it was built."""

    def _load_state(self, params: Dict[str, torch.Tensor]) -> None:
        self.renderer.load_state_dict(params)

    # ---------------- steps ----------------

    def _samples(self, n: int) -> Iterator[Dict[str, Any]]:
        """This rank's n training samples of the index order (from 0,
        wrapping at the dataset's length): rank r of size takes r,
        r + size, ...; made by ``worker_num`` spawned processes, or in
        this one for 0."""
        size, rank = self.mesh.size, self.mesh.rank
        order = [(i * size + rank) % len(self.train_dataset)
                 for i in range(n)]
        return sample_loader(self.train_dataset, order,
                             self.cfg["worker_num"],
                             self.device.type == "cuda")

    def _batches(self, step: int) -> Iterator[Dict[str, Any]]:
        self.generator.manual_seed(7 + self.mesh.rank)
        for sample in self._samples(max(self.cfg["total_step"] - step, 0)):
            yield self.to_device(sample)

    def to_device(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        """A sample's arrays as tensors on the training device (the
        scene name dropped)."""
        def move(x):
            if isinstance(x, dict):
                return {k: move(v) for k, v in x.items()}
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            if isinstance(x, torch.Tensor):
                return x.to(self.device, non_blocking=True)
            return x
        return {k: move(v) for k, v in sample.items() if k != "scene_name"}

    def _losses(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The training forward of one sample (tensors on the device)
        and its losses."""
        outputs = self.renderer(batch["ref"], batch["que"], True,
                                batch.get("depth_loss_coords"),
                                self.generator, batch.get("src"))
        return self.loss_fn(outputs, batch)

    # ---------------- validation ----------------

    def _val_sets(self):
        """Every view of each val set rendered with ``render_full``; logged
        to ``val-<name>.txt``, its ``vis_img`` dumps under
        ``<model name>-<name>``."""
        for val_set in self.cfg["val_set_list"]:
            name = val_set["name"]
            if name not in self._val_datasets:
                self._val_datasets[name] = name2dataset[val_set["type"]](
                    {**val_set.get("cfg", {})}, False)
            yield (f"val-{name}", f'{self.cfg["name"]}-{name}',
                   self._val_views(self._val_datasets[name]))

    def _val_views(self, dataset):
        render = P.make_sharded_render_fn(self.renderer, self.mesh, VAL_KEEP)
        for i in range(len(dataset)):
            sample = self.to_device(dataset[i])
            que = {k: v for k, v in sample["que"].items() if k != "imgs"}
            outputs = {k: v.cpu().numpy() for k, v in render(
                sample["ref"], que, sample.get("src")).items()}
            imgs = sample["que"]["imgs"]
            outputs["pixel_colors_gt"] = imgs.reshape(1, -1, 3).cpu().numpy()
            yield outputs, tuple(imgs.shape[1:3])


def adam_update(optimizer: torch.optim.Optimizer, params,
                lr: float, losses: Dict[str, torch.Tensor],
                mesh: P.Mesh | None = None,
                names: Iterable[str] = ()) -> Dict[str, float]:
    """One update of ``optimizer`` at ``lr`` on ``losses`` (name -> per-view
    or per-query loss): total = the sum of the means of the ``loss*``
    entries, backward, and a zero gradient for each of ``params`` without
    one (so every Adam moment moves as optax's does, and every rank
    reduces the same set). On a ``mesh`` of more than one rank the
    gradients and the loss values are then averaged over the ranks
    (``average_gradients``: a loss only some ranks have, over those;
    ``names``, every loss name a rank may report, ``build_losses``'
    ``fn.names``).
    Returns each loss's mean and ``loss_total``. The backward and the
    zero gradients are the span ``step.backward``; the loss values' read
    back (or average) and Adam's step, ``step.update``, which counts
    ``adam.bytes`` (``ADAM_BYTES`` a parameter stepped;
    ``utils/profiling.py``)."""
    means = {k: v.mean() for k, v in losses.items()}
    total = sum(v for k, v in means.items() if k.startswith("loss"))
    with span("step.backward"):
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    with span("step.update"):
        values = {k: v.detach()
                  for k, v in {**means, "loss_total": total}.items()}
        if mesh is not None and mesh.size > 1:
            values = P.average_gradients(params, mesh, values,
                                         (*names, "loss_total"))
        else:
            values = dict(zip(values, torch.stack(
                list(values.values())).tolist()))
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        if recording():
            count("adam.bytes", ADAM_BYTES * sum(p.numel() for p in params))
    return values


def _restore_opt_state(optimizer: torch.optim.Optimizer,
                       saved: Dict[str, Any], strict: bool = True) -> bool:
    """Load a saved ``optimizer.state_dict()`` into ``optimizer``.

    A state whose parameter count or moment shapes differ from the
    optimizer's parameters (the model changed since the checkpoint) would
    silently reset or misplace Adam moments. That raises under
    ``strict``; otherwise the fresh state stays, with a warning. Returns
    whether the saved state was loaded."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    count = sum(len(g["params"]) for g in saved["param_groups"])
    state = saved["state"]
    match = count == len(params) and all(
        int(i) < len(params) and all(
            v.shape == params[int(i)].shape for k, v in s.items()
            if k in ("exp_avg", "exp_avg_sq"))
        for i, s in state.items())
    if not match:
        msg = (f"checkpoint opt_state does not match the current optimizer "
               f"({count} vs {len(params)} parameters or a moment's shape "
               f"differs); resuming would reset or misplace Adam moments")
        if strict:
            raise ValueError(msg + ". Pass resume_reset_opt=True to accept "
                             "a fresh optimizer state.")
        print(f"WARNING: {msg}; using a FRESH optimizer state.", flush=True)
        return False
    optimizer.load_state_dict(saved)
    return True
