"""The finetuning trainer (port of ``neuray_tpu/train/ft_trainer.py``;
reference Trainer on configs/train/ft/*.yaml): ``FtRenderer`` with the
render and consistency losses, one Adam over the renderer's modules and
``ray_feats``, validation on the scene's held-out views, best-model
selection, checkpoints and txt logs.

The loop, the optimizer, the checkpoints and their strict resume are
``BaseTrainer``'s, as in the generalization ``Trainer``. What is its own:
the state (``FtRenderer.init_params``, or a checkpoint's ``ray_feats``
and modules), the batches (a query view, its reference views and rays
from ``np.random.RandomState(1234 + start step)``; the fine sampler's
draws from a CPU ``torch.Generator`` seeded 7 + the start step, as in
the JAX trainer), a validation of the initial state, and the val views
(``FtRenderer.validate_view``, logged to ``val.txt``).

On more than one rank every step is ray-sharded (``FtRenderer.forward``
with the mesh, the losses summed over the ranks, as the JAX trainer's
``make_sharded_train_step``): every rank draws the same batch and the
same fine draws, renders its slice of the rays, and the gradients are
averaged; validation renders shard the rays too.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np
import torch

from neuray_tpu_torch.models.ft import FtRenderer, make_ft_render_fn
from neuray_tpu_torch.parallel.sharding import Mesh
from neuray_tpu_torch.train.losses import build_losses
from neuray_tpu_torch.train.trainer import BaseTrainer


class FtTrainer(BaseTrainer):
    default_cfg = {
        "name": "neuray_ft_model",
        "total_step": 200000,
        "train_log_step": 20,
        "val_interval": 5000,
        "save_interval": 5000,
        "lr_type": "exp_decay",
        "lr_cfg": {"lr_init": 1.0e-4, "decay_step": 100000,
                   "decay_rate": 0.5},
        "loss": ["render", "consist"],
        "val_metric": ["psnr_ssim"],
        "key_metric_name": "psnr_nr",
        "output_root": "data/model",
        "n_devices": None,
        "use_validation": True,
        "validate_initialization": True,
    }

    def __init__(self, cfg: Dict[str, Any], device=None,
                 mesh: Mesh | None = None):
        super().__init__(cfg, device, mesh)
        self.ft = FtRenderer(self.cfg, self.device)
        if self.mesh.size > 1:
            self.loss_fn = build_losses(self.cfg, self.mesh)
            rn, n = self.cfg["train_ray_num"], self.mesh.size
            pad = (-rn) % n
            if self.mesh.is_main:
                print(f"ft training ray-sharded over {n} ranks"
                      + (f" (ray batch {rn} padded +{pad} to split evenly; "
                         "pad rays weighted out of the loss)" if pad
                         else ""), flush=True)

    @property
    def model(self) -> FtRenderer:
        return self.ft

    # ---------------- state ----------------

    def _init_state(self) -> None:
        self.ft.init_params()

    def _load_state(self, params: Dict[str, torch.Tensor]) -> None:
        self.ft.set_ray_feats(params["ray_feats"])
        self.ft.load_state_dict(params)

    # ---------------- steps ----------------

    def _batches(self, step: int) -> Iterator[tuple]:
        """(ref_idx, que, que_i) of each step from ``step`` on."""
        rng_np = np.random.RandomState(1234 + step)
        self.generator.manual_seed(7 + step)
        for _ in range(step, self.cfg["total_step"]):
            que_i, ref_idx = self.ft.sample_train_indices(rng_np)
            yield ref_idx, self.ft._build_que_train(ref_idx, que_i,
                                                    rng_np), que_i

    def _losses(self, batch) -> Dict[str, torch.Tensor]:
        ref_idx, que, que_i = batch
        return self.loss_fn(
            self.ft(ref_idx, que, que_i, self.generator, self.mesh), {})

    # ---------------- validation ----------------

    def _val_sets(self):
        """The held-out views (``FtRenderer.validate_view``), logged to
        ``val.txt``; none without ``use_validation``."""
        if self.cfg["use_validation"]:
            yield "val", self.cfg["name"], self._val_views(
                make_ft_render_fn(self.ft, mesh=self.mesh))

    def _val_views(self, render_fn):
        for vi in range(len(self.ft.val_ids)):
            out, gt, que_shape = self.ft.validate_view(render_fn, vi)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            out["pixel_colors_gt"] = gt.reshape(1, -1, 3)
            yield out, que_shape
