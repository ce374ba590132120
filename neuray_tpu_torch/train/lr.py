"""Learning-rate schedules, step -> lr, in plain Python (port of
``neuray_tpu/train/lr.py``; reference train/lr_common_manager.py). The
trainer reads them at the optimizer's update count, as optax does."""
from __future__ import annotations

from typing import Any, Dict


def exp_decay_lr(cfg: Dict[str, Any]):
    """lr_init * decay_rate^(step // decay_step), floored at lr_min."""
    lr_init = cfg.get("lr_init", 1e-4)
    decay_step = cfg.get("decay_step", 100000)
    decay_rate = cfg.get("decay_rate", 0.5)
    lr_min = cfg.get("lr_min", 1e-5)

    def schedule(step: int) -> float:
        return max(lr_init * decay_rate ** (step // decay_step), lr_min)

    return schedule


def warmup_exp_decay_lr(cfg: Dict[str, Any]):
    """Linear warm-up from 0 to lr_warm over warm_step steps, then
    ``exp_decay_lr`` counted from the end of the warm-up."""
    lr_warm = cfg.get("lr_warm", 1e-4)
    warm_step = cfg.get("warm_step", 5000)
    base = exp_decay_lr(cfg)

    def schedule(step: int) -> float:
        if step < warm_step:
            return lr_warm * step / max(warm_step, 1)
        return base(step - warm_step)

    return schedule


name2lr_manager = {
    "exp_decay": exp_decay_lr,
    "warm_up_exp_decay": warmup_exp_decay_lr,
}
