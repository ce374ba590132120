"""The system under test, reached through its own entry points only:
``neuray_tpu_torch``'s renderer built from a configuration's
``RenderConfig`` fields with the weight file loaded by the port's own
loader, and its trainer. Nothing here computes what the program
computes."""
from __future__ import annotations

from typing import Dict

import torch


def set_precision() -> None:
    """The precision every entry point of the port sets: TF32 off, by
    the port's own ``utils/device.py: full_f32``."""
    from neuray_tpu_torch.utils.device import full_f32
    full_f32()


def renderer(config: Dict, route: Dict, weights_path, device,
             scale: Dict[str, float]):
    """The port's ``NeurayRenderer`` for the configuration's render
    fields with the cell's route fields over them, the weight file's
    leaves (``scale`` multiplies named ones) loaded by the port's loader,
    in eval mode on ``device``."""
    from neuray_tpu_torch.models.renderer import NeurayRenderer, RenderConfig
    from neuray_tpu_torch.utils.params import (load_flax_params,
                                               load_params_npz)
    cfg = RenderConfig(**{**config["render"], **route})
    tree = load_params_npz(str(weights_path))
    for path, s in scale.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node[p]
        node[leaf] = node[leaf] * s
    r = NeurayRenderer(cfg)
    load_flax_params(r, tree)
    return r.to(device).eval()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
