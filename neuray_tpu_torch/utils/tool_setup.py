"""What the port's diagnostic and profiling tools share: the device line,
a renderer with the tools' weights, and the sphere scene as tensors.

The weights follow the JAX tools: on the card the trained
``tools/bench_weights.npz`` (as the JAX tools load it on the TPU), on
the CPU flax's initializers under ``torch.manual_seed(0)``
(``utils/params.py: init_like_flax``); a caller (the tests, handing JAX's
initial parameters across) may pass a flax tree instead.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from neuray_tpu_torch.data.synthetic import make_query, make_sphere_scene
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.utils.params import (
    init_like_flax, load_flax_params, load_params_npz)

BENCH_WEIGHTS = str(Path(__file__).resolve().parents[2] / "tools"
                    / "bench_weights.npz")


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def load_weights(module: torch.nn.Module, device: torch.device,
                 params=None, weights: str = BENCH_WEIGHTS) -> None:
    """Load ``params`` (a flax tree) into module, else on the card the
    weights file and on the CPU flax's initializers under seed 0."""
    if params is None and device.type == "cuda":
        params = load_params_npz(weights)
    if params is not None:
        load_flax_params(module, params)
        return
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        init_like_flax(module)


def build_renderer(cfg: R.RenderConfig, device: torch.device, params=None,
                   weights: str = BENCH_WEIGHTS) -> R.NeurayRenderer:
    """The renderer of cfg with the tools' weights (``load_weights``),
    on device, in eval mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        renderer = R.NeurayRenderer(cfg)
    load_weights(renderer, device, params, weights)
    return renderer.to(device).eval()


Tensors = Dict[str, torch.Tensor]


def sphere_scene(rfn: int, h: int, w: int, device: torch.device,
                 query: bool = True) -> Tuple[Tensors, Tensors]:
    """(ref, que): rfn reference views of the unit sphere from
    ``RandomState(0)`` and the full-image query that follows them (its
    image dropped; None without ``query``), as tensors on device."""
    rng = np.random.RandomState(0)
    ref = {k: torch.from_numpy(v).to(device)
           for k, v in make_sphere_scene(rng, rfn, h, w).items()}
    if not query:
        return ref, None
    que_np = make_query(rng, h, w, 0, full_image=True)
    que_np.pop("imgs")
    return ref, {k: torch.from_numpy(v).to(device) for k, v in que_np.items()}
