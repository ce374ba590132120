"""Convert a reference NeuRay checkpoint into the port's (counterpart of
``tools/convert_reference_ckpt.py``, which writes the JAX package's orbax
checkpoint):

    python -m neuray_tpu_torch.convert_reference_ckpt \\
        --torch_ckpt data/model/neuray_gen_depth/model_best.pth \\
        --cfg configs/gen/neuray_gen_depth.yaml \\
        --out data/model/neuray_gen_depth

reads the reference's ``model_best.pth`` (``{"network_state_dict",
"step"}``) with ``torch.load(weights_only=True)`` on the CPU, maps it onto
the port's ``NeurayRenderer`` of the config (``use_hierarchical_sampling``,
the dist decoders' ``use_vis`` and ``init_net_type`` decide which modules
it holds; a cost-volume model takes MVSNet from its ``init_net.mvsnet.*``
keys), checks that every parameter is filled with its shape and writes
``<out>/ckpt_best.pt`` in the format the port's ``Trainer`` saves. The
render CLI (``--render_type gen``, the checkpoint under ``output_root`` /
the config's name), ``models/ft.py: load_gen_state`` and a finetuning
config's ``gen_cfg`` then read it unchanged. The mapping is
``utils/reference_ckpt.py``'s; the run never touches the card.
"""
from __future__ import annotations

import argparse
import os

import torch

from neuray_tpu_torch.models.renderer import NeurayRenderer, RenderConfig
from neuray_tpu_torch.utils.config import load_cfg
from neuray_tpu_torch.utils.device import full_f32
from neuray_tpu_torch.utils.reference_ckpt import (
    check_state, convert_gen_state_dict, gen_flags, read_reference_ckpt)


def convert(torch_ckpt: str, cfg_fn: str, out_dir: str) -> str:
    """Convert ``torch_ckpt`` for the config ``cfg_fn`` into
    ``<out_dir>/ckpt_best.pt``; returns that path."""
    cfg = load_cfg(cfg_fn)
    sd, step = read_reference_ckpt(torch_ckpt)
    state, _ = convert_gen_state_dict(sd, **gen_flags(cfg))
    with torch.random.fork_rng(devices=[]):
        own = NeurayRenderer(RenderConfig.from_cfg(cfg)).state_dict()
    check_state(state, own)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "ckpt_best.pt")
    torch.save({"step": step, "best_metric": 0.0,
                "params": {k: v.detach().clone().contiguous()
                           for k, v in state.items()}}, path)
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.strip().splitlines()[0])
    parser.add_argument("--torch_ckpt", required=True)
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--out", required=True,
                        help="the model's directory: writes ckpt_best.pt")
    flags = parser.parse_args(argv)
    full_f32()
    print(f"wrote {convert(flags.torch_ckpt, flags.cfg, flags.out)}")


if __name__ == "__main__":
    main()
