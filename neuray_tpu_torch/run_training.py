"""The port's training CLI (counterpart of the root ``run_training.py``):

    python -m neuray_tpu_torch.run_training --cfg <config.yaml> [--device cpu]

reads the config with the port's YAML reader and trains on the card:
``network: neuray_ft`` or ``train_dataset_type: ft`` with ``FtTrainer``
(finetuning on one scene), everything else with ``Trainer``
(generalization). Data are read under ``NEURAY_DATA_ROOT`` (default
``data``), checkpoints, logs and ``vis_val`` images written under the
config's ``output_root`` (default ``data/model``). ``--device`` names
another torch device (``cpu`` for a run without a card); without it a
machine with no CUDA device raises. TF32 is off for the run
(``utils/device.py: full_f32``).

Under ``torchrun --nproc_per_node N -m neuray_tpu_torch.run_training
--cfg <config.yaml>`` it trains on N ranks (``parallel/sharding.py``):
generalization training data-parallel, finetuning ray-sharded; rank 0
writes the checkpoints and logs (the trainer joins the ranks:
``make_mesh``). A config's ``n_devices``, when set, must be N.
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from neuray_tpu_torch.utils.config import load_cfg
from neuray_tpu_torch.utils.device import full_f32


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.strip().splitlines()[0])
    parser.add_argument("--cfg", type=str,
                        default="configs/train/gen/neuray_gen_depth_train.yaml")
    parser.add_argument("--device", type=str, default=None,
                        help="a torch device; default CUDA")
    flags = parser.parse_args(argv)
    full_f32()
    cfg = load_cfg(flags.cfg)
    owned = not dist.is_initialized()       # torchrun: the trainer joins
    try:
        if (cfg.get("network") == "neuray_ft"
                or cfg.get("train_dataset_type") == "ft"):
            from neuray_tpu_torch.train.ft_trainer import FtTrainer
            return FtTrainer(cfg, flags.device).run()
        from neuray_tpu_torch.train.trainer import Trainer
        return Trainer(cfg, flags.device).run()
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
