"""End-to-end self-checks of the port's render and eval CLIs (counterparts
of ``tools/selfcheck_render.py`` and ``tools/selfcheck_ft.py``), on a
NeRF-synthetic sphere fabricated under a work directory, with no dataset:

    python -m neuray_tpu_torch.selfcheck [--work DIR] [--size 64]
        [--steps 20] [--skip_mode MODE] [--device cpu]

``selfcheck_render``: a gen checkpoint (random weights from flax's
initializers, or a given flax tree), ``python -m neuray_tpu_torch.render
--pose_type eval --depth`` over the scene's test views, then ``python -m
neuray_tpu_torch.eval`` on the frames and the GT dump.
``selfcheck_ft``: the same gen checkpoint, ``FtTrainer`` for a few steps
from it, then ``--render_type ft`` on one pose of an ``inter``
trajectory. Each prints what it made and returns it; a missing file or a
non-finite score raises. The work directory is the CLIs' working
directory (their ``data/`` lives there) and is kept.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
from pathlib import Path

import numpy as np
import torch

from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
from neuray_tpu_torch.models.renderer import NeurayRenderer, RenderConfig
from neuray_tpu_torch.utils.imageio import imread_color
from neuray_tpu_torch.utils.params import init_like_flax, load_flax_params

DATABASE = "nerf_synthetic/toy/black_800"
RENDERS = f"data/render/{DATABASE.replace('/', '_')}"
GEN_CFG = {
    "name": "selfcheck_gen",
    "network": "neuray_gen",
    "init_net_type": "depth",
    "use_hierarchical_sampling": True,
    "depth_sample_num": 16,
    "fine_depth_sample_num": 16,
    "dist_decoder_cfg": {"use_vis": False},
    "fine_dist_decoder_cfg": {"use_vis": False},
    "ray_batch_num": 2048,
    "ray_mask_point_num": 4,
}


def write_gen_checkpoint(output_root, cfg, weights=None, seed=0) -> None:
    """The gen model of cfg saved as ``Trainer`` saves it
    (``{output_root}/{name}/ckpt.pt``): with ``weights`` (a flax tree,
    ``utils/params.py: load_params_npz``), else flax's initializers under
    ``seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen = NeurayRenderer(RenderConfig.from_cfg(cfg))
        if weights is None:
            init_like_flax(gen)
    if weights is not None:
        load_flax_params(gen, weights)
    model_dir = Path(output_root) / cfg["name"]
    model_dir.mkdir(parents=True, exist_ok=True)
    torch.save({"step": 0, "best_metric": -1e9, "params": gen.state_dict(),
                "opt_state": torch.optim.Adam(gen.parameters()).state_dict(),
                "opt_count": 0}, model_dir / "ckpt.pt")


def write_cfg(path, cfg) -> str:
    """cfg as a config file the port's YAML reader reads: one line of
    JSON, which is YAML."""
    Path(path).write_text(json.dumps(cfg) + "\n")
    return str(path)


@contextlib.contextmanager
def in_work_dir(work):
    """cwd = work and the databases read under work/data, both restored."""
    cwd, root = os.getcwd(), DB.DATA_ROOT
    os.chdir(work)
    DB.DATA_ROOT = str(Path(work) / "data")
    try:
        yield
    finally:
        os.chdir(cwd)
        DB.DATA_ROOT = root


def write_scene(work, size: int, n_train: int = 12, n_test: int = 3):
    write_nerf_synthetic_sphere(str(Path(work) / "data"), n_train, size,
                                "toy", n_test)


def selfcheck_render(work, size: int = 64, device=None, skip_mode=None,
                     weights=None) -> dict:
    """The render CLI over the scene's test views and the eval CLI on its
    frames. Returns {"files": the frame files, "psnr", "ssim"}."""
    from neuray_tpu_torch import eval as E
    from neuray_tpu_torch import render
    work = Path(work).resolve()
    work.mkdir(parents=True, exist_ok=True)
    cfg = dict(GEN_CFG)
    if skip_mode:
        cfg.update(skip_empty_rays=True, skip_empty_threshold=0.05,
                   skip_mode=skip_mode, probe_sample_num=8)
    with in_work_dir(work):
        write_scene(work, size)
        write_gen_checkpoint("data/model", cfg, weights)
        render.main(["--database_name", DATABASE, "--cfg",
                     write_cfg(work / "selfcheck_gen.yaml", cfg),
                     "--pose_type", "eval", "--depth", "--ray_num", "1024"]
                    + (["--device", str(device)] if device else []))
        out_dir = f"{RENDERS}/{cfg['name']}-eval"
        gt_dir = f"{RENDERS}/gt"
        files = sorted(os.listdir(out_dir))
        print("rendered files:", files, flush=True)
        for qi in range(3):
            for fn in (f"{out_dir}/{qi}-nr_fine.jpg",
                       f"{out_dir}/{qi}-nr.jpg", f"{out_dir}/{qi}-depth.png",
                       f"{gt_dir}/{qi}.jpg"):
                if imread_color(fn).shape != (size, size, 3):
                    raise RuntimeError(f"{fn} is not {size}x{size}")
        scores = E.evaluate(out_dir, gt_dir, "nr_fine", device)
    psnr, ssim = np.mean(scores["psnr"]), np.mean(scores["ssim"])
    if not (np.isfinite(psnr) and np.isfinite(ssim)):
        raise RuntimeError(f"eval gave psnr {psnr}, ssim {ssim}")
    print(f"selfcheck render: PSNR {psnr:.2f} SSIM {ssim:.3f} ({len(files)} "
          f"files)", flush=True)
    return {"files": files, "psnr": float(psnr), "ssim": float(ssim)}


def ft_config(steps: int, skip_mode=None) -> dict:
    """The finetuning config of the self-check (``tools/selfcheck_ft.py``'s
    fields)."""
    cfg = {
        "name": "selfcheck_ft",
        "network": "neuray_ft",
        "database_name": DATABASE,
        "database_split": "val_all",
        "gen_cfg": dict(GEN_CFG),
        "init_view_num": 4,
        "neighbor_view_num": 4,
        "train_ray_num": 256,
        "use_self_hit_prob": True,
        **{k: GEN_CFG[k] for k in (
            "use_hierarchical_sampling", "depth_sample_num",
            "fine_depth_sample_num", "ray_batch_num", "ray_mask_point_num",
            "dist_decoder_cfg", "fine_dist_decoder_cfg")},
        "loss": ["render", "consist"],
        "use_nr_fine_loss": True,
        "val_metric": ["psnr_ssim"],
        "key_metric_name": "psnr_nr_fine",
        "total_step": steps,
        "train_log_step": max(steps // 10, 1),
        "val_interval": steps,
        "save_interval": steps,
        "use_validation": False,
        "validate_initialization": False,
        "output_root": "data/model",
        "lr_cfg": {"lr_init": 5.0e-4, "decay_step": 100000,
                   "decay_rate": 0.5},
    }
    if skip_mode:
        cfg.update(skip_empty_rays=True, skip_empty_threshold=0.01,
                   skip_mode=skip_mode, probe_sample_num=8)
    return cfg


def selfcheck_ft(work, size: int = 64, steps: int = 20, device=None,
                 skip_mode=None, weights=None) -> dict:
    """A gen checkpoint, ``FtTrainer`` for ``steps`` steps from it, then
    the render CLI's ``--render_type ft`` on the first pose of
    ``inter_8``. Returns {"losses": the first and last step's, "files"}."""
    from neuray_tpu_torch import render
    from neuray_tpu_torch.train.ft_trainer import FtTrainer
    work = Path(work).resolve()
    work.mkdir(parents=True, exist_ok=True)
    cfg = ft_config(steps, skip_mode)
    with in_work_dir(work):
        if not (work / "data" / "nerf_synthetic" / "toy").exists():
            write_scene(work, size)
        write_gen_checkpoint("data/model", GEN_CFG, weights)
        trainer = FtTrainer(cfg, device)
        losses = []
        step = trainer.train_step

        def logged(batch):
            out = step(batch)
            losses.append(float(out["loss_total"]))
            return out

        trainer.train_step = logged
        trainer.run()
        render.main(["--database_name", DATABASE, "--cfg",
                     write_cfg(work / "selfcheck_ft.yaml", cfg),
                     "--render_type", "ft", "--pose_type", "inter_8",
                     "--re", "1"]
                    + (["--device", str(device)] if device else []))
        out_dir = f"{RENDERS}/{cfg['name']}-inter_8"
        files = sorted(os.listdir(out_dir))
        if imread_color(f"{out_dir}/0-nr_fine.jpg").shape != (size, size, 3):
            raise RuntimeError("the FT frame is not the scene's size")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"FT losses {losses}")
    print(f"selfcheck ft: {steps} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; rendered {files}", flush=True)
    return {"losses": (losses[0], losses[-1]), "files": files}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.strip().splitlines()[0])
    parser.add_argument("--work", default="build/selfcheck",
                        help="the work directory (kept)")
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--skip_mode", default=None,
                        choices=["two_phase", "probe", "probe_focus", "auto",
                                 "auto_focus"],
                        help="render through this skip driver "
                             "(skip_empty_rays)")
    parser.add_argument("--device", default=None,
                        help="a torch device; default CUDA")
    flags = parser.parse_args(argv)
    selfcheck_render(Path(flags.work) / "render", flags.size, flags.device,
                     flags.skip_mode)
    selfcheck_ft(Path(flags.work) / "ft", flags.size, flags.steps,
                 flags.device, flags.skip_mode)
    print("SELFCHECK: PASS", flush=True)


if __name__ == "__main__":
    main()
