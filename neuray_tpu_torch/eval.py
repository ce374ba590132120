"""The port's eval CLI (counterpart of the root ``eval.py``):

    python -m neuray_tpu_torch.eval --dir_pr <renders> --dir_gt <gt>
        [--suffix nr_fine] [--device cpu]

scores each ``{k}-{suffix}.jpg`` of dir_pr against ``{k}.jpg`` of dir_gt
(both read as ``cv2.imread`` reads them: 3 channels, a gray JPEG
repeated) and prints a line per image, ``{k} psnr {:.3f} ssim {:.4f}``
(and ``lpips {:.4f}``), then the means: ``psnr``, ``ssim`` and ``lpips``
or ``lpips unavailable (see reason above)``. PSNR and SSIM are
``train/metrics.py``'s. LPIPS is the published LPIPS(VGG, v0.1): VGG16
features at each block's last ReLU, unit-normalized over the channels,
their squared difference weighted by the learned per-channel weights,
averaged over space and summed over the layers, run on ``--device``
(default CUDA; without a card the CLI raises unless ``--device cpu``).
It needs two local files and downloads nothing:

  * the VGG16 backbone: ``$NEURAY_VGG16_WEIGHTS``, else
    ``$TORCH_HOME/hub/checkpoints/vgg16-397923af.pth`` (``TORCH_HOME``
    defaulting to ``~/.cache/torch``) or ``data/vgg16-397923af.pth``;
  * the LPIPS v0.1 vgg lin weights: ``$NEURAY_LPIPS_WEIGHTS``, else
    ``data/lpips_vgg.pth`` or ``data/lpips/vgg.pth``.

Without them the CLI prints ``LPIPS unavailable: <reason>`` and no LPIPS
number. TF32 is off for the run (``utils/device.py: full_f32``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn as nn

from neuray_tpu_torch.train.metrics import compute_psnr, compute_ssim
from neuray_tpu_torch.utils.device import full_f32, resolve_device
from neuray_tpu_torch.utils.imageio import imread_color

# VGG16's conv blocks: (out_channels, convs); LPIPS taps each block's last
# ReLU
_VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
# LPIPS's input scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _find_weight_file(env_key, candidates):
    path = os.environ.get(env_key)
    if path and os.path.exists(path):
        return path
    return next((c for c in candidates if os.path.exists(c)), None)


class LpipsVgg:
    """LPIPS(VGG, v0.1) from the local weight files on ``device``, or
    disabled (``ok`` False) with the reason in ``reason``."""

    def __init__(self, device=None):
        self.ok = False
        torch_home = os.environ.get(
            "TORCH_HOME", os.path.expanduser("~/.cache/torch"))
        vgg_fn = _find_weight_file("NEURAY_VGG16_WEIGHTS", [
            f"{torch_home}/hub/checkpoints/vgg16-397923af.pth",
            "data/vgg16-397923af.pth"])
        lin_fn = _find_weight_file("NEURAY_LPIPS_WEIGHTS", [
            "data/lpips_vgg.pth", "data/lpips/vgg.pth"])
        if vgg_fn is None or lin_fn is None:
            missing = []
            if vgg_fn is None:
                missing.append("VGG16 backbone (set NEURAY_VGG16_WEIGHTS)")
            if lin_fn is None:
                missing.append("LPIPS lin weights (set NEURAY_LPIPS_WEIGHTS)")
            self.reason = "missing local weight files: " + "; ".join(missing)
            return
        self.device = resolve_device(device)
        # torchvision's vgg16().features, so that its state dict loads by key
        layers, in_ch, self.taps = [], 3, set()
        for out_ch, n_convs in _VGG_BLOCKS:
            for _ in range(n_convs):
                layers += [nn.Conv2d(in_ch, out_ch, 3, padding=1),
                           nn.ReLU(inplace=True)]
                in_ch = out_ch
            self.taps.add(len(layers) - 1)
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        sd = torch.load(vgg_fn, map_location="cpu", weights_only=True)
        self.features.load_state_dict(
            {k[len("features."):]: v for k, v in sd.items()
             if k.startswith("features.")})
        self.features.to(self.device).eval()
        lin_sd = torch.load(lin_fn, map_location="cpu", weights_only=True)
        self.lins = [lin_sd[f"lin{i}.model.1.weight"].float().to(self.device)
                     for i in range(len(_VGG_BLOCKS))]    # [1, C, 1, 1]
        self.shift = torch.tensor(_SHIFT, device=self.device).view(1, 3, 1, 1)
        self.scale = torch.tensor(_SCALE, device=self.device).view(1, 3, 1, 1)
        self.ok = True
        self.reason = None

    @torch.inference_mode()
    def __call__(self, img0, img1) -> float:
        """The LPIPS distance of two uint8 [h, w, 3] RGB images."""
        if not self.ok:
            raise RuntimeError(f"LPIPS unavailable: {self.reason}")

        def prep(x):
            t = torch.from_numpy(x.astype(np.float32) / 255).to(self.device)
            t = t.permute(2, 0, 1)[None] * 2 - 1     # [-1, 1]
            return (t - self.shift) / self.scale

        f0, f1 = prep(img0), prep(img1)
        d, li = 0.0, 0
        # full f32 convs (cuDNN would take TF32 on the card)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for i, layer in enumerate(self.features):
                f0, f1 = layer(f0), layer(f1)
                if i in self.taps:
                    n0 = f0 / (f0.norm(dim=1, keepdim=True) + 1e-10)
                    n1 = f1 / (f1.norm(dim=1, keepdim=True) + 1e-10)
                    diff = (n0 - n1) ** 2
                    d += (diff * self.lins[li]).sum(1, keepdim=True) \
                        .mean().item()
                    li += 1
        return d


def evaluate(dir_pr, dir_gt, suffix="nr_fine", device=None):
    """Print the per-image and mean scores (see the module's doc).
    Returns {"psnr": [...], "ssim": [...], "lpips": [...]} per image."""
    lpips_fn = LpipsVgg(device)
    if not lpips_fn.ok:
        print(f"LPIPS unavailable: {lpips_fn.reason}", flush=True)
    scores = {"psnr": [], "ssim": [], "lpips": []}
    ks = sorted(int(fn.split(".")[0])
                for fn in os.listdir(dir_gt) if fn.endswith(".jpg"))
    for k in ks:
        pr_fn = f"{dir_pr}/{k}-{suffix}.jpg"
        if not os.path.exists(pr_fn):
            continue
        pr, gt = imread_color(pr_fn), imread_color(f"{dir_gt}/{k}.jpg")
        scores["psnr"].append(compute_psnr(gt, pr))
        scores["ssim"].append(compute_ssim(gt, pr))
        line = f"{k} psnr {scores['psnr'][-1]:.3f} ssim " \
            f"{scores['ssim'][-1]:.4f}"
        if lpips_fn.ok:
            scores["lpips"].append(lpips_fn(gt, pr))
            line += f" lpips {scores['lpips'][-1]:.4f}"
        print(line, flush=True)

    print(f"psnr {np.mean(scores['psnr']):.4f}")
    print(f"ssim {np.mean(scores['ssim']):.4f}")
    if lpips_fn.ok:
        print(f"lpips {np.mean(scores['lpips']):.4f}")
    else:
        print("lpips unavailable (see reason above)")
    return scores


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.strip().splitlines()[0])
    parser.add_argument("--dir_pr", type=str, required=True)
    parser.add_argument("--dir_gt", type=str, required=True)
    parser.add_argument("--suffix", type=str, default="nr_fine")
    parser.add_argument("--device", type=str, default=None,
                        help="a torch device for LPIPS; default CUDA")
    flags = parser.parse_args(argv)
    resolve_device(flags.device)
    full_f32()
    evaluate(flags.dir_pr, flags.dir_gt, flags.suffix, flags.device)


if __name__ == "__main__":
    main()
