"""Validation metrics: PSNR and SSIM on 8-bit images, and the validation
image dumps (port of ``neuray_tpu/train/metrics.py``; reference
network/metrics.py).

SSIM uses uniform 11x11 windows as skimage's ``structural_similarity``
does by default; the JAX package's ``cv2.blur(..., BORDER_REFLECT)`` is
``scipy.ndimage.uniform_filter(mode="reflect")`` here, and its
``cv2.imwrite`` is ``utils/imageio.py``'s ``imwrite`` (the card's machine
has no cv2).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
from scipy.ndimage import uniform_filter

from neuray_tpu_torch.utils.imageio import imwrite


def color_map_backward(rgb: np.ndarray) -> np.ndarray:
    return np.clip(rgb * 255, 0, 255).astype(np.uint8)


def compute_psnr(img_gt: np.ndarray, img_pr: np.ndarray) -> float:
    """PSNR of 8-bit images."""
    a = img_gt.reshape(-1, 3).astype(np.float32)
    b = img_pr.reshape(-1, 3).astype(np.float32)
    mse = np.mean(np.mean((a - b) ** 2, 0))
    return float(10 * np.log10(255 * 255 / mse))


def unit_psnr(a, b) -> float:
    """PSNR of float images in [0, 1], in f64, the mean squared error
    floored at 1e-12: the quality tools' reading of a frame against
    another frame or the ground truth."""
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def compute_ssim(img_gt: np.ndarray, img_pr: np.ndarray,
                 win_size: int = 11, data_range: float = 255.0) -> float:
    """SSIM with uniform windows (skimage's defaults at win_size 11,
    unbiased covariances, the filter margin cropped), averaged over the
    channels."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    n = win_size ** 2
    cov_norm = n / (n - 1)

    def channel_ssim(x, y):
        x = x.astype(np.float64)
        y = y.astype(np.float64)

        def filt(a):
            return uniform_filter(a, size=win_size, mode="reflect")

        ux, uy = filt(x), filt(y)
        uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)
             / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))
        pad = (win_size - 1) // 2
        return s[pad:-pad, pad:-pad].mean()

    return float(np.mean([channel_ssim(img_gt[..., c], img_pr[..., c])
                          for c in range(img_gt.shape[-1])]))


class PSNR_SSIM:
    """PSNR and SSIM of every rendered image key against
    ``pixel_colors_gt``, inside the central ``eval_margin_ratio`` of the
    image."""
    default_cfg = {"eval_margin_ratio": 1.0}

    def __init__(self, cfg: Dict[str, Any]):
        self.cfg = {**self.default_cfg, **cfg}

    def __call__(self, data_pr, data_gt, step, **kwargs):
        h, w = data_gt["que_shape"]
        gt = color_map_backward(
            np.asarray(data_pr["pixel_colors_gt"]).reshape(h, w, 3))
        margin_h = int(h * (1 - self.cfg["eval_margin_ratio"])) // 2
        margin_w = int(w * (1 - self.cfg["eval_margin_ratio"])) // 2

        def crop(img):
            return img[margin_h:h - margin_h, margin_w:w - margin_w]

        gt_c = crop(gt)
        outputs = {}
        for suffix in ("nr", "dr", "nr_fine", "dr_fine"):
            key = f"pixel_colors_{suffix}"
            if key not in data_pr:
                continue
            pr_c = crop(color_map_backward(
                np.asarray(data_pr[key]).reshape(h, w, 3)))
            outputs[f"psnr_{suffix}"] = np.asarray(
                [compute_psnr(gt_c, pr_c)], np.float32)
            outputs[f"ssim_{suffix}"] = np.asarray(
                [compute_ssim(gt_c, pr_c)], np.float32)
        return outputs


class VisualizeImage:
    """``vis_img``: the ground truth and each rendered image side by side,
    written to ``<output_root>/<model_name>/step-<step>-index-<i>.<ext>``,
    a PNG at 64x64 and below, a JPEG (quality 95) above."""

    def __init__(self, cfg: Dict[str, Any]):
        self.cfg = cfg

    def __call__(self, data_pr, data_gt, step, *, data_index=0,
                 model_name="model", output_root="data/vis_val", **kwargs):
        h, w = data_gt["que_shape"]
        imgs = [color_map_backward(np.asarray(data_pr[key]).reshape(h, w, 3))
                for key in ("pixel_colors_gt", "pixel_colors_nr",
                            "pixel_colors_dr", "pixel_colors_nr_fine",
                            "pixel_colors_dr_fine") if key in data_pr]
        os.makedirs(f"{output_root}/{model_name}", exist_ok=True)
        ext = "png" if (h <= 64 and w <= 64) else "jpg"
        imwrite(f"{output_root}/{model_name}/step-{step}-index-"
                f"{data_index}.{ext}", np.concatenate(imgs, axis=1))
        return {}


name2metrics = {"psnr_ssim": PSNR_SSIM, "vis_img": VisualizeImage}


def psnr_nr(results):
    return np.mean(results["psnr_nr"])


def psnr_nr_fine(results):
    return np.mean(results["psnr_nr_fine"])


name2key_metrics = {
    "psnr_nr": psnr_nr,
    "psnr_nr_fine": psnr_nr_fine,
}
