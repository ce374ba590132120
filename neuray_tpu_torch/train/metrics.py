"""Validation metrics: PSNR and SSIM on 8-bit images (port of
``neuray_tpu/train/metrics.py``; reference network/metrics.py).

SSIM uses uniform 11x11 windows as skimage's ``structural_similarity``
does by default; the JAX package's ``cv2.blur(..., BORDER_REFLECT)`` is
``scipy.ndimage.uniform_filter(mode="reflect")`` here (the card's
machine has no cv2). The validation image dump (``vis_img``) is not
ported.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
from scipy.ndimage import uniform_filter


def color_map_backward(rgb: np.ndarray) -> np.ndarray:
    return np.clip(rgb * 255, 0, 255).astype(np.uint8)


def compute_psnr(img_gt: np.ndarray, img_pr: np.ndarray) -> float:
    """PSNR of 8-bit images."""
    a = img_gt.reshape(-1, 3).astype(np.float32)
    b = img_pr.reshape(-1, 3).astype(np.float32)
    mse = np.mean(np.mean((a - b) ** 2, 0))
    return float(10 * np.log10(255 * 255 / mse))


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


name2metrics = {"psnr_ssim": PSNR_SSIM}


def psnr_nr(results):
    return np.mean(results["psnr_nr"])


def psnr_nr_fine(results):
    return np.mean(results["psnr_nr_fine"])


name2key_metrics = {
    "psnr_nr": psnr_nr,
    "psnr_nr_fine": psnr_nr_fine,
}
