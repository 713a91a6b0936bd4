"""Image quality metrics: MSE, PSNR, SSIM (upnerf/evaluate/metrics.py).

PSNR over the raw [0, 1] rgb; SSIM in kornia's `ssim_loss(window=3)`
convention (the reference reports 1 - 2 * dssim = the mean SSIM map): a 3x3
gaussian window (sigma 1.5), reflect padding, f32. The variance terms
E[x^2] - mu^2 cancel catastrophically at reduced precision, so the window
filter is a plain f32 sum of nine shifted copies: no convolution library, no
TF32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def mse(pred: torch.Tensor, gt: torch.Tensor, valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    v = (pred - gt) ** 2
    if valid_mask is not None:
        v = v[valid_mask]
    return v.mean()


def psnr(pred: torch.Tensor, gt: torch.Tensor, valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return -10.0 * torch.log10(mse(pred, gt, valid_mask))


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def ssim(pred: torch.Tensor, gt: torch.Tensor, window_size: int = 3, max_val: float = 1.0,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of two (H, W, 3) images in [0, 1]."""
    kernel = _gaussian_kernel(window_size, sigma).astype(np.float32)
    C1, C2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    pad = window_size // 2
    H, W = pred.shape[:2]

    def filt(x):  # same-size window filter, reflect border (kornia filter2d's default)
        x = torch.nn.functional.pad(x.permute(2, 0, 1)[None], (pad, pad, pad, pad), mode="reflect")[0].permute(1, 2, 0)
        out = torch.zeros((H, W, x.shape[-1]), dtype=torch.float32, device=x.device)
        for i in range(window_size):
            for j in range(window_size):
                out = out + float(kernel[i, j]) * x[i : i + H, j : j + W]
        return out

    mu_p, mu_g = filt(pred), filt(gt)
    mu_pp, mu_gg, mu_pg = mu_p * mu_p, mu_g * mu_g, mu_p * mu_g
    sigma_pp = filt(pred * pred) - mu_pp
    sigma_gg = filt(gt * gt) - mu_gg
    sigma_pg = filt(pred * gt) - mu_pg
    num = (2 * mu_pg + C1) * (2 * sigma_pg + C2)
    den = (mu_pp + mu_gg + C1) * (sigma_pp + sigma_gg + C2)
    return (num / den).mean()
