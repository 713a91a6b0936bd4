"""Bilinear gathers from per-image feature map stacks (upnerf/ops/interp.py).

The (N_images, h, w, C) DINO feature stack lives on the device (bf16) and
per-ray features are gathered in f32 inside the train step.
"""

from __future__ import annotations

import torch


def bilinear_gather(
    maps: torch.Tensor,  # (N, h, w, C)
    img_idx: torch.Tensor,  # (B,) int
    u: torch.Tensor,  # (B,) row coordinate in [0, 1]
    v: torch.Tensor,  # (B,) column coordinate in [0, 1]
) -> torch.Tensor:
    """Bilinear sample of maps[img_idx] at normalised (u=row, v=col); (B, C)
    float32. Coordinates scale by size - 1. The base texel is clamped to
    size - 2, so a pixel on the bottom or right edge gets the edge value (the
    original repo's clamping zeroes all four weights there)."""
    _, h, w, _ = maps.shape
    y = u.float() * (h - 1)
    x = v.float() * (w - 1)
    y1 = torch.clamp(torch.floor(y).long(), 0, max(h - 2, 0))
    x1 = torch.clamp(torch.floor(x).long(), 0, max(w - 2, 0))
    y2 = torch.clamp(y1 + 1, max=h - 1)
    x2 = torch.clamp(x1 + 1, max=w - 1)
    p11 = maps[img_idx, y1, x1].float()
    p12 = maps[img_idx, y1, x2].float()
    p21 = maps[img_idx, y2, x1].float()
    p22 = maps[img_idx, y2, x2].float()
    y1f, x1f, y2f, x2f = y1.float(), x1.float(), y2.float(), x2.float()
    w11 = ((y2f - y) * (x2f - x))[:, None]
    w12 = ((y2f - y) * (x - x1f))[:, None]
    w21 = ((y - y1f) * (x2f - x))[:, None]
    w22 = ((y - y1f) * (x - x1f))[:, None]
    return w11 * p11 + w12 * p12 + w21 * p21 + w22 * p22
