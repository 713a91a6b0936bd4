"""Scene image loading (upnerf/data/images.py:load_rgb_u8), without PIL for PNGs.

PNGs and .npy arrays are decoded here (upnerf_torch/features/images.py);
other formats, a real Phototourism scene's JPEGs among them, need PIL.
"""

from __future__ import annotations

import numpy as np

from upnerf_torch.features.images import read_rgb_u8, resize_lanczos_u8


def load_rgb_u8(path: str, downscale: int = 1) -> np.ndarray:
    """(H, W, 3) uint8, LANCZOS-downscaled by an integer factor (PIL's
    resampler, bit for bit)."""
    img = read_rgb_u8(path)
    if downscale > 1:
        h, w = img.shape[:2]
        img = resize_lanczos_u8(img, (w // downscale, h // downscale))
    return img
