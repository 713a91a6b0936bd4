"""Scene image and map loading (upnerf/data/images.py), without PIL.

- `load_rgb_u8`: PNGs, JPEGs (a real Phototourism scene's, the JAX
  generator's) and .npy arrays are decoded here
  (upnerf_torch/features/images.py, upnerf_torch/features/jpeg.py), as PIL
  decodes them; the integer downscale is PIL's LANCZOS resampler.
- `resize_bilinear`: PIL's BILINEAR resize of a mode-"F" image
  (`features.images.resample_f32`). PIL widens the filter's support by the
  scale factor when it shrinks (an antialiased resize; cv2's is not),
  computes the coefficients and the sums in float64 and stores each pass as
  float32, horizontal pass first, and skips a pass whose size does not
  change.
- `normalize_inv_depth`, `load_feat_map`: the reference's DPT normalisation
  and the per-pixel L2-normalised DINO map.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from upnerf_torch.features.images import read_rgb_u8, resample_f32, resize_lanczos_u8


def load_rgb_u8(path: str, downscale: int = 1) -> np.ndarray:
    """(H, W, 3) uint8, LANCZOS-downscaled by an integer factor (PIL's
    resampler, bit for bit)."""
    img = read_rgb_u8(path)
    if downscale > 1:
        h, w = img.shape[:2]
        img = resize_lanczos_u8(img, (w // downscale, h // downscale))
    return img


def resize_bilinear(arr: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """Float bilinear resize of an (H, W) or (H, W, C) map to (W, H), each
    channel equal to PIL's `Image.fromarray(c, mode="F").resize(wh,
    Image.BILINEAR)`."""
    w, h = wh
    return resample_f32(torch.from_numpy(np.asarray(arr, np.float32)), (h, w), "bilinear").numpy()


def normalize_inv_depth(inv_depth: np.ndarray, near: float, far: float) -> np.ndarray:
    """Reference DPT normalisation: negatives -> 0, then rescaled to
    [1/far, 1/near] by the per-image max."""
    d = inv_depth.astype(np.float32).copy()
    d[d < 0] = 0
    M, m = 1.0 / near, 1.0 / far
    return d / max(d.max(), 1e-12) * (M - m) + m


def load_feat_map(path: str) -> np.ndarray:
    """(h, w, C) float32, L2-normalised per pixel."""
    feat = np.load(path).astype(np.float32)
    return feat / np.linalg.norm(feat, axis=-1, keepdims=True)
