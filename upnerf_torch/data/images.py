"""Scene image and map loading (upnerf/data/images.py), without PIL for PNGs.

- `load_rgb_u8`: PNGs and .npy arrays are decoded here
  (upnerf_torch/features/images.py); other formats, a real Phototourism
  scene's JPEGs among them, need PIL.
- `resize_bilinear`: PIL's BILINEAR resize of a mode-"F" image, written out
  in numpy. PIL widens the filter's support by the scale factor when it
  shrinks (an antialiased resize; cv2's is not), computes the coefficients
  and the sums in float64 and stores each pass as float32, horizontal pass
  first, and skips a pass whose size does not change.
- `normalize_inv_depth`, `load_feat_map`: the reference's DPT normalisation
  and the per-pixel L2-normalised DINO map.
"""

from __future__ import annotations

import math
from typing import Tuple

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


def _bilinear_coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs for the bilinear filter (support 1): (xmin
    (out,), normalised float64 weights (out, ksize))."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        ww = sum(k)
        kk[xx, :xmax] = [w / ww if ww != 0.0 else w for w in k]
        xmins[xx] = xmin
    return xmins, kk


def _bilinear_pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass of PIL's 32-bit float resampler along `axis` of a 2-D float32 map."""
    in_size = img.shape[axis]
    xmins, kk = _bilinear_coeffs(in_size, out_size)
    shape = list(img.shape)
    shape[axis] = out_size
    acc = np.zeros(shape, np.float64)
    wshape = [1, 1]
    wshape[axis] = out_size
    for x in range(kk.shape[1]):  # weights past a pixel's window are 0, so the clamped index is harmless
        src = np.take(img, np.minimum(xmins + x, in_size - 1), axis=axis).astype(np.float64)
        acc += src * kk[:, x].reshape(wshape)
    return acc.astype(np.float32)


def _resize_map(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    out = np.asarray(arr, np.float32)
    if w != out.shape[1]:
        out = _bilinear_pass(out, 1, w)
    if h != out.shape[0]:
        out = _bilinear_pass(out, 0, h)
    return np.ascontiguousarray(out)


def resize_bilinear(arr: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """Float bilinear resize to (W, H), channels resized one at a time, equal
    to PIL's `Image.fromarray(c, mode="F").resize(wh, Image.BILINEAR)`."""
    w, h = wh
    if arr.ndim == 2:
        return _resize_map(arr, w, h)
    return np.stack([_resize_map(arr[..., c], w, h) for c in range(arr.shape[-1])], axis=-1)


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
