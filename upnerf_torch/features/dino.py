"""DINO ViT-S/8 dense descriptor extraction (upnerf/features/dino.py).

Resize to 448x448, ImageNet-normalize, run DINO ViT-S/8 with the
patch-embed stride overridden to 4 (overlapping patches: a 111x111 grid,
12,322 tokens with CLS), take the attention key facet of block 9, drop the
CLS token and reshape to (gh, gw, 384); also fit a 3-component PCA per
image for visualization (mean + components .npy).

On the card the attention of every block runs through the flash-attention
kernel (upnerf_torch/ops/attention.py), as the JAX package runs its Pallas
kernel on a TPU.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from upnerf_torch.features import vit
from upnerf_torch.features.images import npy_name, read_rgb_u8, resize_u8

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class DinoExtractor:
    """facet 'key', layer 9, ViT-S/8 at stride 4, on the device its
    parameters live on."""

    def __init__(self, params: Dict, cfg: vit.ViTConfig = vit.ViTConfig(), stride: int = 4, layer: int = 9,
                 load_size: int = 448):
        self.params = params
        self.cfg = cfg
        self.stride = stride
        self.layer = layer
        self.load_size = load_size
        self.device = params["pos_embed"].device

    def _extract(self, params: Dict, img: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) normalized -> (gh, gw, D) keys of block `layer`.

        Only block `layer`'s keys leave the extractor, and they come from its
        ln1 and qkv: its attention, the later blocks and the final norm
        cannot change them, so they are not run (`layer` attention calls an
        image)."""
        tokens, (gh, gw) = vit.embed(params, self.cfg, img, self.stride)
        for i in range(self.layer):
            tokens = vit.block(tokens, params[f"blk{i}"], self.cfg.heads, impl=self.cfg.attn_impl)
        p = params[f"blk{self.layer}"]
        d = self.cfg.dim
        keys = vit.qkv_proj(vit.layer_norm(tokens, p["ln1"]), p)[0, 1:, d : 2 * d]  # drop CLS -> (N, D)
        return keys.reshape(gh, gw, d)

    def preprocess(self, image_u8: np.ndarray) -> torch.Tensor:
        """(H, W, 3) uint8 -> normalized (load_size, load_size, 3) on the
        device; the bilinear resize runs on the host in uint8, as PIL's."""
        x = resize_u8(image_u8, (self.load_size, self.load_size), "bilinear").astype(np.float32) / 255.0
        return torch.from_numpy((x - IMAGENET_MEAN) / IMAGENET_STD).to(self.device)

    def __call__(self, image_u8: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 -> (gh, gw, 384) float32 descriptor map."""
        with torch.no_grad():
            return self._extract(self.params, self.preprocess(image_u8)).cpu().numpy()


def pca_info(feat: np.ndarray, n_components: int = 3):
    """Per-image PCA of L2-normalized descriptors, in float64 on the host.
    Returns (mean, components)."""
    flat = feat.reshape(-1, feat.shape[-1]).astype(np.float64)
    flat = flat / np.linalg.norm(flat, axis=-1, keepdims=True)
    mean = flat.mean(0)
    _, _, vt = np.linalg.svd(flat - mean, full_matrices=False)
    return mean.astype(np.float32), vt[:n_components].astype(np.float32)


def load_dino(weights_path: Optional[str] = None, device="cpu") -> Optional[DinoExtractor]:
    weights_path = weights_path or os.environ.get("UPNERF_DINO_WEIGHTS")
    if weights_path is None or not os.path.isfile(weights_path):
        return None
    from upnerf_torch.utils.weights import vit_params_from_jax

    with np.load(weights_path) as flat:
        return DinoExtractor(vit_params_from_jax(_unflatten(dict(flat)), device=device))


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    """{"a/b/c": array} -> {"a": {"b": {"c": array}}}."""
    tree: Dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = np.asarray(v)
    return tree


def save_features(extractor: DinoExtractor, image_paths, save_dir: str, log=print) -> None:
    """Write <save_dir>/feature_maps/<stem>.npy and
    pca_infos/<stem>_{mean,components}.npy."""
    feat_dir = os.path.join(save_dir, "feature_maps")
    pca_dir = os.path.join(save_dir, "pca_infos")
    os.makedirs(feat_dir, exist_ok=True)
    os.makedirs(pca_dir, exist_ok=True)
    for i, path in enumerate(image_paths):
        feat = extractor(read_rgb_u8(path))
        stem = npy_name(path)[:-4]
        np.save(os.path.join(feat_dir, stem + ".npy"), feat)
        mean, comps = pca_info(feat)
        np.save(os.path.join(pca_dir, stem + "_mean.npy"), mean)
        np.save(os.path.join(pca_dir, stem + "_components.npy"), comps)
        log(f"[dino] {i + 1}/{len(image_paths)} {stem}")
