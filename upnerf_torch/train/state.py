"""Train state and device-resident scene / ray-store structures
(upnerf/train/state.py).

- `UPNeRF`: the group-1 (model optimizer) parameters as one nn.Module whose
  state_dict keys are the reference's (`nerf_coarse.*`, `nerf_fine.*`,
  `transient_net.*`, `embedding_{coarse,fine}_{a,c}.weight`).
- `PoseTables`: the se3 refinement and depth scale/shift tables
  (`se3_refine.weight`, `depth_scale.weight`), zero at init.
- `SceneConstants`: per-image tables and the DINO feature stack (bf16).
- `RayStore`: the compact per-ray record. The JAX package keeps pixel
  coordinates as uint16; torch.uint16 supports few operations, so the port
  widens them to int32 once, when the store is built (`make_ray_store`).
- `TrainState`: step, the two modules, the two optimizer states and an
  explicit torch.Generator on the train device (the JAX package's raw key).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from upnerf_torch.models.embeddings import init_embedding
from upnerf_torch.models.nerf import NeRFConfig, NeRFField
from upnerf_torch.models.transient import TransientConfig, TransientNet

EMBEDDINGS = (
    ("coarse_a", "embedding_coarse_a"),
    ("fine_a", "embedding_fine_a"),
    ("coarse_c", "embedding_coarse_c"),
    ("fine_c", "embedding_fine_c"),
)


class UPNeRF(nn.Module):
    """NeRF coarse/fine fields, the transient net and the per-image
    appearance/candidate embeddings, in the reference's parameter names."""

    def __init__(self, nerf_cfg: NeRFConfig, t_cfg: Optional[TransientConfig], n_images: int, fine: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nerf_coarse = NeRFField(nerf_cfg, generator=generator)
        self.nerf_fine = NeRFField(nerf_cfg, generator=generator) if fine else None
        self.transient_net = TransientNet(t_cfg, n_images, generator) if t_cfg is not None else None
        for ours, theirs in EMBEDDINGS:
            dim = nerf_cfg.appearance_dim if ours.endswith("_a") else nerf_cfg.candidate_dim
            if dim > 0 and (fine or ours.startswith("coarse")):
                setattr(self, theirs, init_embedding(n_images, dim, generator))

    def render_params(self) -> Dict[str, Any]:
        """The render_rays params dict: fields and embedding tables."""
        emb = {ours: getattr(self, theirs).weight for ours, theirs in EMBEDDINGS if hasattr(self, theirs)}
        return {"nerf_coarse": self.nerf_coarse, "nerf_fine": self.nerf_fine, "embeddings": emb}

    def set_progress(self, progress: float) -> None:
        """The BARF schedule position the reference checkpoint records."""
        with torch.no_grad():
            for f in (self.nerf_coarse, self.nerf_fine):
                if f is not None:
                    f.progress.fill_(progress)


class PoseTables(nn.Module):
    """Per-image se3 refinement (N, 6) and depth scale/shift (N, 2), zero."""

    def __init__(self, n_images: int):
        super().__init__()
        self.se3_refine = nn.Embedding(n_images, 6)
        self.depth_scale = nn.Embedding(n_images, 2)
        with torch.no_grad():
            self.se3_refine.weight.zero_()
            self.depth_scale.weight.zero_()


class SceneConstants(NamedTuple):
    Ks: torch.Tensor  # (N_img, 3, 3)
    poses: torch.Tensor  # (N_img, 3, 4) base c2w
    near_far: torch.Tensor  # (N_img, 2)
    wh: torch.Tensor  # (N_img, 2) image sizes (W, H)
    feat_maps: Optional[torch.Tensor]  # (N_img, h, w, C), bf16
    feat_maps_coarse: Optional[torch.Tensor] = None  # low-pass level for feat.c2f


class RayStore(NamedTuple):
    px: torch.Tensor  # (N,) int32 pixel column
    py: torch.Tensor  # (N,) int32 pixel row
    img_idx: torch.Tensor  # (N,) int64
    rgb: torch.Tensor  # (N, 3) uint8
    inv_depth: torch.Tensor  # (N,) float16 normalised DPT inverse depth

    @property
    def n_rays(self) -> int:
        return self.px.shape[0]


class TrainState(NamedTuple):
    step: int
    params: UPNeRF
    pose_params: PoseTables
    opt_state: Any
    pose_opt_state: Any
    generator: torch.Generator


def init_params(nerf_cfg: NeRFConfig, t_cfg: Optional[TransientConfig], n_images: int, fine: bool = True,
                generator: Optional[torch.Generator] = None) -> UPNeRF:
    return UPNeRF(nerf_cfg, t_cfg, n_images, fine, generator)


def init_pose_params(n_images: int) -> PoseTables:
    return PoseTables(n_images)


def make_train_state(params: UPNeRF, pose_params: PoseTables, optimizer, pose_optimizer, seed: int,
                     device) -> TrainState:
    """Move both modules to `device` and build the optimizer states there."""
    params = params.to(device)
    pose_params = pose_params.to(device)
    trainable = [p for p in params.parameters() if p.requires_grad]
    return TrainState(
        step=0, params=params, pose_params=pose_params, opt_state=optimizer.init(trainable),
        pose_opt_state=pose_optimizer.init(pose_params.parameters()) if pose_optimizer is not None else None,
        generator=torch.Generator(device=device).manual_seed(seed),
    )


def make_ray_store(px, py, img_idx, rgb, inv_depth, device) -> RayStore:
    """The store on `device`, pixel coordinates widened to int32."""
    return RayStore(
        px=torch.as_tensor(np.asarray(px, np.int32), device=device),
        py=torch.as_tensor(np.asarray(py, np.int32), device=device),
        img_idx=torch.as_tensor(np.asarray(img_idx, np.int64), device=device),
        rgb=torch.as_tensor(np.asarray(rgb, np.uint8), device=device),
        inv_depth=torch.as_tensor(np.asarray(inv_depth, np.float16), device=device),
    )


def make_scene_constants(Ks, poses, near_far, wh, feat_maps, device, feat_dtype=torch.bfloat16,
                         feat_pyramid_sigma: float = 0.0) -> SceneConstants:
    """feat_pyramid_sigma > 0 also stores a Gaussian-smoothed, re-normalised
    level of the feature stack for the `feat.c2f` schedule."""
    coarse = None
    if feat_maps is not None and feat_pyramid_sigma > 0:
        coarse = blur_feat_stack(np.asarray(feat_maps, np.float32), feat_pyramid_sigma)

    def t(a, dtype):
        return None if a is None else torch.as_tensor(np.asarray(a, np.float32)).to(device=device, dtype=dtype)

    return SceneConstants(
        Ks=t(Ks, torch.float32), poses=t(poses, torch.float32), near_far=t(near_far, torch.float32),
        wh=torch.as_tensor(np.asarray(wh, np.int32), device=device),
        feat_maps=t(feat_maps, feat_dtype), feat_maps_coarse=t(coarse, feat_dtype),
    )


def blur_feat_stack(feat_maps: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian low-pass over the (h, w) axes of an (N, h, w, C)
    stack, re-L2-normalised per cell. Host-side numpy, once at scene build."""
    out = feat_maps.astype(np.float32)
    for axis in (1, 2):
        out = gaussian_1d(out, sigma, axis)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(norm, 1e-8)).astype(np.float32)


def gaussian_1d(arr: np.ndarray, sigma: float, axis: int) -> np.ndarray:
    """Edge-padded Gaussian convolution along one axis, as one band-matrix
    contraction."""
    r = max(1, int(round(3 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    n = arr.shape[axis]
    band = np.zeros((n, n + 2 * r), np.float32)
    for i in range(n):
        band[i, i : i + 2 * r + 1] = k
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (r, r)
    out = np.tensordot(band, np.pad(arr, pad, mode="edge"), axes=([1], [axis]))
    return np.moveaxis(out, 0, axis).astype(arr.dtype, copy=False)
