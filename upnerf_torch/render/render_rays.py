"""Coarse + fine volume renderer (upnerf/render/render_rays.py), phase 2.

Phase 2 is the rgb-only schedule phase: the phase of every val, eval and
novel-view render. Each pass (coarse at N_samples, fine at N_samples +
N_importance merged samples) goes through the fused forward of
upnerf_torch.ops.render_train, as the JAX package's `_fused_train_path`
does: the per-ray rgb conditioning

    ray_cond = PE(dir) @ W_rgb1[F:F+27] + b_rgb1 + a_emb @ W_rgb1[F+27:]

is computed outside the kernel (a small per-ray product), and the kernel
builds xyz, its PE, the trunk, the heads and the compositing. Directions are
inputs only (no gradient flows through this forward-only path). Phases 0/1
(the candidate branch and the feature output) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from upnerf_torch.models.nerf import NeRFField, band_weights, positional_encoding
from upnerf_torch.ops import render_train as rt
from upnerf_torch.ops.linear import canonical_precision

from . import volume
from .sampling import sample_pdf, stratified_z_vals


class RenderConfig(NamedTuple):
    """Static rendering hyperparameters."""

    N_samples: int = 128
    N_importance: int = 128
    use_disp: bool = False
    perturb: float = 1.0
    precision: str = "float32"

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any]) -> "RenderConfig":
        return cls(
            N_samples=hp["nerf.N_samples"],
            N_importance=hp["nerf.N_importance"],
            use_disp=hp["nerf.use_disp"],
            perturb=hp["nerf.perturb"],
            precision=canonical_precision(hp.get("tpu.matmul_precision", "float32")),
        )


def field_weights(field: NeRFField):
    """(trunk, heads) of one field in the fused forward's interface: (in,
    out) matrices as in the JAX package; the rgb1 bias goes into ray_cond."""
    trunk = [(lay.weight.t(), lay.bias) for lay in field.trunk_layers()]
    F = field.cfg.feat_dim
    heads = {
        "xyzf_w": field.xyz_encoding_final.weight.t(),
        "xyzf_b": field.xyz_encoding_final.bias,
        "sigma_w": field.share_sigma[0].weight.t(),
        "sigma_b": field.share_sigma[0].bias,
        "feat_w": field.feat_share_layer.weight.t(),
        "feat_b": field.feat_share_layer.bias,
        "rgb1_w": field.rgb_share_layer[0].weight[:, :F].t(),
        "rgb2_w": field.rgb_share_layer[2].weight.t(),
        "rgb2_b": field.rgb_share_layer[2].bias,
    }
    return trunk, heads


def ray_conditioning(
    field: NeRFField, rays_d: torch.Tensor, a_emb: Optional[torch.Tensor], progress: float
) -> torch.Tensor:
    """(R, W/2) per-ray part of the rgb head's first layer, bias included:
    concat(feat, PE(dir), a) @ W == feat @ W0 + (PE(dir) @ W1 + b + a @ W2)."""
    cfg = field.cfg
    dir_pe = positional_encoding(rays_d, cfg.dir_L, band_weights(cfg, cfg.dir_L, progress, rays_d.device))
    rgb1 = field.rgb_share_layer[0]
    F, dd = cfg.feat_dim, dir_pe.shape[-1]
    ray_cond = dir_pe @ rgb1.weight[:, F : F + dd].t() + rgb1.bias
    if cfg.encode_appearance:
        ray_cond = ray_cond + a_emb @ rgb1.weight[:, F + dd :].t()
    return ray_cond.contiguous()


def _inference(
    results: Dict[str, torch.Tensor],
    field: NeRFField,
    typ: str,
    rays_o: torch.Tensor,  # (R, 3)
    rays_d: torch.Tensor,  # (R, 3)
    z_vals: torch.Tensor,  # (R, S)
    a_emb: Optional[torch.Tensor],  # (R, A)
    *,
    progress: float,
    precision: str,
) -> None:
    """One pass through the fused forward; adds s_weights/s_rgb/s_depth
    with the suffix `typ` ('coarse' | 'fine') to `results`."""
    cfg = field.cfg
    if not cfg.encode_feat:
        raise NotImplementedError("the feature-less field is not ported")
    w_xyz = band_weights(cfg, cfg.xyz_L, progress, rays_o.device)
    ray_cond = ray_conditioning(field, rays_d, a_emb, progress)
    trunk, heads = field_weights(field)
    st = rt.RTStatic(D=cfg.D, skips=tuple(cfg.skips), xyz_L=cfg.xyz_L, precision=precision)
    out = rt.render_train_rays_fwd(
        rays_o.contiguous(), rays_d.contiguous(), z_vals.contiguous(), w_xyz, ray_cond, trunk, heads, st
    )
    results[f"s_weights_{typ}"] = out["s_weights"]
    results[f"s_rgb_{typ}"] = out["rgb_map"]
    results[f"s_depth_{typ}"] = out["s_depth"]


def render_rays(
    params: Dict[str, Any],
    cfg: RenderConfig,
    rays: torch.Tensor,  # (R, 8): o, d, near, far
    img_idx: torch.Tensor,  # (R,) int
    *,
    phase: int = 2,
    progress: float = 1.0,
    det: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Render a ray batch at phase 2.

    params: {"nerf_coarse": NeRFField, "nerf_fine": NeRFField,
    "embeddings": {"coarse_a": (N_images, A), "fine_a": ...}}; embedding
    rows are gathered by img_idx. det=True, or no generator and no noise,
    gives the deterministic eval path. `noise` supplies pre-drawn uniforms
    {"coarse": (R, N_samples), "fine": (R, N_importance)}."""
    if phase != 2:
        raise NotImplementedError("only phase 2 (rgb) is ported; phases 0/1 need the candidate branch")
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    emb = params["embeddings"]
    if generator is None and noise is None:
        det = True
    noise = noise or {}

    def emb_for(prefix: str):
        table = emb.get(f"{prefix}_a")
        return None if table is None else table[img_idx]

    z_vals = stratified_z_vals(
        near, far, cfg.N_samples, use_disp=cfg.use_disp, perturb=0.0 if det else cfg.perturb,
        generator=generator, u=noise.get("coarse"),
    )
    results: Dict[str, torch.Tensor] = {}
    _inference(results, params["nerf_coarse"], "coarse", rays_o, rays_d, z_vals, emb_for("coarse"),
               progress=progress, precision=cfg.precision)
    if cfg.N_importance > 0:
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        z_samples = sample_pdf(
            z_mid, results["s_weights_coarse"][:, 1:-1], cfg.N_importance, det=det,
            generator=generator, u=noise.get("fine"),
        )
        z_fine = volume.merge_sorted_z(z_vals, z_samples)
        _inference(results, params["nerf_fine"], "fine", rays_o, rays_d, z_fine, emb_for("fine"),
                   progress=progress, precision=cfg.precision)
    return results
