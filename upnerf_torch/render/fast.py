"""Fast serving renders: per-ray interval tightening (upnerf/render/fast.py).

A sigma-only probe of the coarse field (its trunk through the fused trunk
kernel, upnerf_torch/ops/mlp.py) tightens each ray's [near, far] to where the
transmittance-weighted mass lives, and the coarse + fine render then spends a
smaller fixed sample budget inside it. Rays carry per-ray near/far ((R, 8)
layout), so the tightened rays drop into the unchanged render path. Serving
only: training, validation and test-time optimization do not use it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from upnerf_torch.models.nerf import NeRFField

from . import volume
from .render_rays import RenderConfig


class FastRenderConfig(NamedTuple):
    """Probe configuration for interval tightening (the JAX package's
    measured-lossless defaults)."""

    n_probe: int = 64       # sigma-only probe samples per ray
    eps: float = 1e-5       # weight-CDF mass clipped off each end
    pad: int = 3            # extra probe bins kept beyond the clip points
    min_mass: float = 1e-2  # rays with less total probe mass keep [near, far]
    # The reduced render budget inside the tightened interval; 0 keeps the
    # caller's RenderConfig counts.
    N_samples: int = 64
    N_importance: int = 64


def tighten_from_weights(
    z_vals: torch.Tensor,  # (R, P) probe depths
    weights: torch.Tensor,  # (R, P) composite weights of the probe
    near: torch.Tensor,  # (R, 1)
    far: torch.Tensor,  # (R, 1)
    eps: float,
    pad: int,
    min_mass: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The smallest [z_lo, z_hi] holding the central (1 - 2 eps) of the probe's
    weight mass, padded by `pad` probe bins; rays with negligible mass keep
    [near, far]."""
    P = z_vals.shape[1]
    total = weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(weights, -1) / torch.clamp(total, min=1e-12)
    lo_i = torch.argmax((cdf > eps).to(torch.uint8), -1)  # first bin past the left clip (0 if none)
    # right clip: first bin at >= 1 - eps of the mass; the last bin if rounding leaves none
    hi_mask = cdf >= 1.0 - eps
    hi_i = torch.where(hi_mask.any(-1), torch.argmax(hi_mask.to(torch.uint8), -1), torch.full_like(lo_i, P - 1))
    lo_i = torch.clamp(lo_i - pad, min=0)
    hi_i = torch.clamp(hi_i + pad, max=P - 1)
    z_lo = torch.gather(z_vals, 1, lo_i[:, None])
    z_hi = torch.gather(z_vals, 1, hi_i[:, None])
    keep_full = total <= min_mass
    z_lo = torch.where(keep_full, near, torch.maximum(z_lo, near))
    z_hi = torch.where(keep_full, far, torch.minimum(z_hi, far))
    # a non-degenerate interval inside [near, far]: lower z_lo after the clamps
    z_lo = torch.minimum(z_lo, z_hi - 1e-4)
    return z_lo, z_hi


def tighten_rays(
    coarse: NeRFField,
    rcfg: RenderConfig,
    fast: FastRenderConfig,
    rays: torch.Tensor,  # (R, 8)
    progress: float,
) -> torch.Tensor:
    """Sigma-only probe of the coarse field -> the rays with tightened per-ray
    near/far, same (R, 8) layout."""
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    t = torch.linspace(0.0, 1.0, fast.n_probe, device=rays.device)
    z = near * (1.0 - t) + far * t  # (R, P), linear in depth (the det path)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    sigma = coarse(xyz, rays_d, None, progress=progress, precision=rcfg.precision, sigma_only=True)["s_sigma"]
    weights = volume.composite_weights(volume.alpha_from_sigma(sigma, volume.deltas_from_z(z)))
    z_lo, z_hi = tighten_from_weights(z, weights, near, far, fast.eps, fast.pad, fast.min_mass)
    return torch.cat([rays_o, rays_d, z_lo, z_hi], -1)


def fast_render_config(rcfg: RenderConfig, fast: FastRenderConfig) -> RenderConfig:
    """The reduced-budget RenderConfig used inside tightened intervals."""
    return rcfg._replace(N_samples=fast.N_samples or rcfg.N_samples,
                         N_importance=fast.N_importance or rcfg.N_importance)
