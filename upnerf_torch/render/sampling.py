"""Depth sampling along rays: stratified coarse + inverse-CDF importance
(upnerf/render/sampling.py).

Randomness comes from a torch.Generator or from pre-drawn uniforms `u`,
which take precedence; the tests hand both frameworks the same `u`.
"""

from __future__ import annotations

from typing import Optional

import torch


def stratified_z_vals(
    near: torch.Tensor,  # (N_rays, 1)
    far: torch.Tensor,  # (N_rays, 1)
    N_samples: int,
    use_disp: bool = False,
    perturb: float = 0.0,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,  # (N_rays, N_samples) pre-drawn U(0,1)
) -> torch.Tensor:
    """Coarse depth samples, (N_rays, N_samples): linear in depth (or
    disparity), jittered within mid-point intervals when perturb > 0 and a
    generator or `u` is given."""
    z_steps = torch.linspace(0.0, 1.0, N_samples, device=near.device)
    if not use_disp:
        z_vals = near * (1 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1 - z_steps) + 1.0 / far * z_steps)
    z_vals = z_vals.expand(near.shape[0], N_samples)

    if perturb > 0 and (generator is not None or u is not None):
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([z_mid, z_vals[:, -1:]], -1)
        lower = torch.cat([z_vals[:, :1], z_mid], -1)
        if u is None:
            u = torch.rand(z_vals.shape, generator=generator, device=near.device)
        z_vals = lower + (upper - lower) * (perturb * u)
    return z_vals


def sample_pdf(
    bins: torch.Tensor,  # (N_rays, M+1) bin edges
    weights: torch.Tensor,  # (N_rays, M)
    N_importance: int,
    det: bool = False,
    eps: float = 1e-5,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,  # (N_rays, N_importance) pre-drawn
) -> torch.Tensor:
    """Inverse-CDF sampling; the +eps floor and the denom < eps guard are
    the reference's. det=True (or no generator and no `u`) uses a linspace
    grid, the eval path."""
    N_rays, M = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)  # (N_rays, M+1)

    if det or (generator is None and u is None):
        u = torch.linspace(0.0, 1.0, N_importance, device=bins.device).expand(N_rays, N_importance)
    elif u is None:
        u = torch.rand((N_rays, N_importance), generator=generator, device=bins.device)
    u = u.contiguous()

    # side='right': inds = #{j : cdf_j <= u}; below = inds - 1 >= 0 since cdf_0 = 0.
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=M)
    cdf_g0 = torch.gather(cdf, 1, below)
    cdf_g1 = torch.gather(cdf, 1, above)
    bins_g0 = torch.gather(bins, 1, below)
    bins_g1 = torch.gather(bins, 1, above)

    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_g0 + (u - cdf_g0) / denom * (bins_g1 - bins_g0)
