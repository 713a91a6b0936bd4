"""Alpha compositing along the sample axis (upnerf/render/volume.py)."""

from __future__ import annotations

from typing import Tuple

import torch

# The reference treats the last interval as quasi-infinite.
LAST_DELTA = 1e2


def deltas_from_z(z_vals: torch.Tensor) -> torch.Tensor:
    """(N_rays, S) depths -> (N_rays, S) interval lengths, last = 1e2."""
    d = z_vals[:, 1:] - z_vals[:, :-1]
    return torch.cat([d, torch.full_like(d[:, :1], LAST_DELTA)], -1)


def transmittance_of(alphas: torch.Tensor) -> torch.Tensor:
    """prod_{j<i} (1 - alpha_j), exclusive."""
    shifted = torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas[:, :-1]], -1)
    return torch.cumprod(shifted, -1)


def composite_weights(alphas: torch.Tensor) -> torch.Tensor:
    """weights_i = alpha_i * prod_{j<i} (1 - alpha_j)."""
    return alphas * transmittance_of(alphas)


def alpha_from_sigma(sigma: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """1 - exp(-delta * sigma)."""
    return 1.0 - torch.exp(-deltas * sigma)


def weighted_sum(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(N_rays, S) weights x (N_rays, S, C) values -> (N_rays, C)."""
    return (weights[..., None] * values).sum(dim=-2)


def depth_map(weights: torch.Tensor, z_vals: torch.Tensor) -> torch.Tensor:
    """(N_rays, S) -> (N_rays,) expected depth."""
    return (weights * z_vals).sum(dim=-1)


def merge_sorted_z(*z_sets: torch.Tensor) -> torch.Tensor:
    """Concatenate depth sample sets along the sample axis and sort."""
    return torch.sort(torch.cat(z_sets, -1), -1).values


def split_alphas(
    s_sigma: torch.Tensor, c_sigma: torch.Tensor, deltas: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s_alpha, c_alpha, joint_alpha) for the candidate branch."""
    return (
        alpha_from_sigma(s_sigma, deltas),
        alpha_from_sigma(c_sigma, deltas),
        alpha_from_sigma(s_sigma + c_sigma, deltas),
    )
