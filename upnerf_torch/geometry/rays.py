"""Camera-frame ray directions and world-frame rays (upnerf/geometry/rays.py).

No +0.5 pixel centring (calibration of internet photos is too loose for it
to matter, and the reference leaves it out); "right-up-back" camera frame:
x right, y up, the camera looks down -z.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pixel_directions(px: torch.Tensor, py: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(N, 3) camera-frame directions from pixel columns/rows `px`, `py`
    (N,) and intrinsics K (3, 3) or per-ray (N, 3, 3)."""
    px = px.float()
    py = py.float()
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    return torch.stack([(px - cx) / fx, -(py - cy) / fy, -torch.ones_like(px)], dim=-1)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-frame origins and unit directions, both (N, 3).

    directions: (..., 3) camera-frame; c2w: one (3, 4) pose, or (N, 3, 4)
    per-ray poses when directions is (N, 3)."""
    if c2w.dim() == 3 and directions.dim() == 2 and c2w.shape[0] == directions.shape[0]:
        rays_d = torch.einsum("nij,nj->ni", c2w[:, :, :3], directions)
        rays_o = c2w[..., 3]
    else:
        rays_d = directions @ c2w[:, :3].t()
        rays_o = c2w[:, 3].expand(rays_d.shape)
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
