"""Camera-frame ray directions and world-frame rays (upnerf/geometry/rays.py).

No +0.5 pixel centring (calibration of internet photos is too loose for it
to matter, and the reference leaves it out); "right-up-back" camera frame:
x right, y up, the camera looks down -z.
"""

from __future__ import annotations

from typing import Tuple

import torch


def get_ray_directions(H: int, W: int, K) -> torch.Tensor:
    """(H, W, 3) camera-frame directions of every pixel, for one (3, 3)
    intrinsics matrix K (the formula of pixel_directions)."""
    K = torch.as_tensor(K)
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32), torch.arange(W, dtype=torch.float32), indexing="ij")
    return pixel_directions(i, j, K.float())


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


def get_ndc_rays(H, W, focal, near, rays_o: torch.Tensor, rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """World rays -> rays in the NDC cube (the reference's utils/ray.py:70-111).
    UP-NeRF's own path does not use it: its scene bounds are metric."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]
    o0 = -1.0 / (W / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
