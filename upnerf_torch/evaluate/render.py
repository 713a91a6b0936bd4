"""Free-pose rendering of full images in ray chunks (upnerf/evaluate/render.py).

A Python loop over fixed-size chunks replaces the JAX package's `lax.map`;
each chunk is one `render_rays` call at phase 2, deterministic, with the
appearance embedding of one training image. With `fast`, a sigma-only probe of
the coarse field first tightens each ray's [near, far] and the render spends a
reduced sample budget inside it (upnerf_torch/render/fast.py).

A frame is the span `serve.frame`, tiled by `serve.upload` (the pixel grid
and the pose to the card), one `serve.chunk` a chunk and `serve.to_host`
(the crop and the copy back, where the host waits for the card); see
`utils/profiling.py`, whose spans are off by default.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from upnerf_torch.geometry import rays as ray_utils
from upnerf_torch.render.fast import FastRenderConfig, fast_render_config, tighten_rays
from upnerf_torch.render.render_rays import RenderConfig, render_rays
from upnerf_torch.utils.profiling import span


def make_pose_renderer(rcfg: RenderConfig, chunk: int = 4096, fast: Optional[FastRenderConfig] = None) -> Callable:
    """render(params, K, pose, px, py, near_far, a_idx) -> (rgb (n, 3), depth (n,)).

    px/py are flat pixel coordinates whose length is a multiple of `chunk`;
    K (3, 3), pose (3, 4) and near_far (2,) are tensors on the render
    device; a_idx picks the appearance embedding row. fast: serving-only
    interval tightening with a reduced sample budget."""
    render_cfg = rcfg if fast is None else fast_render_config(rcfg, fast)

    @torch.no_grad()
    def render(params: Dict[str, Any], K, pose, px, py, near_far, a_idx: int):
        n = px.shape[0]
        if n % chunk:
            raise ValueError(f"{n} pixels is not a multiple of the chunk size {chunk}")
        rgbs, depths = [], []
        idx = torch.full((chunk,), int(a_idx), dtype=torch.long, device=px.device)
        for c0 in range(0, n, chunk):
            with span("serve.chunk"):
                dirs = ray_utils.pixel_directions(px[c0 : c0 + chunk], py[c0 : c0 + chunk], K)
                rays_o, rays_d = ray_utils.get_rays(dirs, pose)
                rays = torch.cat([rays_o, rays_d, near_far.expand(chunk, 2)], -1)
                if fast is not None:
                    rays = tighten_rays(params["nerf_coarse"], rcfg, fast, rays, 1.0)
                out = render_rays(params, render_cfg, rays, idx, phase=2, progress=1.0, det=True)
                rgbs.append(out["s_rgb_fine"])
                depths.append(out["s_depth_fine"])
        return torch.cat(rgbs), torch.cat(depths)

    return render


def render_image(
    renderer: Callable,
    params: Dict[str, Any],
    K,
    pose,
    wh: Tuple[int, int],
    near_far,
    a_idx: int,
    chunk: int = 4096,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full (H, W) image: (rgb (H, W, 3), depth (H, W)) as numpy arrays.
    The pixel grid is padded to a chunk multiple and cropped back."""
    if device is None:
        device = params["nerf_coarse"].progress.device
    w, h = int(wh[0]), int(wh[1])
    n = h * w

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    with span("serve.frame"):
        with span("serve.upload"):
            jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            pad = (-n) % chunk
            px = t(np.pad(ii.ravel().astype(np.float32), (0, pad)))
            py = t(np.pad(jj.ravel().astype(np.float32), (0, pad)))
            K, pose, near_far = t(K), t(pose), t(near_far)
        rgb, depth = renderer(params, K, pose, px, py, near_far, a_idx)
        with span("serve.to_host"):
            return (
                rgb[:n].cpu().numpy().reshape(h, w, 3),
                depth[:n].cpu().numpy().reshape(h, w),
            )
