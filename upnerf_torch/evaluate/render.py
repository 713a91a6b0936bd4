"""Free-pose rendering of full images in ray chunks (upnerf/evaluate/render.py).

A Python loop over fixed-size chunks replaces the JAX package's `lax.map`;
each chunk is one `render_chunk` call (rays through the chunk's pixels, then
`render_rays` at phase 2, deterministic, with the appearance embedding of one
training image). With `fast`, a sigma-only probe of the coarse field first
tightens each ray's [near, far] and the render spends a reduced sample budget
inside it (upnerf_torch/render/fast.py).

On a CUDA device the renderer captures one chunk into a CUDA graph and
replays it for every later chunk: the graph reads static input buffers (the
chunk's pixels, refreshed by two copies a chunk; the camera, pose, bounds and
appearance row, once a frame) and writes static outputs, which two copies
move into the frame's result. The first chunk after a change of the params'
tensors (another params object, or a tensor with new storage) runs eagerly,
which warms every cache and library the chunk uses, and then the chunk is
captured anew; one graph a renderer is kept. The graph reads the
parameters by address and packs the kernels' weights from them inside every
replay, so an in-place update (`load_state_dict`, an optimizer step) is seen
by the next replay. A replay runs the eager chunk's kernels in the same
order on the same inputs: the same bits. On the CPU every chunk runs
eagerly. `graph_captures` and `graph_replays` count captures and the
chunks served by a replay; on each replay the launch counters of ops/*.py
advance by the launches the graph holds.

A frame is the span `serve.frame`, tiled by `serve.upload` (the pixel grid
and the pose to the card), one `serve.chunk` a chunk and `serve.to_host`
(the crop and the copy back, where the host waits for the card); see
`utils/profiling.py`, whose spans are off by default.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from upnerf_torch.geometry import rays as ray_utils
from upnerf_torch.ops import heads, mlp, render_train
from upnerf_torch.ops import render as static_render
from upnerf_torch.render.fast import FastRenderConfig, fast_render_config, tighten_rays
from upnerf_torch.render.render_rays import RenderConfig, render_rays
from upnerf_torch.utils.profiling import span

# Chunks served through CUDA graphs in this process: each capture of a chunk,
# and each chunk served by a replay.
graph_captures = 0
graph_replays = 0

_COUNTED = (heads, mlp, render_train, static_render)  # the ops modules a chunk's routes launch through


def _launch_counts() -> Dict[Tuple[Any, str], int]:
    """Every launch counter of the ops modules: their int globals named `*launches`."""
    return {(m, k): v for m in _COUNTED for k, v in vars(m).items() if k.endswith("launches") and type(v) is int}


def render_chunk(params: Dict[str, Any], rcfg: RenderConfig, fast: Optional[FastRenderConfig], px, py, K, pose,
                 near_far, idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk: the rays through pixels px, py (chunk,) of camera K (3, 3)
    at pose (3, 4), bounded by near_far (2,), rendered with the appearance
    rows idx (chunk,) -> (rgb (chunk, 3), depth (chunk,)). fast: interval
    tightening, then the reduced budget. Every op has a fixed shape."""
    chunk = px.shape[0]
    dirs = ray_utils.pixel_directions(px, py, K)
    rays_o, rays_d = ray_utils.get_rays(dirs, pose)
    rays = torch.cat([rays_o, rays_d, near_far.expand(chunk, 2)], -1)
    if fast is not None:
        rays = tighten_rays(params["nerf_coarse"], rcfg, fast, rays, 1.0)
        rcfg = fast_render_config(rcfg, fast)
    out = render_rays(params, rcfg, rays, idx, phase=2, progress=1.0, det=True)
    return out["s_rgb_fine"], out["s_depth_fine"]


def params_key(params: Dict[str, Any]) -> tuple:
    """What a captured chunk reads by address: each field's configuration and
    the (pointer, device, dtype, shape, strides) of every parameter, buffer
    and embedding table of params."""
    key = []

    def walk(v) -> None:
        if isinstance(v, torch.nn.Module):
            key.append(getattr(v, "cfg", None))
            for t in itertools.chain(v.parameters(), v.buffers()):
                walk(t)
        elif isinstance(v, torch.Tensor):
            key.append((v.data_ptr(), v.device, v.dtype, tuple(v.shape), v.stride()))
        elif isinstance(v, dict):
            for k, x in v.items():
                key.append(k)
                walk(x)
        elif v is not None:
            raise TypeError(f"params hold a {type(v).__name__}")

    walk(params)
    return tuple(key)


class _ChunkGraph:
    """One chunk of a renderer for one params key, as a CUDA graph: static
    inputs (px, py, K, pose, near_far, idx), static outputs (rgb, depth).
    The first call runs the chunk eagerly and captures it; every later call
    replays it."""

    def __init__(self, params: Dict[str, Any], rcfg: RenderConfig, fast: Optional[FastRenderConfig], key: tuple,
                 chunk: int, device: torch.device):
        f32 = dict(dtype=torch.float32, device=device)
        self.key = key
        self.inputs = (torch.zeros(chunk, **f32), torch.zeros(chunk, **f32), torch.zeros((3, 3), **f32),
                       torch.zeros((3, 4), **f32), torch.zeros(2, **f32),
                       torch.zeros(chunk, dtype=torch.long, device=device))
        self.params, self.rcfg, self.fast = params, rcfg, fast  # for the capture; dropped after it
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.launched: Dict[Tuple[Any, str], int] = {}  # the launch counters' steps a replay takes

    def frame(self, K, pose, near_far, a_idx: int) -> None:
        """The frame's camera, pose, bounds and appearance row into the static inputs."""
        for dst, src in zip(self.inputs[2:5], (K, pose, near_far)):
            dst.copy_(src)
        self.inputs[5].fill_(int(a_idx))

    def __call__(self, px, py) -> Tuple[torch.Tensor, torch.Tensor]:
        global graph_captures, graph_replays
        self.inputs[0].copy_(px)
        self.inputs[1].copy_(py)
        if self.graph is not None:
            self.graph.replay()
            for (m, k), n in self.launched.items():
                setattr(m, k, getattr(m, k) + n)
            graph_replays += 1
            return self.outputs
        chunk = lambda: render_chunk(self.params, self.rcfg, self.fast, *self.inputs)  # noqa: E731
        # The warm-up (lazy initialisation, the weight-layout plans and their device indices, library loads) runs on
        # the current stream, and its result serves this chunk. cuBLAS keeps a workspace (32 MiB on an H100) for
        # each stream it has run on, for the life of the process: a warm-up on a side stream would add one, and the
        # capture stream adds its own inside the graph's pool. So the other streams' workspaces are freed first; a
        # later product on them takes a new one.
        out = chunk()
        torch._C._cuda_clearCublasWorkspaces()
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):  # records the launches; runs nothing
                self.outputs = chunk()
            after = _launch_counts()
        finally:  # the counters count what ran
            for (m, k), v in before.items():
                setattr(m, k, v)
        self.launched = {k: after[k] - v for k, v in before.items() if after[k] != v}
        self.graph = graph
        self.params = self.rcfg = self.fast = None
        graph_captures += 1
        return out


def make_pose_renderer(rcfg: RenderConfig, chunk: int = 4096, fast: Optional[FastRenderConfig] = None) -> Callable:
    """render(params, K, pose, px, py, near_far, a_idx) -> (rgb (n, 3), depth (n,)).

    px/py are flat pixel coordinates whose length is a multiple of `chunk`;
    K (3, 3), pose (3, 4) and near_far (2,) are tensors on the render
    device; a_idx picks the appearance embedding row. fast: serving-only
    interval tightening with a reduced sample budget. On a CUDA device the
    chunks are replays of one captured chunk (the module's docstring)."""
    graph: Optional[_ChunkGraph] = None

    @torch.no_grad()
    def render(params: Dict[str, Any], K, pose, px, py, near_far, a_idx: int):
        nonlocal graph
        n = px.shape[0]
        if n % chunk:
            raise ValueError(f"{n} pixels is not a multiple of the chunk size {chunk}")
        if px.device.type == "cuda":
            key = params_key(params)
            if graph is None or graph.key != key:
                graph = None  # the old graph's memory goes before the new capture takes its own
                graph = _ChunkGraph(params, rcfg, fast, key, chunk, px.device)
            graph.frame(K, pose, near_far, a_idx)
            run = graph
        else:
            idx = torch.full((chunk,), int(a_idx), dtype=torch.long, device=px.device)
            run = lambda px_c, py_c: render_chunk(params, rcfg, fast, px_c, py_c, K, pose, near_far, idx)  # noqa: E731
        rgb, depth = px.new_empty((n, 3)), px.new_empty((n,))
        for c0 in range(0, n, chunk):
            with span("serve.chunk"):
                rgb_c, depth_c = run(px[c0 : c0 + chunk], py[c0 : c0 + chunk])
                rgb[c0 : c0 + chunk].copy_(rgb_c)
                depth[c0 : c0 + chunk].copy_(depth_c)
        return rgb, depth

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
