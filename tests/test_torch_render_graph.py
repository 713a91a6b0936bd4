"""The serving renderer's chunks as replays of one CUDA graph
(upnerf_torch/evaluate/render.py).

- On the CPU the renderer stays eager (no capture, no replay), and a frame
  equals its chunks rendered one by one through `render_rays` (and, with
  `fast`, `tighten_rays` first), bit for bit.
- On the card (the `cuda` marker; skips without one), at the kernels'
  widths (W = 256, F = 32, bf16): two frames of different pose and
  appearance row, on the full and the `fast` route, equal the eager chunk
  function's frames bit for bit; the counters read one capture and
  chunks - 1 replays after the first frame, then chunks replays a frame; the
  launch counters advance as in the eager frame; an in-place weight change is
  seen by the next replay with no new capture; a second params object is
  captured anew.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest tests/test_torch_render_graph.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from upnerf_torch.evaluate import render as trender
from upnerf_torch.geometry import rays as ray_utils
from upnerf_torch.models.nerf import NeRFConfig
from upnerf_torch.ops import mlp
from upnerf_torch.ops import render_train as rt
from upnerf_torch.render.fast import FastRenderConfig, fast_render_config, tighten_rays
from upnerf_torch.render.render_rays import RenderConfig, render_rays
from upnerf_torch.train import init_params

N_IMG = 4
TINY = {
    "nerf.D": 2, "nerf.W": 32, "nerf.skips": (1,), "nerf.N_emb_xyz": 4, "nerf.N_emb_dir": 2,
    "nerf.feat_dim": 8, "nerf.appearance_dim": 8, "nerf.candidate_dim": 4, "pose.c2f": (0.1, 0.5),
    "nerf.N_samples": 8, "nerf.N_importance": 8, "nerf.use_disp": False, "nerf.perturb": 0.0,
    "tpu.matmul_precision": "float32",
}
# The serving benchmark's field (portbench/configs/synth_identity_hires.json) at the kernels' widths, bf16.
CARD = {
    "nerf.D": 8, "nerf.W": 256, "nerf.skips": (4,), "nerf.N_emb_xyz": 10, "nerf.N_emb_dir": 4,
    "nerf.feat_dim": 32, "nerf.appearance_dim": 48, "nerf.candidate_dim": 16, "pose.c2f": (0.1, 0.5),
    "nerf.N_samples": 48, "nerf.N_importance": 48, "nerf.use_disp": False, "nerf.perturb": 0.0,
    "tpu.matmul_precision": "bfloat16",
}
NEAR_FAR = [0.1, 5.0]
FAST = FastRenderConfig(N_samples=32, N_importance=32)


def model(hp, seed: int, device):
    gen = torch.Generator().manual_seed(seed)
    m = init_params(NeRFConfig.from_hparams(hp), None, N_IMG, generator=gen).to(device)
    for p in m.parameters():
        p.requires_grad_(False)
    return m


def camera(wh, step: int):
    """K, pose (looking down -z from z = 3, turned by `step`) and the padded pixel grid of a frame."""
    w, h = wh
    K = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]], np.float32)
    a = 0.1 * step
    pose = np.array([[np.cos(a), 0, np.sin(a), 0.3 * np.sin(a)], [0, 1, 0, 0.1 * step],
                     [-np.sin(a), 0, np.cos(a), 3.0]], np.float32)
    jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return K, pose, ii.ravel().astype(np.float32), jj.ravel().astype(np.float32)


def frame_inputs(wh, step, chunk, device):
    K, pose, px, py = camera(wh, step)
    pad = (-px.size) % chunk

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return t(K), t(pose), t(np.pad(px, (0, pad))), t(np.pad(py, (0, pad))), t(NEAR_FAR)


def eager_frame(params, rcfg, fast, K, pose, px, py, near_far, a_idx, chunk):
    """The frame as the chunk function gives it, chunk by chunk, with no graph."""
    idx = torch.full((chunk,), a_idx, dtype=torch.long, device=px.device)
    outs = [trender.render_chunk(params, rcfg, fast, px[c : c + chunk], py[c : c + chunk], K, pose, near_far, idx)
            for c in range(0, px.shape[0], chunk)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def counters():
    trender.graph_captures = trender.graph_replays = 0
    yield trender


@pytest.mark.parametrize("fast", [None, FAST], ids=["full", "fast"])
def test_cpu_renderer_is_eager_and_matches_render_rays(fast, counters):
    chunk = 48
    params = model(TINY, 0, "cpu").render_params()
    rcfg = RenderConfig.from_hparams(TINY)
    renderer = trender.make_pose_renderer(rcfg, chunk=chunk, fast=fast)
    K, pose, px, py, near_far = frame_inputs((16, 8), 1, chunk, "cpu")  # 128 pixels: three chunks, one padded
    with torch.no_grad():
        rgb, depth = renderer(params, K, pose, px, py, near_far, 2)
        want_rgb, want_depth = [], []
        for c in range(0, px.shape[0], chunk):
            rays_o, rays_d = ray_utils.get_rays(ray_utils.pixel_directions(px[c : c + chunk], py[c : c + chunk], K),
                                                pose)
            rays = torch.cat([rays_o, rays_d, near_far.expand(chunk, 2)], -1)
            cfg = rcfg
            if fast is not None:
                rays, cfg = tighten_rays(params["nerf_coarse"], rcfg, fast, rays, 1.0), fast_render_config(rcfg, fast)
            out = render_rays(params, cfg, rays, torch.full((chunk,), 2), phase=2, progress=1.0, det=True)
            want_rgb.append(out["s_rgb_fine"])
            want_depth.append(out["s_depth_fine"])
    assert torch.equal(rgb, torch.cat(want_rgb)) and torch.equal(depth, torch.cat(want_depth))
    assert counters.graph_captures == counters.graph_replays == 0


def test_params_key_follows_storage_not_values():
    m = model(TINY, 0, "cpu")
    params = m.render_params()
    key = trender.params_key(params)
    with torch.no_grad():
        m.nerf_fine.rgb_share_layer[2].bias.add_(1.0)  # in place: the same storage
    assert trender.params_key(params) == key
    m.nerf_fine.rgb_share_layer[2].bias.data = m.nerf_fine.rgb_share_layer[2].bias.data.clone()  # new storage
    assert trender.params_key(params) != key
    assert trender.params_key(model(TINY, 0, "cpu").render_params()) != trender.params_key(params)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def launch_counts():
    return rt.launches, mlp.launches


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [None, FAST], ids=["full", "fast"])
def test_graph_frames_equal_eager_frames(fast, cuda_device, counters):
    chunk, wh = 1024, (64, 56)  # 3584 pixels: four chunks, the last one padded
    n_chunks = 4
    params = model(CARD, 0, cuda_device).render_params()
    rcfg = RenderConfig.from_hparams(CARD)
    renderer = trender.make_pose_renderer(rcfg, chunk=chunk, fast=fast)
    frames = [(frame_inputs(wh, 1, chunk, cuda_device), 2), (frame_inputs(wh, 3, chunk, cuda_device), 0)]
    wants = []
    with torch.no_grad():
        for f, ((K, pose, px, py, near_far), a_idx) in enumerate(frames):
            before = launch_counts()
            want = eager_frame(params, rcfg, fast, K, pose, px, py, near_far, a_idx, chunk)
            eager_launches = [b - a for a, b in zip(before, launch_counts())]
            before = launch_counts()
            got = renderer(params, K, pose, px, py, near_far, a_idx)
            torch.cuda.synchronize()
            graph_launches = [b - a for a, b in zip(before, launch_counts())]
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"frame {f}"
            assert graph_launches == eager_launches
            assert eager_launches == [2 * n_chunks, n_chunks if fast is not None else 0]
            assert (counters.graph_captures, counters.graph_replays) == (1, (f + 1) * n_chunks - 1)
            wants.append(want)
        got = renderer(params, *frames[0][0], frames[0][1])  # the first frame again, after the second's inputs
    assert torch.equal(got[0], wants[0][0]) and torch.equal(got[1], wants[0][1])
    assert not torch.equal(wants[0][0], wants[1][0])


@pytest.mark.cuda
def test_graph_follows_weights_in_place_and_new_params(cuda_device, counters):
    chunk, wh = 1024, (64, 32)
    rcfg = RenderConfig.from_hparams(CARD)
    m = model(CARD, 0, cuda_device)
    params = m.render_params()
    renderer = trender.make_pose_renderer(rcfg, chunk=chunk)
    K, pose, px, py, near_far = frame_inputs(wh, 2, chunk, cuda_device)
    with torch.no_grad():
        first = renderer(params, K, pose, px, py, near_far, 1)
        m.load_state_dict(model(CARD, 1, cuda_device).state_dict())  # in place: the graph reads the new values
        got = renderer(params, K, pose, px, py, near_far, 1)
        want = eager_frame(params, rcfg, None, K, pose, px, py, near_far, 1, chunk)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert not torch.equal(got[0], first[0])
        assert (counters.graph_captures, counters.graph_replays) == (1, 3)
        other = model(CARD, 2, cuda_device).render_params()  # other tensors: a capture of its own
        got = renderer(other, K, pose, px, py, near_far, 1)
        want = eager_frame(other, rcfg, None, K, pose, px, py, near_far, 1, chunk)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert (counters.graph_captures, counters.graph_replays) == (2, 4)
