"""The serving slice of upnerf_torch end to end against the JAX package.

A tiny model is seeded in the reference checkpoint layout by the port
(`init_reference_ckpt`) and read by both packages (the JAX side through
upnerf.utils.ref_ckpt.convert_state_dict). Then:
- `render_image` of the port and of upnerf.evaluate.render render an 8x16
  image in chunks of 64 rays (JAX takes its XLA path on the CPU);
- `render_rays` with pre-drawn uniforms and a partial c2f anneal;
- the port's render_video CLI on --device cpu, against the JAX render of the
  same orbit pose.
float32 on both sides; 1e-4 absolute on rgb, 1e-3 relative on depth (the
fine samples move with the coarse weights).
"""

import importlib.util
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.config import get_from_path
from upnerf.evaluate import render as jrender
from upnerf.geometry import se3 as jse3
from upnerf.models import NeRFConfig as JNeRFConfig
from upnerf.render import RenderConfig as JRenderConfig
from upnerf.render import render_rays as jrender_rays
from upnerf.utils.ref_ckpt import convert_state_dict
from upnerf_torch.cli import render_video
from upnerf_torch.evaluate import render as trender
from upnerf_torch.render.render_rays import RenderConfig, render_rays
from upnerf_torch.utils import weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = {
    "nerf.D": 4, "nerf.W": 32, "nerf.skips": (2,), "nerf.N_emb_xyz": 4, "nerf.N_emb_dir": 2,
    "nerf.feat_dim": 16, "nerf.appearance_dim": 8, "nerf.candidate_dim": 4, "pose.c2f": (0.1, 0.5),
    "nerf.N_samples": 16, "nerf.N_importance": 16, "nerf.near": 0.1, "nerf.far": 5.0,
    "nerf.use_disp": False, "nerf.perturb": 1.0, "val.chunk_size": 64, "tpu.matmul_precision": "float32",
    "t_net.transient_dim": 8, "t_net.feat_dim": 16, "t_net.beta_min": 0.1,
}
WH, FOCAL, CHUNK = (16, 8), 12.0, 64
K = np.array([[FOCAL, 0, WH[0] / 2], [0, FOCAL, WH[1] / 2], [0, 0, 1]], np.float32)
NEAR_FAR = np.array([0.1, 5.0], np.float32)
RGB_ATOL, DEPTH_RTOL = 1e-4, 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(ckpt path, port params, se3 table, JAX params) of one seeded model
    with a non-zero pose refinement for image 1."""
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.ckpt")
    weights.init_reference_ckpt(path, HP, n_images=3, seed=3)
    ckpt = torch.load(path, weights_only=False)
    ckpt["state_dict"]["se3_refine.weight"][1] = torch.tensor([0.05, -0.1, 0.02, 0.1, 0.0, -0.2])
    torch.save(ckpt, path)
    sd, _, _ = weights.load_reference_ckpt(path)
    from upnerf_torch.models.nerf import NeRFConfig

    params, se3 = weights.render_params(sd, NeRFConfig.from_hparams(HP), "cpu")
    jparams, jpose, _ = convert_state_dict(sd)
    jparams = jax.tree.map(jnp.asarray, {k: jparams[k] for k in ("nerf_coarse", "nerf_fine", "embeddings")})
    return path, params, se3, jparams, np.asarray(jpose["se3"])


def jax_configs():
    return JNeRFConfig.from_hparams(HP), JRenderConfig.from_hparams(HP)._replace(perturb=0.0)


def orbit_pose(se3_row, i, n=2):
    anchor = jse3.compose([jse3.se3_to_SE3(jnp.asarray(se3_row)), jnp.eye(3, 4)])
    return np.asarray(jse3.get_novel_view_poses(anchor, N=n)[i])


def test_brandenburg_gate_hparams_match_the_config():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    hp = get_from_path(os.path.join(REPO, "configs", "brandenburg_gate.yaml"))
    for k, v in chip_smoke.BRANDENBURG_GATE.items():
        assert hp[k] == v, k


def test_render_image_matches_jax(model):
    _, params, se3, jparams, jse3_table = model
    pose = orbit_pose(jse3_table[1], 1)
    jcfg, jrcfg = jax_configs()
    want_rgb, want_depth = jrender.render_image(
        jrender.make_pose_renderer(jcfg, jrcfg, chunk=CHUNK), jparams, K, pose, WH, NEAR_FAR, a_idx=1, chunk=CHUNK
    )
    rcfg = RenderConfig.from_hparams(HP)._replace(perturb=0.0)
    rgb, depth = trender.render_image(trender.make_pose_renderer(rcfg, chunk=CHUNK), params, K, pose, WH, NEAR_FAR,
                                      a_idx=1, chunk=CHUNK)
    assert rgb.shape == (WH[1], WH[0], 3) and depth.shape == (WH[1], WH[0])
    np.testing.assert_allclose(rgb, want_rgb, rtol=0, atol=RGB_ATOL)
    np.testing.assert_allclose(depth, want_depth, rtol=DEPTH_RTOL)


def test_render_rays_with_uniforms_matches_jax(model):
    _, params, _, jparams, _ = model
    rng = np.random.RandomState(9)
    R = 16
    d = rng.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([rng.randn(R, 3).astype(np.float32) * 0.2, d, np.tile(NEAR_FAR, (R, 1))], -1)
    idx = np.array([0, 1, 2, 1] * 4)
    noise = {"coarse": rng.rand(R, 16).astype(np.float32), "fine": rng.rand(R, 16).astype(np.float32)}
    jcfg, jrcfg = jax_configs()
    want = jrender_rays(
        jparams, jrcfg._replace(perturb=1.0), jcfg, jnp.asarray(rays), jnp.asarray(idx), key=None, phase=2,
        sched_mult=jnp.asarray(1.0), progress=jnp.asarray(0.3), encode_candidate=False,
        noise={k: jnp.asarray(v) for k, v in noise.items()},
    )
    got = render_rays(
        params, RenderConfig.from_hparams(HP), torch.from_numpy(rays), torch.from_numpy(idx), progress=0.3,
        noise={k: torch.from_numpy(v) for k, v in noise.items()},
    )
    assert set(got) == set(want)
    for k in got:
        if "depth" in k:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=DEPTH_RTOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=RGB_ATOL, err_msg=k)


def read_png(path):
    """(H, W, 3) uint8 of an 8-bit RGB PNG written with filter 0 rows."""
    data = open(path, "rb").read()
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    i, idat = 8, b""
    while i < len(data):
        n = int.from_bytes(data[i : i + 4], "big")
        if data[i + 4 : i + 8] == b"IDAT":
            idat += data[i + 8 : i + 8 + n]
        i += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_render_video_cli_on_cpu_matches_jax(model, tmp_path):
    path, _, _, jparams, jse3_table = model
    out = render_video.main([
        "--ckpt", path, "--out", str(tmp_path / "video"), "--frames", "2", "--anchor", "1",
        "--wh", str(WH[0]), str(WH[1]), "--focal", str(FOCAL), "--device", "cpu",
    ])
    assert [os.path.basename(p) for p in out["frames"]] == ["frame_000.png", "frame_001.png"]
    jcfg, jrcfg = jax_configs()
    renderer = jrender.make_pose_renderer(jcfg, jrcfg, chunk=CHUNK)
    for i, (png, npy) in enumerate(zip(out["frames"], out["depths"])):
        want_rgb, want_depth = jrender.render_image(
            renderer, jparams, K, orbit_pose(jse3_table[1], i), WH, NEAR_FAR, a_idx=1, chunk=CHUNK
        )
        np.testing.assert_allclose(np.load(npy), want_depth, rtol=DEPTH_RTOL)
        want_u8 = (np.clip(want_rgb, 0, 1) * 255).astype(np.int16)
        assert np.abs(read_png(png).astype(np.int16) - want_u8).max() <= 1


def test_render_video_cli_refuses_cuda_without_a_card(model, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_video.main(["--ckpt", model[0], "--out", str(tmp_path), "--frames", "1", "--wh", "16", "8",
                           "--focal", "12", "--device", "cuda"])
