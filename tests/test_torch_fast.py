"""The fast serving render of upnerf_torch against the JAX package: the trunk
kernel's plain version, the sigma-only field, interval tightening and the
`render_video --fast` CLI.

- `fused_trunk_plain` against `upnerf.ops.pallas_mlp.fused_trunk` in the Pallas
  interpreter: float32 1e-5 absolute; bfloat16 1e-4 of the output's max (both
  round h and W to bf16 before each product and sum in f32, in another order,
  so a rare rounding flip moves an activation by one bf16 ulp);
- `NeRFField.forward(sigma_only=True)` and `tighten_rays` against JAX's
  `apply_nerf(sigma_only=True)` / `tighten_rays` with `fused_trunk=True`
  (interpreter): sigma 1e-5, tightened near/far 1e-5;
- `tighten_from_weights` against JAX's on rays with no mass, all mass in the
  last bin and eps = 0: exact up to 1e-6;
- a fast render of an 8x16 image against `upnerf.evaluate.render`'s with
  the same FastRenderConfig (JAX's XLA path): rgb 1e-4, depth 1e-3 relative;
- the render_video CLI with --fast on the CPU.
At D=4, W=32 (the tiny model of tests/test_torch_render_slice.py), float32
unless stated.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.evaluate import render as jrender
from upnerf.models import NeRFConfig as JNeRFConfig
from upnerf.models.nerf import apply_nerf
from upnerf.ops import pallas_mlp
from upnerf.render import FastRenderConfig as JFast
from upnerf.render import RenderConfig as JRenderConfig
from upnerf.render import fast as jfast
from upnerf.utils.ref_ckpt import convert_state_dict
from upnerf_torch.cli import render_video
from upnerf_torch.evaluate import render as trender
from upnerf_torch.models.nerf import NeRFConfig
from upnerf_torch.ops import mlp
from upnerf_torch.render import fast
from upnerf_torch.render.render_rays import RenderConfig
from upnerf_torch.utils import weights

HP = {
    "nerf.D": 4, "nerf.W": 32, "nerf.skips": (2,), "nerf.N_emb_xyz": 4, "nerf.N_emb_dir": 2,
    "nerf.feat_dim": 16, "nerf.appearance_dim": 8, "nerf.candidate_dim": 4, "pose.c2f": (0.1, 0.5),
    "nerf.N_samples": 16, "nerf.N_importance": 16, "nerf.near": 0.1, "nerf.far": 5.0,
    "nerf.use_disp": False, "nerf.perturb": 1.0, "val.chunk_size": 64, "tpu.matmul_precision": "float32",
    "t_net.transient_dim": 8, "t_net.feat_dim": 16, "t_net.beta_min": 0.1,
}
PROBE = JFast(n_probe=16, eps=0.05, pad=1, N_samples=8, N_importance=8)  # clips enough mass to tighten
WH, FOCAL, CHUNK = (16, 8), 12.0, 64


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(ckpt path, port params, JAX params) of one seeded tiny model."""
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.ckpt")
    weights.init_reference_ckpt(path, HP, n_images=3, seed=5)
    sd, _, _ = weights.load_reference_ckpt(path)
    params, _ = weights.render_params(sd, NeRFConfig.from_hparams(HP), "cpu")
    jparams, _, _ = convert_state_dict(sd)
    jparams = jax.tree.map(jnp.asarray, {k: jparams[k] for k in ("nerf_coarse", "nerf_fine", "embeddings")})
    return path, params, jparams


def port_fast(cfg: JFast) -> fast.FastRenderConfig:
    return fast.FastRenderConfig(**cfg._asdict())


def rays(n=24, seed=0):
    """(n, 8) rays from around (0, 0, 3) towards the origin, near 0.1, far 5."""
    rng = np.random.RandomState(seed)
    o = np.array([0.0, 0.0, 3.0]) + rng.randn(n, 3) * 0.1
    d = -o + rng.randn(n, 3) * 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.tile([[0.1, 5.0]], (n, 1))], -1).astype(np.float32)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_trunk_plain_matches_pallas_kernel_interpret(precision, monkeypatch):
    monkeypatch.setattr(pallas_mlp, "INTERPRET", True)
    rng = np.random.RandomState(1)
    in0, W, D, skips, N = 27, 32, 4, (2,), 256
    trunk = [((rng.randn(in0 if i == 0 else (W + in0 if i in skips else W), W) * 0.3).astype(np.float32),
              (rng.randn(W) * 0.1).astype(np.float32)) for i in range(D)]
    x = rng.randn(N, in0).astype(np.float32)
    want = np.asarray(pallas_mlp.fused_trunk(jnp.asarray(x), tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in trunk),
                                             skips, 128, precision))
    got = mlp.fused_trunk_plain(torch.from_numpy(x), [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in trunk],
                                skips, precision).numpy()
    atol = 1e-5 if precision == "float32" else 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if precision == "bfloat16":  # another computation than f32 at this size
        f32 = mlp.fused_trunk_plain(torch.from_numpy(x), [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in trunk],
                                    skips, "float32").numpy()
        assert np.abs(got - f32).max() > 1e-5


def test_trunk_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    x = torch.randn(10, 27)
    trunk = [(torch.randn(27, 32), torch.randn(32)), (torch.randn(32, 32), torch.randn(32))]
    before = mlp.launches
    assert torch.equal(mlp.fused_trunk(x, trunk, ()), mlp.fused_trunk_plain(x, trunk, ()))
    assert mlp.launches == before
    with pytest.raises(ValueError, match="no trunk kernel"):
        mlp.fused_trunk(x.to("meta"), trunk, ())


def test_sigma_only_field_matches_jax_fused_trunk(model, monkeypatch):
    monkeypatch.setattr(pallas_mlp, "INTERPRET", True)
    _, params, jparams = model
    jcfg = JNeRFConfig.from_hparams(HP)._replace(fused_trunk=True)
    xyz = (np.random.RandomState(2).randn(24, 16, 3) * 0.7).astype(np.float32)
    want = apply_nerf(jparams["nerf_coarse"], jcfg, {"input_xyz": jnp.asarray(xyz), "input_dir": jnp.zeros((24, 3))},
                      phase=2, sched_mult=jnp.asarray(1.0), progress=jnp.asarray(0.3), encode_candidate=False,
                      sigma_only=True, precision="float32")["s_sigma"]
    with torch.no_grad():
        got = params["nerf_coarse"](torch.from_numpy(xyz), None, None, progress=0.3, sigma_only=True)
    assert set(got) == {"s_sigma"}
    np.testing.assert_allclose(got["s_sigma"].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_tighten_from_weights_matches_jax():
    rng = np.random.RandomState(3)
    R, P = 6, 16
    z = np.sort(rng.uniform(0.1, 5.0, (R, P)), -1).astype(np.float32)
    w = rng.uniform(0, 0.2, (R, P)).astype(np.float32)
    w[1] = 0.0  # no mass: keeps [near, far]
    w[2] = 0.0
    w[2, -1] = 0.9  # all mass in the last bin
    near, far = np.full((R, 1), 0.1, np.float32), np.full((R, 1), 5.0, np.float32)
    for eps, pad in ((1e-5, 3), (0.0, 0), (0.1, 1)):
        want = jfast.tighten_from_weights(jnp.asarray(z), jnp.asarray(w), jnp.asarray(near), jnp.asarray(far), eps, pad,
                                          1e-2)
        got = fast.tighten_from_weights(torch.from_numpy(z), torch.from_numpy(w), torch.from_numpy(near),
                                        torch.from_numpy(far), eps, pad, 1e-2)
        for g, v in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(v), rtol=0, atol=1e-6)


def test_tighten_rays_matches_jax_fused_trunk(model, monkeypatch):
    monkeypatch.setattr(pallas_mlp, "INTERPRET", True)
    _, params, jparams = model
    r = rays()
    jcfg = JNeRFConfig.from_hparams(HP)._replace(fused_trunk=True)
    want = jfast.tighten_rays(jparams["nerf_coarse"], jcfg, JRenderConfig.from_hparams(HP), PROBE, jnp.asarray(r),
                              jnp.asarray(1.0))
    with torch.no_grad():
        got = fast.tighten_rays(params["nerf_coarse"], RenderConfig.from_hparams(HP), port_fast(PROBE),
                                torch.from_numpy(r), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert (got[:, 7] - got[:, 6]).min() > 0 and not np.allclose(got[:, 6:].numpy(), r[:, 6:])


def test_fast_render_image_matches_jax(model):
    _, params, jparams = model
    K = np.array([[FOCAL, 0, WH[0] / 2], [0, FOCAL, WH[1] / 2], [0, 0, 1]], np.float32)
    pose = np.concatenate([np.eye(3), [[0.1], [0.0], [3.0]]], 1).astype(np.float32)
    near_far = np.array([0.1, 5.0], np.float32)
    jrenderer = jrender.make_pose_renderer(JNeRFConfig.from_hparams(HP), JRenderConfig.from_hparams(HP)._replace(
        perturb=0.0), chunk=CHUNK, fast=PROBE)
    want_rgb, want_depth = jrender.render_image(jrenderer, jparams, K, pose, WH, near_far, 1, chunk=CHUNK)
    renderer = trender.make_pose_renderer(RenderConfig.from_hparams(HP)._replace(perturb=0.0), chunk=CHUNK,
                                          fast=port_fast(PROBE))
    rgb, depth = trender.render_image(renderer, params, K, pose, WH, near_far, 1, chunk=CHUNK, device="cpu")
    np.testing.assert_allclose(rgb, want_rgb, rtol=0, atol=1e-4)
    np.testing.assert_allclose(depth, want_depth, rtol=1e-3, atol=0)
    full = trender.make_pose_renderer(RenderConfig.from_hparams(HP)._replace(perturb=0.0), chunk=CHUNK)
    _, full_depth = trender.render_image(full, params, K, pose, WH, near_far, 1, chunk=CHUNK, device="cpu")
    assert not np.allclose(depth, full_depth)  # the reduced budget renders another image


def test_render_video_fast_cli_on_cpu(model, tmp_path):
    path, params, _ = model
    out = tmp_path / "video"
    argv = ["--ckpt", path, "--out", str(out), "--frames", "2", "--wh", str(WH[0]), str(WH[1]), "--focal",
            str(FOCAL), "--device", "cpu", "--fast", "--fast_probe", "16", "--fast_samples", "8",
            "--fast_importance", "8"]
    before = mlp.launches
    written = render_video.main(argv)
    assert mlp.launches == before
    assert [os.path.basename(p) for p in written["frames"]] == ["frame_000.png", "frame_001.png"]
    depth = np.load(written["depths"][0])
    assert depth.shape == WH[::-1] and np.isfinite(depth).all() and 0 < depth.min() and depth.max() <= 5.0
