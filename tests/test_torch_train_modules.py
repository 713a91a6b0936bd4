"""The train slice's small modules of upnerf_torch against the JAX package,
float32 unless stated:
- ops.interp.bilinear_gather on a bf16 feature stack, gathered in f32,
  including the bottom/right edge (the edge fix): 1e-6;
- models.transient.TransientNet against apply_transient with the same
  parameters (moved by the weight bridge): 1e-5;
- NeRFField.forward in phases 0 and 1 (candidate branch, feature output)
  against apply_nerf: 1e-5;
- train.schedules against upnerf.train.schedules (both in float32): exact
  phase, 1e-7 on sched_mult;
- the feature coarse-to-fine option (off by default): blur_feat_stack and
  the blended gather_feats against the JAX package's: 1e-6;
- render_rays in phases 0 and 1 (the mixture CDF for the fine samples) with
  pre-drawn uniforms against upnerf.render.render_rays: 1e-5, depths 1e-4
  relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.models import NeRFConfig as JNeRFConfig
from upnerf.models import TransientConfig as JTransientConfig
from upnerf.models import apply_nerf, apply_transient
from upnerf.ops.interp import bilinear_gather as jgather
from upnerf.render import RenderConfig as JRenderConfig
from upnerf.render import render_rays as jrender_rays
from upnerf.train import schedules as jsched
from upnerf.train.state import blur_feat_stack as jblur
from upnerf.train.state import init_params, init_pose_params
from upnerf.train.state import make_scene_constants as jmake_scene
from upnerf.train.step import gather_feats as jgather_feats
from upnerf_torch.models.nerf import NeRFConfig
from upnerf_torch.models.transient import TransientConfig
from upnerf_torch.ops.interp import bilinear_gather
from upnerf_torch.render.render_rays import RenderConfig, render_rays
from upnerf_torch.train import make_scene_constants, schedules
from upnerf_torch.train.state import blur_feat_stack
from upnerf_torch.train.step import gather_feats
from upnerf_torch.utils import weights

NERF = dict(D=4, W=32, skips=(2,), feat_dim=16, xyz_L=4, dir_L=2, appearance_dim=8, candidate_dim=4, c2f=(0.1, 0.5))
T_NET = dict(beta_min=0.1, transient_dim=8, feat_dim=16)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX parameters and the port's modules holding them."""
    jcfg = JNeRFConfig(**NERF, fused_trunk=False)
    params = init_params(jax.random.PRNGKey(5), jcfg, JTransientConfig(**T_NET), 3)
    pose = init_pose_params(3)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    model, _ = weights.train_modules_from_jax(to_np(params), to_np(pose), NeRFConfig(**NERF), TransientConfig(**T_NET),
                                              3)
    return jcfg, params, model


def test_bilinear_gather_matches_jax_on_bf16_stack():
    rng = np.random.RandomState(0)
    maps = rng.randn(3, 5, 7, 6).astype(np.float32)
    idx = np.array([0, 1, 2, 2, 1, 0])
    u = np.array([0.0, 0.3, 1.0, 0.77, 1.0, 0.5], np.float32)  # rows; 1.0 is the bottom edge
    v = np.array([0.0, 0.6, 1.0, 0.12, 0.4, 1.0], np.float32)  # columns; 1.0 is the right edge
    jmaps = jnp.asarray(maps, jnp.bfloat16)
    want = np.asarray(jgather(jmaps, jnp.asarray(idx), jnp.asarray(u), jnp.asarray(v)))
    tmaps = torch.from_numpy(maps).to(torch.bfloat16)
    got = bilinear_gather(tmaps, torch.from_numpy(idx), torch.from_numpy(u), torch.from_numpy(v))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the bottom-right texel itself at (1, 1)
    np.testing.assert_allclose(got[2].numpy(), tmaps[2, -1, -1].float().numpy(), rtol=0, atol=1e-6)


def test_transient_net_matches_apply_transient(models):
    _, params, model = models
    rng = np.random.RandomState(1)
    feat = rng.randn(10, 16).astype(np.float32)
    idx = rng.randint(0, 3, 10)
    want = apply_transient(params["transient"], JTransientConfig(**T_NET), jnp.asarray(feat), jnp.asarray(idx),
                           precision="float32")
    with torch.no_grad():
        got = model.transient_net(torch.from_numpy(feat), torch.from_numpy(idx))
    for k in ("alpha", "rgb", "beta"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("phase", [0, 1])
def test_field_phases_0_1_match_apply_nerf(models, phase):
    jcfg, params, model = models
    rng = np.random.RandomState(2 + phase)
    xyz = rng.randn(4, 6, 3).astype(np.float32)
    dirs = rng.randn(4, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    a = rng.randn(4, 8).astype(np.float32)
    c = rng.randn(4, 4).astype(np.float32)
    want = apply_nerf(
        params["nerf_coarse"], jcfg,
        {"input_xyz": jnp.asarray(xyz), "input_dir": jnp.asarray(dirs), "input_a": jnp.asarray(a),
         "input_c": jnp.asarray(c)},
        phase=phase, sched_mult=jnp.asarray(0.5), progress=jnp.asarray(0.3), precision="float32",
    )
    with torch.no_grad():
        got = model.nerf_coarse(torch.from_numpy(xyz), torch.from_numpy(dirs), torch.from_numpy(a), progress=0.3,
                                phase=phase, c_emb=torch.from_numpy(c))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("progress", [0.0, 0.05, 0.1, 0.2, 0.3, 0.45, 0.5, 0.6, 1.0])
def test_schedules_match_jax(progress):
    sched = (0.1, 0.5)
    want = float(jsched.schedule_mult(jnp.asarray(progress, jnp.float32), sched))
    assert schedules.schedule_mult(progress, sched) == pytest.approx(want, abs=1e-7)
    assert schedules.schedule_phase(progress, sched) == jsched.schedule_phase(progress, sched)
    step, max_steps = 37, 300
    assert schedules.pe_progress(step, max_steps) == float(jnp.asarray(step, jnp.int32).astype(jnp.float32) / max_steps)


@pytest.mark.parametrize("phase", [0, 1])
def test_render_rays_phases_0_1_match_jax(models, phase):
    jcfg, params, model = models
    rng = np.random.RandomState(9)
    R = 8
    d = rng.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([rng.randn(R, 3).astype(np.float32) * 0.2, d, np.tile([[0.1, 5.0]], (R, 1))], -1)
    rays = rays.astype(np.float32)
    idx = np.array([0, 1, 2, 1] * 2)
    noise = {"coarse": rng.uniform(0.05, 0.95, (R, 16)).astype(np.float32),
             "fine": rng.uniform(0.05, 0.95, (R, 16)).astype(np.float32)}
    jr = JRenderConfig(N_samples=16, N_importance=16, perturb=1.0, precision="float32")
    jparams = {k: params[k] for k in ("nerf_coarse", "nerf_fine", "embeddings")}
    want = jrender_rays(jparams, jr, jcfg, jnp.asarray(rays), jnp.asarray(idx), key=None, phase=phase,
                        sched_mult=jnp.asarray(0.5, jnp.float32), progress=jnp.asarray(0.3, jnp.float32),
                        noise={k: jnp.asarray(v) for k, v in noise.items()})
    with torch.no_grad():
        got = render_rays(model.render_params(), RenderConfig(N_samples=16, N_importance=16, perturb=1.0),
                          torch.from_numpy(rays), torch.from_numpy(idx), phase=phase, sched_mult=0.5, progress=0.3,
                          noise={k: torch.from_numpy(v) for k, v in noise.items()})
    assert set(got) == set(want)
    for k in want:
        if "depth" in k:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)


def test_feature_coarse_to_fine_matches_jax():
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 6, 5, 4).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    np.testing.assert_allclose(blur_feat_stack(feats, 1.2), jblur(feats, 1.2), rtol=0, atol=1e-6)
    Ks = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (2, 1, 1))
    near_far = np.tile([[0.1, 5.0]], (2, 1)).astype(np.float32)
    wh = np.array([[9, 7], [9, 7]])
    jscene = jmake_scene(Ks, poses, near_far, wh, feats, feat_dtype=jnp.float32, feat_pyramid_sigma=1.2)
    tscene = make_scene_constants(Ks, poses, near_far, wh, feats, "cpu", feat_dtype=torch.float32,
                                  feat_pyramid_sigma=1.2)
    px = np.array([0, 3, 8, 5], np.float32)
    py = np.array([0, 6, 2, 4], np.float32)
    idx = np.array([0, 1, 1, 0])
    for progress in (0.05, 0.3, 0.9):
        want = jgather_feats(jscene, {"px": jnp.asarray(px), "py": jnp.asarray(py), "img_idx": jnp.asarray(idx)},
                             (0.1, 0.5), jnp.asarray(progress, jnp.float32))
        got = gather_feats(tscene, {"px": torch.from_numpy(px), "py": torch.from_numpy(py),
                                    "img_idx": torch.from_numpy(idx)}, (0.1, 0.5), progress)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
