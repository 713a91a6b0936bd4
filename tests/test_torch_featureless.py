"""The feature-less field (`nerf.feat_dim: 0`, the JAX package's RGB
surrogate) and the trunk kernel's backward, against the JAX package.

At D=4, W=32, skip 2, L=4 (in0 = 27), float32 unless stated:
- `ops.mlp.fused_trunk_bwd_plain` (the trunk kernel's plain backward) against
  `jax.vjp` of `upnerf.ops.pallas_mlp.fused_trunk` in the Pallas interpreter,
  64 rows: f32 1e-5 of each leaf's max |g|; bf16 1e-4 (both round every
  product's operands to bf16 and sum in f32, in another order: an f32 sum on
  the other side of a bf16 rounding boundary moves one operand by one bf16
  ulp). The autograd.Function `FusedTrunk` on CPU tensors returns exactly the
  plain backward;
- `NeRFField.forward` without features against `apply_nerf` (the JAX field
  with its trunk through the Pallas trunk kernel in the interpreter) in
  phases 0, 1 and 2: every output within 1e-5 of its max;
- `compute_loss` with the c_rgb terms against JAX's: 1e-6 relative;
- one teacher-forced train step per phase against
  `upnerf.train.step._loss_and_metrics` (the same parameters, batch and
  uniforms; JAX on its XLA trunk, the port through `FusedTrunk` and the
  plain backward): loss terms 1e-5 relative, gradients 1e-4 of each leaf's
  max |g| (1e-3 for the one-element sigma biases, as in
  tests/test_torch_train_step.py);
- the candidate-free phase-0 render raises in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.models import NeRFConfig as JNeRFConfig
from upnerf.models import TransientConfig as JTransientConfig
from upnerf.models.nerf import apply_nerf, init_nerf
from upnerf.ops import pallas_mlp
from upnerf.render import RenderConfig as JRenderConfig
from upnerf.render import render_rays as jrender_rays
from upnerf.train import LossConfig as JLossConfig
from upnerf.train import StepConfig as JStepConfig
from upnerf.train import init_params as jinit_params
from upnerf.train.losses import compute_loss as jcompute_loss
from upnerf.train.step import _loss_and_metrics as jloss_and_metrics
from upnerf.train.step import gather_batch as jgather_batch
from upnerf_torch.models.nerf import NeRFConfig, NeRFField
from upnerf_torch.models.transient import TransientConfig
from upnerf_torch.ops import mlp
from upnerf_torch.render.render_rays import RenderConfig, render_rays
from upnerf_torch.train import (
    LossConfig,
    StepConfig,
    make_optimizer,
    make_ray_store,
    make_scene_constants,
    make_train_state,
    pe_progress,
    schedule_mult,
)
from upnerf_torch.train import step as tstep
from upnerf_torch.train.losses import compute_loss
from upnerf_torch.utils import weights

from helpers import tiny_scene

D, W, SKIPS, L = 4, 32, (2,), 4
IN0 = 3 + 6 * L
NERF = dict(D=D, W=W, skips=SKIPS, encode_feat=False, feat_dim=0, xyz_L=L, dir_L=2, appearance_dim=8, candidate_dim=4,
            c2f=(0.1, 0.5))
T_NET = dict(beta_min=0.1, transient_dim=8, feat_dim=16)
N_IMG, BATCH, MAX_STEPS = 3, 16, 100
STEP_OF_PHASE = {0: 5, 1: 30, 2: 60}
PHASE_SCHED = {0: 0.0, 1: 0.5, 2: 1.0}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    b = np.asarray(b, np.float32)
    return float(np.abs(np.asarray(a, np.float32).reshape(b.shape) - b).max() / max(np.abs(b).max(), 1e-30))


def trunk_world(seed=0, n=64):
    rng = np.random.RandomState(seed)
    trunk = []
    for i in range(D):
        fan = IN0 if i == 0 else (W + IN0 if i in SKIPS else W)
        b = fan**-0.5
        trunk.append((rng.uniform(-b, b, (fan, W)).astype(np.float32), rng.uniform(-b, b, W).astype(np.float32)))
    return trunk, rng.randn(n, IN0).astype(np.float32), rng.randn(n, W).astype(np.float32)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_trunk_plain_backward_matches_pallas_vjp(monkeypatch, precision):
    monkeypatch.setattr(pallas_mlp, "INTERPRET", True)
    trunk, x, g = trunk_world()
    jt = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in trunk)
    jout, vjp = jax.vjp(lambda x_, p: pallas_mlp.fused_trunk(x_, p, SKIPS, 32, precision), jnp.asarray(x), jt)
    jdx, jdp = vjp(jnp.asarray(g))
    T = torch.from_numpy
    tt = [(T(w), T(b)) for w, b in trunk]
    assert rel(mlp.fused_trunk_plain(T(x), tt, SKIPS, precision).numpy(), jout) <= 1e-5
    dx, dtrunk = mlp.fused_trunk_bwd_plain(T(x), tt, SKIPS, precision, T(g))
    tol = 1e-5 if precision == "float32" else 1e-4
    assert rel(dx.numpy(), jdx) <= tol
    for i in range(D):
        assert rel(dtrunk[i][0].numpy(), jdp[i][0]) <= tol, i
        assert rel(dtrunk[i][1].numpy(), jdp[i][1]) <= tol, i


def test_trunk_function_equals_plain_backward():
    trunk, x, g = trunk_world(1)
    T = torch.from_numpy
    xt = T(x).requires_grad_()
    tt = [(T(w).requires_grad_(), T(b).requires_grad_()) for w, b in trunk]
    before = (mlp.launches, mlp.bwd_launches)
    mlp.fused_trunk(xt, tt, SKIPS, "bfloat16").backward(T(g))
    assert (mlp.launches, mlp.bwd_launches) == before  # CPU tensors: the plain versions
    dx, dtrunk = mlp.fused_trunk_bwd_plain(T(x), [(T(w), T(b)) for w, b in trunk], SKIPS, "bfloat16", T(g))
    assert torch.equal(xt.grad, dx)
    assert all(torch.equal(tt[i][0].grad, dtrunk[i][0]) and torch.equal(tt[i][1].grad, dtrunk[i][1]) for i in range(D))


def port_field(jparams, cfg: NeRFConfig) -> NeRFField:
    pose = {"se3": np.zeros((1, 6), np.float32), "depth_scale": np.zeros((1, 2), np.float32)}
    sd = weights.state_dict_from_jax({"nerf_coarse": jax.tree.map(np.asarray, jparams)}, pose, 0.0)
    field = NeRFField(cfg)
    field.load_state_dict({k[len("nerf_coarse."):]: v for k, v in sd.items() if k.startswith("nerf_coarse.")})
    return field


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_featureless_field_matches_apply_nerf(monkeypatch, phase):
    monkeypatch.setattr(pallas_mlp, "INTERPRET", True)
    jcfg = JNeRFConfig(**NERF, fused_trunk=True)
    jp = init_nerf(jax.random.PRNGKey(phase), jcfg)
    field = port_field(jp, NeRFConfig(**NERF))
    rng = np.random.RandomState(10 + phase)
    R, S = 4, 32
    xyz = (rng.randn(R, S, 3) * 0.5).astype(np.float32)
    dirs = rng.randn(R, 3).astype(np.float32)
    a = rng.randn(R, 8).astype(np.float32)
    c = rng.randn(R, 4).astype(np.float32)
    progress = 0.3
    want = apply_nerf(jp, jcfg, {"input_xyz": jnp.asarray(xyz), "input_dir": jnp.asarray(dirs),
                                 "input_a": jnp.asarray(a), "input_c": jnp.asarray(c)},
                      phase=phase, sched_mult=jnp.float32(PHASE_SCHED[phase]), progress=jnp.float32(progress),
                      precision="float32")
    T = torch.from_numpy
    with torch.no_grad():
        got = field(T(xyz), T(dirs), T(a), progress=progress, precision="float32", phase=phase, c_emb=T(c))
    assert set(got) == set(want) == ({"s_sigma", "s_rgb"} | ({"c_sigma", "c_rgb"} if phase < 2 else set()))
    for k in want:
        assert rel(got[k].numpy(), want[k]) <= 1e-5, k


def loss_results(rng, R=16, fine=True):
    res = {}
    for typ in ("coarse", "fine") if fine else ("coarse",):
        res[f"s_depth_{typ}"] = rng.uniform(0.5, 4, R)
        res[f"t_weight_{typ}"] = rng.uniform(0, 1, R)
        res[f"c_rgb_{typ}"] = rng.uniform(0, 1, (R, 3))
        res[f"s_rgb_{typ}"] = rng.uniform(0, 1, (R, 3))
    res["t_beta"] = rng.uniform(0.1, 1, R)
    res["t_alpha"] = rng.uniform(0, 1, R)
    return {k: v.astype(np.float32) for k, v in res.items()}


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_featureless_loss_matches_jax(phase):
    rng = np.random.RandomState(phase)
    res = loss_results(rng)
    rgb = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 4, 16).astype(np.float32)
    sched = PHASE_SCHED[phase] if phase != 1 else 0.4
    want = jcompute_loss(JLossConfig(encode_feat=False), {k: jnp.asarray(v) for k, v in res.items()},
                         jnp.asarray(rgb), None, jnp.asarray(depth), jnp.float32(sched), phase)
    got = compute_loss(LossConfig(encode_feat=False), {k: torch.from_numpy(v) for k, v in res.items()},
                       torch.from_numpy(rgb), None, torch.from_numpy(depth), sched, phase)
    assert list(got) == list(want)
    assert ("l_c_rgb_c" in got) == (phase < 2) and "l_feat_c" not in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-9, err_msg=k)


# ---------------------------------------------------------------------------
# one teacher-forced train step per phase


def jax_cfg():
    return JStepConfig(
        nerf=JNeRFConfig(**NERF, fused_trunk=False), transient=JTransientConfig(**T_NET),
        render=JRenderConfig(N_samples=8, N_importance=8, perturb=1.0, encode_feat=False, precision="float32"),
        loss=JLossConfig(depth_mult=1e-3, alpha_reg=1.0, encode_feat=False, fine=True),
        candidate_schedule=(0.1, 0.5), max_steps=MAX_STEPS, pose_optimize=True, near=0.1, far=5.0, batch_size=BATCH,
    )


def torch_cfg():
    return StepConfig(
        nerf=NeRFConfig(**NERF), transient=TransientConfig(**T_NET),
        render=RenderConfig(N_samples=8, N_importance=8, perturb=1.0, precision="float32"),
        loss=LossConfig(depth_mult=1e-3, alpha_reg=1.0, encode_feat=False, fine=True),
        candidate_schedule=(0.1, 0.5), max_steps=MAX_STEPS, pose_optimize=True, near=0.1, far=5.0, batch_size=BATCH,
    )


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    jcfg = jax_cfg()
    scene, store = tiny_scene(n_img=N_IMG, H=8, W=8, fh=4, fw=4, feat_dim=16, seed=2)
    params = jinit_params(jax.random.PRNGKey(5), jcfg.nerf, jcfg.transient, N_IMG)
    rng = np.random.RandomState(6)
    pose = {"se3": jnp.asarray(rng.randn(N_IMG, 6).astype(np.float32) * 0.02),
            "depth_scale": jnp.asarray(rng.randn(N_IMG, 2).astype(np.float32) * 0.1)}
    idx = rng.choice(store.n_rays, BATCH, replace=False)
    noise = {"coarse": rng.uniform(0.05, 0.95, (BATCH, 8)).astype(np.float32),
             "fine": rng.uniform(0.05, 0.95, (BATCH, 8)).astype(np.float32)}
    tscene = make_scene_constants(np.asarray(scene.Ks), np.asarray(scene.poses), np.asarray(scene.near_far),
                                  np.asarray(scene.wh), np.asarray(scene.feat_maps), "cpu", feat_dtype=torch.float32)
    tstore = make_ray_store(*(np.asarray(a) for a in store), device="cpu")
    return dict(scene=scene, params=params, pose=pose, jbatch=jgather_batch(store, jnp.asarray(idx)), noise=noise,
                tscene=tscene, tbatch=tstep.gather_batch(tstore, torch.from_numpy(idx)))


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_featureless_step_matches_jax(world, phase):
    """The loss terms and gradients of upnerf.train.step's forward,
    depth_prior and compute_loss (its _loss_and_metrics without the metrics:
    in phase 0 that function raises a KeyError for a feature-less field, as
    its per-image signal reads s_rgb, which phase 0 does not composite; the
    port reads the candidate's c_rgb there, ROADMAP.md §3)."""
    w = world
    jcfg = jax_cfg()
    progress = jnp.asarray(STEP_OF_PHASE[phase], jnp.int32).astype(jnp.float32) / MAX_STEPS
    from upnerf.train import step as jstep
    from upnerf.train.schedules import schedule_mult as jsched

    noise = {k: jnp.asarray(v) for k, v in w["noise"].items()}
    sched = jsched(progress, (0.1, 0.5))

    def f(p, pp):
        results, _, feats = jstep.forward(p, pp, jcfg, w["scene"], w["jbatch"], None, phase=phase, sched_mult=sched,
                                          progress=progress, noise=noise)
        pred = jstep.depth_prior(pp, w["jbatch"], jcfg.near, jcfg.far)
        terms = jcompute_loss(jcfg.loss, results, w["jbatch"]["rgb"], feats, pred, sched, phase)
        return sum(terms.values()), {f"loss/{k}": v for k, v in terms.items()}

    (_, jm), (g, pg) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(w["params"], w["pose"])
    jg = weights.state_dict_from_jax(jax.tree.map(np.asarray, g), jax.tree.map(np.asarray, pg), 0.0)
    if phase == 0:
        with pytest.raises(KeyError, match="s_rgb_fine"):
            jloss_and_metrics(w["params"], w["pose"], jcfg, w["scene"], w["jbatch"], noise, 0, sched, progress)
    else:
        jm.update(jloss_and_metrics(w["params"], w["pose"], jcfg, w["scene"], w["jbatch"], noise, phase, sched,
                                    progress)[1])

    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    model, pose = weights.train_modules_from_jax(to_np(w["params"]), to_np(w["pose"]), NeRFConfig(**NERF),
                                                 TransientConfig(**T_NET), N_IMG)
    assert hasattr(model.nerf_coarse, "rgb_candidate_layer") and not hasattr(model.nerf_coarse, "feat_share_layer")
    opt = make_optimizer("adam", 5e-3, 5e-4, MAX_STEPS)
    state = make_train_state(model, pose, opt, make_optimizer("adam", 2e-3, 2e-4, MAX_STEPS), seed=0, device="cpu")
    cfg = torch_cfg()
    tprog = pe_progress(STEP_OF_PHASE[phase], MAX_STEPS)
    loss, tm = tstep._loss_and_metrics(state.params, state.pose_params, cfg, w["tscene"], w["tbatch"],
                                       {k: torch.from_numpy(v) for k, v in w["noise"].items()}, phase,
                                       schedule_mult(tprog, cfg.candidate_schedule), tprog)
    loss.backward()
    keys = [k for k in jm if k.startswith("loss/")]
    assert set(keys) == {k for k in tm if k.startswith("loss/")}
    assert ("loss/l_c_rgb_f" in keys) == (phase < 2)
    for k in keys:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-9, err_msg=k)
    if phase > 0:
        np.testing.assert_allclose(tm["img_loss_sum"].numpy(), np.asarray(jm["img_loss_sum"]), rtol=1e-5)
    got = {k: p.grad for k, p in state.params.named_parameters() if p.requires_grad}
    got.update({k: p.grad for k, p in state.pose_params.named_parameters()})
    assert set(got) <= set(jg)
    for k, gk in got.items():
        wv = jg[k].numpy()
        gv = np.zeros_like(wv) if gk is None else gk.detach().numpy()
        if not np.any(wv):  # a leaf the phase does not reach
            assert not np.any(gv), k
            continue
        tol = 1e-3 if k.endswith("share_sigma.0.bias") else 1e-4
        assert rel(gv, wv) <= tol, k


def test_candidate_free_phase0_raises_in_both(world):
    jcfg = jax_cfg()
    rays = np.concatenate([np.zeros((8, 3)), np.tile([[0.0, 0.0, -1.0]], (8, 1)), np.tile([[0.1, 5.0]], (8, 1))], 1)
    rays = rays.astype(np.float32)
    jparams = {k: w for k, w in world["params"].items() if k != "transient"}
    with pytest.raises(NotImplementedError, match="candidate-free"):
        jrender_rays(jparams, jcfg.render, jcfg.nerf, jnp.asarray(rays), jnp.zeros(8, jnp.int32), key=None, phase=0,
                     sched_mult=jnp.float32(0.0), progress=jnp.float32(0.05), encode_candidate=False, det=True)
    fields = {typ: port_field(world["params"][typ], NeRFConfig(**NERF)) for typ in ("nerf_coarse", "nerf_fine")}
    params = dict(fields, embeddings={k: torch.from_numpy(np.asarray(v)) for k, v in jparams["embeddings"].items()})
    with pytest.raises(NotImplementedError, match="candidate-free"):
        render_rays(params, torch_cfg().render, torch.from_numpy(rays), torch.zeros(8, dtype=torch.long), phase=0,
                    sched_mult=0.0, progress=0.05, encode_candidate=False)
