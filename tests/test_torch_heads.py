"""The `fused_train`-off configuration of upnerf_torch against the JAX package.

- Kernel 5's plain version (`ops.heads.fused_trunk_heads_plain` and its
  backward) against `upnerf.ops.pallas_heads.fused_trunk_heads` in the Pallas
  interpreter, forward and `jax.vjp`, with and without the candidate branch,
  at D=4, W=32, skip 2, L=4, F=16, HC=16, C=4, 64 rows. f32: 1e-5 of each
  output's / gradient's max. bf16: forward 1e-5; head gradients and dc_emb
  1e-4; dx0 and the trunk's gradients below its last layer 2e-2, because the
  JAX backward forms the trunk's input cotangent with a bare `jnp.dot`
  (pallas_heads.py:217), full f32 in the interpreter, where the port rounds
  both operands to bf16 as every other product there does (ROADMAP.md §3);
- kernel 4's plain version (`ops.render.fused_static_render`) against
  `upnerf.ops.pallas_render.fused_static_render` in the interpreter, forward
  and VJP: 1e-5 (the plain version's cumprod against the kernel's
  exp-of-cumsum transmittance);
- the render dispatch: a deterministic phase-2 render and a phase-1 training
  render in each configuration (defaults; `fused_train` off; `fused_train` and
  `fused_render` off) against JAX's `render_rays` with the same flags (its
  fused kernels in the interpreter): rgb / weights / features 1e-4, depth 1e-4
  relative; and the route each pass takes (which wrapper ran);
- one teacher-forced step per phase with `fused_train` off (the field through
  kernel 5, the val-style renders through kernel 4) against JAX's step with
  `pallas_heads` and `pallas_render` in the interpreter: loss terms 1e-5
  relative, gradients 1e-4 of each leaf's max (1e-3 for the sigma heads' weights
  and biases: their gradients sum the sigma cotangents of all samples, which
  nearly cancel on an opaque ray, tests/test_torch_train_step.py; the JAX
  kernel sums them tile by tile), the updated parameters as there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.models import NeRFConfig as JNeRFConfig
from upnerf.models import TransientConfig as JTransientConfig
from upnerf.ops import pallas_heads as jph
from upnerf.ops import pallas_render as jpr
from upnerf.ops import pallas_render_train as jrt
from upnerf.render import RenderConfig as JRenderConfig
from upnerf.render import render_rays as jrender_rays
from upnerf.train import LossConfig as JLossConfig
from upnerf.train import StepConfig as JStepConfig
from upnerf.train import TrainState as JTrainState
from upnerf.train import init_params as jinit_params
from upnerf.train import make_optimizer as jmake_optimizer
from upnerf.train import make_train_step as jmake_train_step
from upnerf.train.step import _loss_and_metrics as jloss_and_metrics
from upnerf.train.step import gather_batch as jgather_batch
from upnerf_torch.models import nerf as tnerf
from upnerf_torch.models.nerf import NeRFConfig
from upnerf_torch.models.transient import TransientConfig
from upnerf_torch.ops import heads as th
from upnerf_torch.ops import render as trd
from upnerf_torch.ops import render_train as trt
from upnerf_torch.render.render_rays import RenderConfig
from upnerf_torch.render.render_rays import render_rays as t_render_rays
from upnerf_torch.train import (
    LossConfig,
    StepConfig,
    make_optimizer,
    make_ray_store,
    make_scene_constants,
    make_train_state,
    make_train_step,
    pe_progress,
    schedule_mult,
)
from upnerf_torch.train import step as tstep
from upnerf_torch.utils import weights

from helpers import tiny_scene

D, W, SK, L, F, HC, C, N = 4, 32, (2,), 4, 16, 16, 4, 64
IN0 = 3 + 6 * L
NERF = dict(D=4, W=32, skips=(2,), feat_dim=16, xyz_L=4, dir_L=2, appearance_dim=8, candidate_dim=4, c2f=(0.1, 0.5))
T_NET = dict(beta_min=0.1, transient_dim=8, feat_dim=16)
N_IMG, BATCH, MAX_STEPS, LR, POSE_LR = 3, 16, 100, 5e-3, 2e-3
STEP_OF_PHASE = {0: 5, 1: 30, 2: 60}
# (fused_train, fused_render, fused_trunk) per configuration
CONFIGS = {"defaults": (True, True, True), "fused_train_off": (False, True, True), "all_off": (False, False, True)}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    for mod in (jph, jpr, jrt):
        monkeypatch.setattr(mod, "INTERPRET", True)


def lin(rng, i, o):
    b = i**-0.5
    return rng.uniform(-b, b, (i, o)).astype(np.float32), rng.uniform(-b, b, o).astype(np.float32)


def heads_world(seed=0):
    rng = np.random.RandomState(seed)
    trunk = [lin(rng, IN0 if i == 0 else (IN0 + W if i in SK else W), W) for i in range(D)]
    heads = {}
    for k, (i, o) in dict(sigma=(W, 1), xyzf=(W, W), feat=(W, F), c1=(W + C, HC), c2=(HC, HC), csig=(HC, 1),
                          cfeat=(HC, F)).items():
        heads[k + "_w"], heads[k + "_b"] = lin(rng, i, o)
    x0 = rng.randn(N, IN0).astype(np.float32)
    ce = rng.randn(N, C).astype(np.float32)
    cots = [rng.randn(N, 1).astype(np.float32), rng.randn(N, F).astype(np.float32),
            rng.randn(N, 1).astype(np.float32), rng.randn(N, F).astype(np.float32)]
    return trunk, heads, x0, ce, cots


def rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("cand", [True, False])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_heads_plain_matches_pallas_interpret(interpret, precision, cand):
    trunk, heads, x0, ce, cots = heads_world()
    keys = jph.HEAD_KEYS + (jph.CAND_KEYS if cand else ())
    jt = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in trunk)
    jh = {k: jnp.asarray(heads[k]) for k in keys}
    jout, vjp = jax.vjp(lambda x, c, t, h: jph.fused_trunk_heads(x, c, t, h, SK, 32, precision), jnp.asarray(x0),
                        jnp.asarray(ce) if cand else None, jt, jh)
    jg = vjp(tuple(jnp.asarray(c) for c in cots[: len(jout)]))
    T = torch.from_numpy
    tt = [(T(w), T(b)) for w, b in trunk]
    thd = {k: T(heads[k]) for k in keys}
    tout = th.fused_trunk_heads_plain(T(x0), T(ce) if cand else None, tt, thd, SK, precision)
    assert len(tout) == len(jout) == (4 if cand else 2)
    for a, b in zip(tout, jout):
        assert rel(a.numpy(), b) <= 1e-5
    dx0, dce, dtr, dh = th.fused_trunk_heads_bwd_plain(T(x0), T(ce) if cand else None, tt, thd, SK, precision,
                                                       [T(c) for c in cots[: len(jout)]])
    bare_dot = precision == "bfloat16"  # pallas_heads.py:217 sums the trunk's input cotangent unrounded
    tol_trunk = 2e-2 if bare_dot else 1e-5
    tol_heads = 1e-4 if bare_dot else 1e-5
    assert rel(dx0.numpy(), jg[0]) <= tol_trunk
    if cand:
        assert rel(dce.numpy(), jg[1]) <= tol_heads
    for i in range(D):
        tol = tol_heads if i == D - 1 else tol_trunk
        assert rel(dtr[i][0].numpy(), jg[2][i][0]) <= tol and rel(dtr[i][1].numpy(), jg[2][i][1]) <= tol, i
    for k in keys:
        assert rel(dh[k].numpy(), jg[3][k]) <= tol_heads, k
    if bare_dot:  # the difference is that product's rounding: it is there, and it is small
        assert 1e-5 < rel(dx0.numpy(), jg[0])


def test_heads_function_equals_plain_backward():
    trunk, heads, x0, ce, cots = heads_world(1)
    T = torch.from_numpy
    x = T(x0).requires_grad_()
    c = T(ce).requires_grad_()
    tt = [(T(w).requires_grad_(), T(b).requires_grad_()) for w, b in trunk]
    thd = {k: T(v).requires_grad_() for k, v in heads.items()}
    outs = th.fused_trunk_heads(x, c, tt, thd, SK, "bfloat16")
    torch.autograd.backward(outs, [T(g) for g in cots])
    dx0, dce, dtr, dh = th.fused_trunk_heads_bwd_plain(T(x0), T(ce), [(T(w), T(b)) for w, b in trunk],
                                                       {k: T(v) for k, v in heads.items()}, SK, "bfloat16",
                                                       [T(g) for g in cots])
    assert torch.equal(x.grad, dx0) and torch.equal(c.grad, dce)
    assert all(torch.equal(tt[i][0].grad, dtr[i][0]) for i in range(D))
    assert all(torch.equal(thd[k].grad, dh[k].reshape(thd[k].shape)) for k in heads)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_static_render_plain_matches_pallas_interpret(interpret, precision):
    rng = np.random.RandomState(2)
    trunk = [lin(rng, IN0 if i == 0 else (IN0 + W if i in SK else W), W) for i in range(D)]
    hd = {}
    for k, (i, o) in dict(sigma=(W, 1), xyzf=(W, W), feat=(W, F), rgb2=(16, 3)).items():
        hd[k + "_w"], hd[k + "_b"] = lin(rng, i, o)
    hd["rgb1_w"] = lin(rng, F, 16)[0]
    R, S = 8, 16
    x0 = rng.randn(R * S, IN0).astype(np.float32)
    z = np.sort(rng.uniform(0.1, 5, (R, S)), -1).astype(np.float32)
    cond = (rng.randn(R, 16) * 0.3).astype(np.float32)
    jt = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in trunk)
    jh = {k: jnp.asarray(v) for k, v in hd.items()}
    jout, vjp = jax.vjp(lambda x, c, t, h: jpr.fused_static_render(x, jnp.asarray(z), c, t, h, SK, 8, precision),
                        jnp.asarray(x0), jnp.asarray(cond), jt, jh)
    gs = [rng.randn(*o.shape).astype(np.float32) for o in jout]
    jg = vjp(tuple(jnp.asarray(g) for g in gs))
    T = torch.from_numpy
    x = T(x0).requires_grad_()
    c = T(cond).requires_grad_()
    tt = [(T(w).requires_grad_(), T(b).requires_grad_()) for w, b in trunk]
    thd = {k: T(v).requires_grad_() for k, v in hd.items()}
    tout = trd.fused_static_render(x, T(z), c, tt, thd, SK, precision)
    for a, b in zip(tout, jout):
        assert a.shape == b.shape and rel(a.detach().numpy(), b) <= 1e-5
    torch.autograd.backward(tout, [T(g) for g in gs])
    assert rel(x.grad.numpy(), jg[0]) <= 1e-5 and rel(c.grad.numpy(), jg[1]) <= 1e-5
    for i in range(D):
        assert rel(tt[i][0].grad.numpy(), jg[2][i][0]) <= 1e-5
    for k in hd:
        assert rel(thd[k].grad.numpy(), jg[3][k]) <= 1e-5, k


# ---------------------------------------------------------------------------
# render dispatch and the fused_train-off step


@pytest.fixture(scope="module")
def world():
    scene, store = tiny_scene(n_img=N_IMG, H=8, W=8, fh=4, fw=4, feat_dim=16, seed=1)
    params = jinit_params(jax.random.PRNGKey(3), JNeRFConfig(**NERF), JTransientConfig(**T_NET), N_IMG)
    rng = np.random.RandomState(4)
    pose = {"se3": jnp.asarray(rng.randn(N_IMG, 6).astype(np.float32) * 0.02),
            "depth_scale": jnp.asarray(rng.randn(N_IMG, 2).astype(np.float32) * 0.1)}
    idx = rng.choice(store.n_rays, BATCH, replace=False)
    noise = {"coarse": rng.uniform(0.05, 0.95, (BATCH, 8)).astype(np.float32),
             "fine": rng.uniform(0.05, 0.95, (BATCH, 8)).astype(np.float32)}
    tscene = make_scene_constants(np.asarray(scene.Ks), np.asarray(scene.poses), np.asarray(scene.near_far),
                                  np.asarray(scene.wh), np.asarray(scene.feat_maps), "cpu", feat_dtype=torch.float32)
    tstore = make_ray_store(*(np.asarray(a) for a in store), device="cpu")
    d = rng.randn(BATCH, 3)
    rays = np.concatenate([rng.randn(BATCH, 3) * 0.2, d / np.linalg.norm(d, axis=-1, keepdims=True),
                           np.tile([[0.1, 5.0]], (BATCH, 1))], -1).astype(np.float32)
    return dict(scene=scene, store=store, params=params, pose=pose, jbatch=jgather_batch(store, jnp.asarray(idx)),
                noise=noise, tscene=tscene, tbatch=tstep.gather_batch(tstore, torch.from_numpy(idx)), rays=rays,
                img_idx=rng.randint(0, N_IMG, BATCH))


def port_modules(w):
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return weights.train_modules_from_jax(to_np(w["params"]), to_np(w["pose"]), NeRFConfig(**NERF),
                                          TransientConfig(**T_NET), N_IMG)


def configs(name):
    ft, fr, ftr = CONFIGS[name]
    jn = JNeRFConfig(**NERF, fused_trunk=ftr)
    jr = JRenderConfig(N_samples=8, N_importance=8, perturb=1.0, precision="float32", fused_train=ft, fused_render=fr)
    tn = NeRFConfig(**NERF, fused_trunk=ftr)
    tr = RenderConfig(N_samples=8, N_importance=8, perturb=1.0, precision="float32", fused_train=ft, fused_render=fr)
    return jn, jr, tn, tr


def spy(monkeypatch):
    """Counts of the wrappers each route calls."""
    calls = {"render_train": 0, "static": 0, "heads": 0}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **k):
            calls[key] += 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)

    wrap(trt, "render_train_rays_fwd", "render_train")  # RenderTrainRays.forward calls it too
    wrap(trd, "fused_static_render", "static")
    wrap(tnerf, "fused_trunk_heads", "heads")
    return calls


ROUTES = {  # (config, det phase-2 render) -> calls of each wrapper for the 2 passes
    ("defaults", True): {"render_train": 2, "static": 0, "heads": 0},
    ("defaults", False): {"render_train": 2, "static": 0, "heads": 0},
    ("fused_train_off", True): {"render_train": 0, "static": 2, "heads": 0},
    ("fused_train_off", False): {"render_train": 0, "static": 0, "heads": 2},
    ("all_off", True): {"render_train": 0, "static": 0, "heads": 2},
    ("all_off", False): {"render_train": 0, "static": 0, "heads": 2},
}


@pytest.mark.parametrize("det", [True, False], ids=["det_phase2", "train_phase1"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_render_dispatch_matches_jax(world, interpret, monkeypatch, name, det):
    jn, jr, tn, tr = configs(name)
    phase, progress = (2, 0.6) if det else (1, 0.3)
    sched = float(schedule_mult(progress, (0.1, 0.5)))
    noise = None if det else world["noise"]
    model, _ = port_modules(world)
    for f in (model.nerf_coarse, model.nerf_fine):
        f.cfg = tn
    jparams = {k: world["params"][k] for k in ("nerf_coarse", "nerf_fine", "embeddings")}
    want = jrender_rays(jparams, jr, jn, jnp.asarray(world["rays"]), jnp.asarray(world["img_idx"]), key=None,
                        phase=phase, sched_mult=jnp.float32(sched), progress=jnp.float32(progress), det=det,
                        noise=None if det else {k: jnp.asarray(v) for k, v in noise.items()})
    calls = spy(monkeypatch)
    with torch.set_grad_enabled(not det):
        got = t_render_rays(model.render_params(), tr, torch.from_numpy(world["rays"]),
                              torch.from_numpy(world["img_idx"]), phase=phase, sched_mult=sched, progress=progress,
                              det=det, noise=None if det else {k: torch.from_numpy(v) for k, v in noise.items()})
    assert calls == ROUTES[(name, det)]
    assert set(got) == set(want)
    for k, v in got.items():
        v, ref = v.detach().numpy(), np.asarray(want[k])
        if "depth" in k:
            np.testing.assert_allclose(v, ref, rtol=1e-4, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(v, ref, rtol=0, atol=1e-4, err_msg=k)


def step_cfgs():
    jn, jr, tn, tr = configs("fused_train_off")
    loss = dict(depth_mult=1e-3, alpha_reg=1.0, encode_feat=True, fine=True)
    common = dict(candidate_schedule=(0.1, 0.5), max_steps=MAX_STEPS, pose_optimize=True, near=0.1, far=5.0,
                  batch_size=BATCH)
    return (JStepConfig(nerf=jn, transient=JTransientConfig(**T_NET), render=jr._replace(encode_feat=True),
                        loss=JLossConfig(**loss), **common),
            StepConfig(nerf=tn, transient=TransientConfig(**T_NET), render=tr, loss=LossConfig(**loss), **common))


def check_grads(got, want):
    for k, g in got.items():
        wv = want[k].numpy()
        gv = np.zeros_like(wv) if g is None else g.detach().numpy()
        if not np.any(wv):
            assert not np.any(gv), k
            continue
        tol = 1e-3 if "sigma.0." in k else 1e-4
        np.testing.assert_allclose(gv / np.abs(wv).max(), wv / np.abs(wv).max(), rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_fused_train_off_step_matches_jax(world, interpret, phase):
    """One teacher-forced step: loss terms, gradients and updated parameters."""
    jcfg, tcfg = step_cfgs()
    progress_j = jnp.asarray(STEP_OF_PHASE[phase], jnp.int32).astype(jnp.float32) / MAX_STEPS
    from upnerf.train.schedules import schedule_mult as jsched

    jnoise = {k: jnp.asarray(v) for k, v in world["noise"].items()}

    def f(p, pp):
        return jloss_and_metrics(p, pp, jcfg, world["scene"], world["jbatch"], jnoise, phase,
                                 jsched(progress_j, jcfg.candidate_schedule), progress_j)

    (_, jm), (jgp, jgpp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(world["params"], world["pose"])
    jg = weights.state_dict_from_jax(jax.tree.map(np.asarray, jgp), jax.tree.map(np.asarray, jgpp), 0.0)
    jopt = jmake_optimizer("adam", LR, LR / 10, MAX_STEPS)
    jpose_opt = jmake_optimizer("adam", POSE_LR, POSE_LR / 10, MAX_STEPS)
    jstate = JTrainState(step=jnp.asarray(STEP_OF_PHASE[phase], jnp.int32), params=world["params"],
                         pose_params=world["pose"], opt_state=jopt.init(world["params"]),
                         pose_opt_state=jpose_opt.init(world["pose"]),
                         rng=jax.random.key_data(jax.random.key(0, impl="rbg")))
    _, jbatch_step = jmake_train_step(jcfg, jopt, jpose_opt)
    jnew, _ = jbatch_step(jstate, world["scene"], world["jbatch"], phase, noise=jnoise)
    want = weights.state_dict_from_jax(jax.tree.map(np.asarray, jnew.params),
                                       jax.tree.map(np.asarray, jnew.pose_params), 0.0)

    model, pose = port_modules(world)
    opt = make_optimizer("adam", LR, LR / 10, MAX_STEPS)
    pose_opt = make_optimizer("adam", POSE_LR, POSE_LR / 10, MAX_STEPS)
    state = make_train_state(model, pose, opt, pose_opt, seed=0, device="cpu")
    for f_ in (state.params.nerf_coarse, state.params.nerf_fine):
        f_.cfg = tcfg.nerf
    progress = pe_progress(STEP_OF_PHASE[phase], MAX_STEPS)
    tnoise = {k: torch.from_numpy(v) for k, v in world["noise"].items()}
    loss, tm = tstep._loss_and_metrics(state.params, state.pose_params, tcfg, world["tscene"], world["tbatch"], tnoise,
                                       phase, schedule_mult(progress, tcfg.candidate_schedule), progress)
    for k in [k for k in jm if k.startswith("loss")]:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-9, err_msg=k)
    loss.backward()
    grads = {k: p.grad for k, p in state.params.named_parameters() if p.requires_grad}
    grads.update({k: p.grad for k, p in state.pose_params.named_parameters()})
    check_grads(grads, jg)
    state.opt_state.zero_grad()
    state.pose_opt_state.zero_grad()
    _, batch_step = make_train_step(tcfg, opt, pose_opt)
    new, _ = batch_step(state._replace(step=STEP_OF_PHASE[phase]), world["tscene"], world["tbatch"], phase,
                        noise=tnoise)
    got = dict(new.params.named_parameters())
    got.update(dict(new.pose_params.named_parameters()))
    for k, p in got.items():
        if not p.requires_grad:
            continue
        g = jg[k].numpy()
        gmax = max(float(np.abs(g).max()), 1e-30)
        mask = np.abs(g) > 1e-6 * gmax
        lr = POSE_LR if k in ("se3_refine.weight", "depth_scale.weight") else LR
        tol = 1e-3 * lr + 1e-6 + lr * (1e-3 if "sigma.0." in k else 1e-4) * gmax / (np.abs(g) + 1e-8)
        diff = np.abs(p.detach().numpy() - want[k].numpy())
        assert (diff[mask] <= tol[mask]).all(), (k, float((diff - tol)[mask].max()))
