"""Lockstep: the port's train step against the JAX package's over a
schedule, teacher-forced (modelled on scripts/lockstep_parity.py and
tests/test_torch_train_step.py). The north star's third condition: on a
synthetic protocol scene, the pure-torch path equals the JAX package within
f32 tolerance.

Setup. One scene written by the JAX package's synthetic generator (the
synth_* protocol scenes' generator, cut to 4 train images of 24 x 32, 8 x 8 x
16 DINO cells), loaded by each package's own load_training_data. One seeded
JAX init moves across through utils.weights.train_modules_from_jax.

The run. 12 steps, max_steps 12 with the candidate schedule (0.1, 0.5):
phase 0 at steps 0-1, 1 at 2-6, 2 at 7-11. Each step draws the same batch
indices (64 rays) and the same render uniforms (passed through the `noise=`
hooks). Before each step the port is reset to JAX's state: parameters, pose
tables (train_modules_from_jax's mapping), optimizer moments and step count
(utils.weights.optimizer_state_from_jax). Both take one step; JAX's result
is the next step's state. JAX's step is its jitted batch_step
(upnerf.train.make_train_step) for adam / ExponentialLR, the configuration
the warp cases also run; for the other optimizer cases it is what that
step's `_update` does, one compile fewer a phase: the gradients of
upnerf.train.step._loss_and_metrics (jitted once a phase for the tolerance
below anyway), then the JAX package's optimizer (upnerf.train.optim) and
optax.apply_updates on both groups. F = 16, D = 4, W = 32, 8 + 8 samples,
float32; on the CPU the port's kernels run their plain versions.

What each step compares:
- every loss term: 1e-5 relative, the phase-1 coarse terms 2e-4
  (docs/DESIGN.md:907-910: schedule-weighted, (1 - m) -> 0);
- the LR of the step (the optimizer's) and the logged one (the schedule
  after the step) against optax's schedule: 1e-6 relative;
- every parameter and pose table after the step at the tolerance of
  tests/test_torch_train_step.py's test_batch_step_updates_match_jax, with
  the gradients of upnerf.train.step._loss_and_metrics: 1e-3 lr + 1e-6 + lr
  times the gradient tolerance (1e-4 of the leaf's max |g|, 1e-3 for
  share_sigma.0.bias) over |g| + 1e-8, where |g| > 1e-6 max |g|.
Optimizer cases: (adam, ExponentialLR), (adamw, cosine), (sgd, constant).

Warp cases, with adam: the detector fed by each package's own per-image
losses at every step, with the events run as each package's Trainer runs
them (upnerf/train/loop.py:485-566): `reset` zeroes the flagged rows,
`multistart` runs run_multistart with each package's scorer (16 score rays,
2 kicks) and the shared RandomState(seed + 977); then reset_opt_rows. The
event comes at the same step in both, with the same flags and adopted rows;
the adopted rows of the table are equal (exactly zero for reset), the
adopted moment rows exactly zero in both, the rest at the tolerances above.
The reset case also measures the detector EMA that start_cooldown leaves in
place (a JAX-side fault logged in ROADMAP.md queue 3): the port follows JAX,
and `LOG` prints the reset row's EMA at each check after the event.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from upnerf.data import load_training_data as jload_training_data
from upnerf.data import synthetic
from upnerf.models import NeRFConfig as JNeRFConfig
from upnerf.models import TransientConfig as JTransientConfig
from upnerf.render import RenderConfig as JRenderConfig
from upnerf.train import LossConfig as JLossConfig
from upnerf.train import StepConfig as JStepConfig
from upnerf.train import TrainState as JTrainState
from upnerf.train import init_params as jinit_params
from upnerf.train import make_train_step as jmake_train_step
from upnerf.train import optim as joptim
from upnerf.train import warp as jwarp
from upnerf.train.step import _loss_and_metrics as jloss_and_metrics
from upnerf.train.step import gather_batch as jgather_batch
from upnerf_torch.config import default
from upnerf_torch.data import load_training_data
from upnerf_torch.models.nerf import NeRFConfig
from upnerf_torch.models.transient import TransientConfig
from upnerf_torch.render.render_rays import RenderConfig
from upnerf_torch.train import (
    LossConfig,
    StepConfig,
    make_optimizer,
    make_ray_store,
    make_scene_constants,
    make_train_state,
    make_train_step,
    schedule_phase,
    warp,
)
from upnerf_torch.train import step as tstep
from upnerf_torch.train.optim import learning_rate_at
from upnerf_torch.utils import weights

NERF = dict(D=4, W=32, skips=(2,), feat_dim=16, xyz_L=4, dir_L=2, appearance_dim=8, candidate_dim=4, c2f=(0.1, 0.5))
T_NET = dict(beta_min=0.1, transient_dim=8, feat_dim=16)
N_STEPS, BATCH, SEED, CAND = 12, 64, 3, (0.1, 0.5)
LR, LR_END, POSE_LR, POSE_LR_END = 5e-3, 5e-4, 2e-3, 1e-4
NEAR, FAR = 0.5, 6.0
OPT_CASES = [("adam", "ExponentialLR"), ("adamw", "cosine"), ("sgd", "constant")]
WARP = {  # the detector and mitigation of each warp case
    "reset": dict(mitigate="reset", ratio=1.02, patience=2, decay=0.7, min_progress=0.4, max_progress=1.0,
                  cooldown=2, max_events=1),
    "multistart": dict(mitigate="multistart", ratio=1.0001, patience=1, decay=0.0, min_progress=0.4,
                       max_progress=1.0, cooldown=2, max_events=1, kicks=2, score_rays=16),
}
LOG = []  # measurements printed with -s


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cfg():
    return JStepConfig(
        nerf=JNeRFConfig(**NERF, fused_trunk=False), transient=JTransientConfig(**T_NET),
        render=JRenderConfig(N_samples=8, N_importance=8, perturb=1.0, encode_feat=True, precision="float32"),
        loss=JLossConfig(depth_mult=1e-3, alpha_reg=1.0, encode_feat=True, fine=True), candidate_schedule=CAND,
        max_steps=N_STEPS, pose_optimize=True, near=NEAR, far=FAR, batch_size=BATCH,
    )


def torch_cfg():
    return StepConfig(
        nerf=NeRFConfig(**NERF), transient=TransientConfig(**T_NET),
        render=RenderConfig(N_samples=8, N_importance=8, perturb=1.0, precision="float32"),
        loss=LossConfig(depth_mult=1e-3, alpha_reg=1.0, encode_feat=True, fine=True), candidate_schedule=CAND,
        max_steps=N_STEPS, pose_optimize=True, near=NEAR, far=FAR, batch_size=BATCH,
    )


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("lockstep") / "scene")
    synthetic.generate_scene(root, n_train=4, n_test=1, H=24, W=32, feat_hw=8, feat_dim=16, focal=30.0, arc=0.5)
    hp = default()
    hp.update({"dataset_name": "custom", "scene_name": "synth", "root_dir": root,
               "feat_dir": os.path.join(root, "DINO"), "depth_dir": os.path.join(root, "DPT"),
               "phototourism.img_downscale": 1, "phototourism.use_cache": False, "nerf.near": NEAR, "nerf.far": FAR})
    jscene_np, jstore_np, jmeta = jload_training_data(hp)
    scene_np, store_np, meta = load_training_data(hp)
    n_img = meta.N_images_train
    assert n_img == jmeta.N_images_train == 4
    from upnerf.train import RayStore as JRayStore
    from upnerf.train import make_scene_constants as jmake_scene_constants

    jscene = jmake_scene_constants(jscene_np["Ks"], jscene_np["poses"], jscene_np["near_far"], jscene_np["wh"],
                                   jscene_np["feat_maps"])
    jscene = jscene._replace(feat_maps=jnp.asarray(np.asarray(jscene_np["feat_maps"], np.float32)))
    jstore = JRayStore(**{k: jnp.asarray(jstore_np[k]) for k in ("px", "py", "img_idx", "rgb", "inv_depth")})
    tscene = make_scene_constants(scene_np["Ks"], scene_np["poses"], scene_np["near_far"], scene_np["wh"],
                                  scene_np["feat_maps"], "cpu", feat_dtype=torch.float32)
    tstore = make_ray_store(store_np["px"], store_np["py"], store_np["img_idx"], store_np["rgb"],
                            store_np["inv_depth"], "cpu")
    rng = np.random.RandomState(SEED)
    draws = [(rng.randint(0, tstore.n_rays, BATCH),
              {k: rng.uniform(0.02, 0.98, (BATCH, 8)).astype(np.float32) for k in ("coarse", "fine")})
             for _ in range(N_STEPS)]
    jcfg = jax_cfg()
    params = jinit_params(jax.random.PRNGKey(SEED), jcfg.nerf, jcfg.transient, n_img)
    grads = {}  # phase -> jitted value_and_grad of JAX's loss, shared by every case
    jopt = joptim.make_optimizer("adam", LR, LR_END, N_STEPS, "ExponentialLR")
    jpose_opt = joptim.make_optimizer("adam", POSE_LR, POSE_LR_END, N_STEPS, "ExponentialLR")
    _, adam_step = jmake_train_step(jcfg, jopt, jpose_opt)  # its compiles shared by the adam cases

    def jax_grads(phase):
        if phase not in grads:
            def f(p, pp, batch, noise, sched, progress):
                return jloss_and_metrics(p, pp, jcfg, jscene, batch, noise, phase, sched, progress)

            grads[phase] = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
        return grads[phase]

    return dict(jscene=jscene, jstore=jstore, tscene=tscene, tstore=tstore, draws=draws, params=params,
                n_img=n_img, wh=np.asarray(scene_np["wh"]), jax_grads=jax_grads, adam_step=adam_step)


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def adam_moments(opt_state):
    """(mu, nu, count) of an optax adam / adamw state; (None, None, count)
    for sgd (its count from the schedule state, or none at all)."""
    for leaf in opt_state:
        if hasattr(leaf, "mu"):
            return np_tree(leaf.mu), np_tree(leaf.nu), int(leaf.count)
    return None, None, None


def load_port(state, jstate, step: int) -> None:
    """The port's modules and optimizer states := JAX's, in place."""
    sd = weights.state_dict_from_jax(np_tree(jstate.params), np_tree(jstate.pose_params), 0.0)
    pose_keys = set(state.pose_params.state_dict())
    state.params.load_state_dict({k: v for k, v in sd.items() if k not in pose_keys})
    state.pose_params.load_state_dict({k: sd[k] for k in pose_keys})
    for ost, module, jst in ((state.opt_state, state.params, jstate.opt_state),
                             (state.pose_opt_state, state.pose_params, jstate.pose_opt_state)):
        mu, nu, count = adam_moments(jst)
        weights.optimizer_state_from_jax(ost, module, mu, nu, step if count is None else count)


def grad_tol(k):
    return 1e-3 if k.endswith("share_sigma.0.bias") else 1e-4


def check_params(new_state, jnew, jg, lr_of, label):
    """Parameters and pose tables after the step, at test_batch_step_updates_match_jax's tolerance."""
    want = weights.state_dict_from_jax(np_tree(jnew.params), np_tree(jnew.pose_params), 0.0)
    got = dict(new_state.params.named_parameters())
    got.update(dict(new_state.pose_params.named_parameters()))
    worst = 0.0
    for k, p in got.items():
        if not p.requires_grad:
            continue
        g = jg[k].numpy()
        gmax = max(float(np.abs(g).max()), 1e-30)
        mask = np.abs(g) > 1e-6 * gmax
        lr = lr_of(k)
        tol = 1e-3 * lr + 1e-6 + lr * grad_tol(k) * gmax / (np.abs(g) + 1e-8)
        diff = np.abs(p.detach().numpy() - want[k].numpy())
        assert (diff[mask] <= tol[mask]).all(), (label, k, float((diff - tol)[mask].max()))
        if mask.any():
            worst = max(worst, float((diff[mask] / tol[mask]).max()))
    return worst


def check_losses(tm, jm, phase, label):
    worst = {}
    for k in (k for k in jm if k.startswith("loss")):
        rtol = 2e-4 if phase == 1 and k.endswith("_c") else 1e-5
        got, want = float(tm[k]), float(jm[k])
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-9, err_msg=f"{label} {k}")
        worst[k] = abs(got - want) / max(abs(want), 1e-30)
    return worst


def jax_event(world, det, jstate, flags, scorer, wh, rng, wcfg):
    """The JAX Trainer's adoption step (upnerf/train/loop.py:510-555) on a
    TrainState: (new state, adopted rows)."""
    se3_tab = np.asarray(jstate.pose_params["se3"])
    if wcfg.mitigate == "reset":
        new_tab = np.array(se3_tab)
        new_tab[flags] = 0.0
        adopted = np.nonzero(flags)[0]
    else:
        new_tab, adopted = jwarp.run_multistart(scorer, jstate.params, world["jscene"], se3_tab, flags, wh, wcfg, rng,
                                                log=lambda *a, **k: None)
    det.start_cooldown()
    if adopted.size == 0:
        return jstate, adopted
    pose = dict(jstate.pose_params, se3=jnp.asarray(new_tab))
    return jstate._replace(pose_params=pose, pose_opt_state=jwarp.reset_opt_rows(
        jstate.pose_opt_state, adopted, tuple(se3_tab.shape))), adopted


def port_event(state, det, flags, scorer, tscene, wh, rng, wcfg):
    """The port Trainer's adoption step (train/loop.py `_warp_check`) on a
    TrainState, in place: the adopted rows."""
    table = state.pose_params.se3_refine.weight
    se3_tab = table.detach().numpy()
    if wcfg.mitigate == "reset":
        new_tab = np.array(se3_tab)
        new_tab[flags] = 0.0
        adopted = np.nonzero(flags)[0]
    else:
        new_tab, adopted = warp.run_multistart(scorer, state.params, tscene, se3_tab, flags, wh, wcfg, rng,
                                               log=lambda *a, **k: None)
    det.start_cooldown()
    if adopted.size:
        with torch.no_grad():
            table.copy_(torch.from_numpy(new_tab))
        warp.reset_opt_rows(state.pose_opt_state, adopted, tuple(se3_tab.shape))
    return adopted


def run_lockstep(world, kind, sched, warp_case=None):
    jcfg, tcfg = jax_cfg(), torch_cfg()
    jopt = joptim.make_optimizer(kind, LR, LR_END, N_STEPS, sched)
    jpose_opt = joptim.make_optimizer(kind, POSE_LR, POSE_LR_END, N_STEPS, sched)
    pose = {"se3": jnp.zeros((world["n_img"], 6), jnp.float32),
            "depth_scale": jnp.zeros((world["n_img"], 2), jnp.float32)}
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32), params=world["params"], pose_params=pose,
                         opt_state=jopt.init(world["params"]), pose_opt_state=jpose_opt.init(pose),
                         rng=jax.random.key_data(jax.random.key(0, impl="rbg")))

    def composed_step(jstate, g, pg, metrics):
        """upnerf.train.step's `_update` after its gradients."""
        upd, ost = jopt.update(g, jstate.opt_state, jstate.params)
        pupd, post = jpose_opt.update(pg, jstate.pose_opt_state, jstate.pose_params)
        return jstate._replace(step=jstate.step + 1, params=optax.apply_updates(jstate.params, upd),
                               pose_params=optax.apply_updates(jstate.pose_params, pupd), opt_state=ost,
                               pose_opt_state=post), metrics
    opt = make_optimizer(kind, LR, LR_END, N_STEPS, sched)
    pose_opt = make_optimizer(kind, POSE_LR, POSE_LR_END, N_STEPS, sched)
    model, tables = weights.train_modules_from_jax(np_tree(world["params"]), np_tree(pose), NeRFConfig(**NERF),
                                                   TransientConfig(**T_NET), world["n_img"])
    state = make_train_state(model, tables, opt, pose_opt, seed=0, device="cpu")
    _, batch_step = make_train_step(tcfg, opt, pose_opt)
    jsched = joptim.lr_schedule(LR, LR_END, N_STEPS, sched)

    def lr_of(k):
        return POSE_LR if k in ("se3_refine.weight", "depth_scale.weight") else LR

    if warp_case is not None:
        wkw = WARP[warp_case]
        jwcfg, twcfg = jwarp.WarpConfig(**wkw), warp.WarpConfig(**wkw)
        jdet, tdet = jwarp.WarpDetector(world["n_img"], jwcfg), warp.WarpDetector(world["n_img"], twcfg)
        jrng, trng = np.random.RandomState(SEED + 977), np.random.RandomState(SEED + 977)
        jscorer = tscorer = None
        if warp_case == "multistart":
            jscorer = jwarp.make_pose_scorer(jcfg, twcfg.score_rays, twcfg.score_progress)
            tscorer = warp.make_pose_scorer(tcfg, twcfg.score_rays, twcfg.score_progress)
    events, emas, worst_loss, worst_param = [], [], {}, 0.0
    for k in range(N_STEPS):
        phase = schedule_phase(k / N_STEPS, CAND)
        idx, noise = world["draws"][k]
        load_port(state, jstate, k)
        state = state._replace(step=k)
        want_lr = float(jsched(k)) if callable(jsched) else float(jsched)
        assert state.opt_state.optimizer.param_groups[0]["lr"] == pytest.approx(want_lr, rel=1e-6), k

        jbatch = jgather_batch(world["jstore"], jnp.asarray(idx))
        jnoise = {kk: jnp.asarray(v) for kk, v in noise.items()}
        progress = jnp.asarray(k, jnp.int32).astype(jnp.float32) / N_STEPS
        from upnerf.train.schedules import schedule_mult as jsched_mult

        (_, jm), (g, pg) = world["jax_grads"](phase)(jstate.params, jstate.pose_params, jbatch, jnoise,
                                                     jsched_mult(progress, CAND), progress)
        jg = weights.state_dict_from_jax(np_tree(g), np_tree(pg), 0.0)
        if (kind, sched) == ("adam", "ExponentialLR"):
            jnew, jm2 = world["adam_step"](jstate, world["jscene"], jbatch, phase, noise=jnoise)
        else:
            jnew, jm2 = composed_step(jstate, g, pg, jm)
        state, tm = batch_step(state, world["tscene"], tstep.gather_batch(world["tstore"], torch.from_numpy(idx)),
                               phase, noise={kk: torch.from_numpy(v) for kk, v in noise.items()})
        label = f"{kind}/{sched}/{warp_case} step {k} phase {phase}"
        for key, v in check_losses(tm, jm2, phase, label).items():
            worst_loss[(phase, key)] = max(worst_loss.get((phase, key), 0.0), v)
        worst_param = max(worst_param, check_params(state, jnew, jg, lr_of, label))
        next_lr = float(jsched(k + 1)) if callable(jsched) else float(jsched)
        assert state.opt_state.scheduler.get_last_lr()[0] == pytest.approx(next_lr, rel=1e-6)
        assert learning_rate_at(k + 1, LR, LR_END, N_STEPS, sched) == pytest.approx(next_lr, rel=1e-6)
        jstate = jnew

        if warp_case is None:
            continue
        progress = (k + 1) / N_STEPS
        jflags = jdet.update(np.asarray(jm2["img_loss_sum"]), np.asarray(jm2["img_loss_cnt"]), progress)
        tflags = tdet.update(tm["img_loss_sum"].numpy(), tm["img_loss_cnt"].numpy(), progress)
        np.testing.assert_array_equal(tflags, jflags, err_msg=label)
        np.testing.assert_allclose(tdet.ema, jdet.ema, rtol=1e-5, err_msg=label)
        emas.append((k + 1, tdet.ema.copy(), tflags.copy()))
        if not (jflags.any() and jdet.budget_left):
            continue
        jstate, jrows = jax_event(world, jdet, jstate, jflags, jscorer, world["wh"], jrng, jwcfg)
        trows = port_event(state, tdet, tflags, tscorer, world["tscene"], world["wh"], trng, twcfg)
        np.testing.assert_array_equal(trows, jrows, err_msg=label)
        events.append((k + 1, jflags.copy(), jrows))
        if jrows.size == 0:
            continue
        jtab = np.asarray(jstate.pose_params["se3"])
        ttab = state.pose_params.se3_refine.weight.detach().numpy()
        np.testing.assert_allclose(ttab[jrows], jtab[jrows], rtol=0, atol=1e-3 * POSE_LR + 1e-6, err_msg=label)
        if warp_case == "reset":
            assert not ttab[jrows].any() and not jtab[jrows].any()
        jmu, jnu, _ = adam_moments(jstate.pose_opt_state)
        tst = state.pose_opt_state.optimizer.state[state.pose_params.se3_refine.weight]
        for got, want in ((tst["exp_avg"], jmu["se3"]), (tst["exp_avg_sq"], jnu["se3"])):
            assert not got[jrows].any() and not np.asarray(want)[jrows].any()
    return events, emas, worst_loss, worst_param


@pytest.mark.parametrize("kind,sched", OPT_CASES)
def test_lockstep_matches_jax(world, kind, sched):
    _, _, worst_loss, worst_param = run_lockstep(world, kind, sched)
    by_phase = {p: max(v for (q, _), v in worst_loss.items() if q == p) for p in (0, 1, 2)}
    LOG.append(f"{kind}/{sched}: worst loss-term rel diff by phase {by_phase}; worst param diff / tol {worst_param:.3f}")
    print(LOG[-1])


@pytest.mark.parametrize("warp_case", ["reset", "multistart"])
def test_lockstep_warp_events_match_jax(world, warp_case):
    events, emas, worst_loss, worst_param = run_lockstep(world, "adam", "ExponentialLR", warp_case)
    assert len(events) == 1, events
    step, flags, rows = events[0]
    assert rows.size >= 1 and step < N_STEPS
    if warp_case == "reset":
        assert rows.tolist() == np.nonzero(flags)[0].tolist()
        after = [(s, float(e[rows].max()), bool(f[rows].any())) for s, e, f in emas if s >= step]
        LOG.append(f"reset at step {step} of rows {rows.tolist()}: the reset rows' max EMA and flag at each check"
                   f" from the event on {after} (ratio {WARP['reset']['ratio']}, cooldown"
                   f" {WARP['reset']['cooldown']})")
    else:
        LOG.append(f"multistart at step {step}: flags {np.nonzero(flags)[0].tolist()}, adopted {rows.tolist()}")
    LOG.append(f"  worst param diff / tol {worst_param:.3f}")
    print("\n".join(LOG[-2:]))
