"""The port's train step (upnerf_torch.train) against the JAX package's
(upnerf.train.step), teacher-forced: the same parameters (moved by the
weight bridge), the same ray batch and the same pre-drawn uniforms.

At D=4, W=32, skip 2, F=16, L=4, 8 + 8 samples, batch 16, float32, one step
in each schedule phase (0: progress 0.05, 1: 0.3, 2: 0.6):
- every loss term: 1e-5 relative;
- the gradient of every parameter and pose table against
  jax.value_and_grad(upnerf.train.step._loss_and_metrics): 1e-4 of the
  leaf's max |g|; 1e-3 for the one-element sigma biases (share_sigma.0.bias
  sums the sigma cotangents of all samples, which nearly cancel on an opaque
  ray: in phase 2 it is 1e-5 where its weight's entries reach 1e-4, and
  torch autograd through the same forward differs from the JAX package there
  by 2.5e-4 of its value). The JAX side runs its XLA path, and in phase 1
  also the fused Pallas kernels in the interpreter;
- the parameters and pose tables after one batch_step (Adam, lr 5e-3 /
  2e-3), where |g| > 1e-6 max|g| of the leaf: Adam's first step moves each
  entry by lr g / (|g| + eps), whose sensitivity to g is at most
  lr / (|g| + eps), so the tolerance is 1e-3 lr + 1e-6 plus lr times the
  gradient tolerance (1e-4 max|g|, as above) over |g| + eps.
Also: the se3 gradient at the zero table is finite, the depth-prior clamps
pass no gradient on the clamped side, the LR schedule matches optax's, and a
checkpoint exported after a few CPU steps renders through render_video.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from upnerf.models import NeRFConfig as JNeRFConfig
from upnerf.models import TransientConfig as JTransientConfig
from upnerf.ops import pallas_render_train as jrt
from upnerf.render import RenderConfig as JRenderConfig
from upnerf.train import LossConfig as JLossConfig
from upnerf.train import StepConfig as JStepConfig
from upnerf.train import TrainState as JTrainState
from upnerf.train import init_params as jinit_params
from upnerf.train import make_optimizer as jmake_optimizer
from upnerf.train import make_train_step as jmake_train_step
from upnerf.train.step import _loss_and_metrics as jloss_and_metrics
from upnerf.train.step import gather_batch as jgather_batch
from upnerf_torch.cli import render_video
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
    pe_progress,
    schedule_mult,
)
from upnerf_torch.train import step as tstep
from upnerf_torch.utils import weights

from helpers import tiny_scene

NERF = dict(D=4, W=32, skips=(2,), feat_dim=16, xyz_L=4, dir_L=2, appearance_dim=8, candidate_dim=4, c2f=(0.1, 0.5))
T_NET = dict(beta_min=0.1, transient_dim=8, feat_dim=16)
N_IMG, BATCH, MAX_STEPS, LR, POSE_LR = 3, 16, 100, 5e-3, 2e-3
STEP_OF_PHASE = {0: 5, 1: 30, 2: 60}


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
        loss=JLossConfig(depth_mult=1e-3, alpha_reg=1.0, encode_feat=True, fine=True),
        candidate_schedule=(0.1, 0.5), max_steps=MAX_STEPS, pose_optimize=True, near=0.1, far=5.0, batch_size=BATCH,
    )


def torch_cfg():
    return StepConfig(
        nerf=NeRFConfig(**NERF), transient=TransientConfig(**T_NET),
        render=RenderConfig(N_samples=8, N_importance=8, perturb=1.0, precision="float32"),
        loss=LossConfig(depth_mult=1e-3, alpha_reg=1.0, encode_feat=True, fine=True),
        candidate_schedule=(0.1, 0.5), max_steps=MAX_STEPS, pose_optimize=True, near=0.1, far=5.0, batch_size=BATCH,
    )


@pytest.fixture(scope="module")
def world():
    """Both frameworks' scene, store, batch, uniforms and initial params.
    The pose tables start non-zero (small) so that every pose gradient path
    is live."""
    torch.set_num_threads(1)
    jcfg = jax_cfg()
    scene, store = tiny_scene(n_img=N_IMG, H=8, W=8, fh=4, fw=4, feat_dim=16, seed=1)
    params = jinit_params(jax.random.PRNGKey(3), jcfg.nerf, jcfg.transient, N_IMG)
    rng = np.random.RandomState(4)
    pose = {"se3": jnp.asarray(rng.randn(N_IMG, 6).astype(np.float32) * 0.02),
            "depth_scale": jnp.asarray(rng.randn(N_IMG, 2).astype(np.float32) * 0.1)}
    idx = rng.choice(store.n_rays, BATCH, replace=False)
    jbatch = jgather_batch(store, jnp.asarray(idx))
    noise = {"coarse": rng.uniform(0.05, 0.95, (BATCH, 8)).astype(np.float32),
             "fine": rng.uniform(0.05, 0.95, (BATCH, 8)).astype(np.float32)}
    tscene = make_scene_constants(np.asarray(scene.Ks), np.asarray(scene.poses), np.asarray(scene.near_far),
                                  np.asarray(scene.wh), np.asarray(scene.feat_maps), "cpu", feat_dtype=torch.float32)
    tstore = make_ray_store(*(np.asarray(a) for a in store), device="cpu")
    tbatch = tstep.gather_batch(tstore, torch.from_numpy(idx))
    return dict(scene=scene, store=store, params=params, pose=pose, jbatch=jbatch, noise=noise, tscene=tscene,
                tstore=tstore, tbatch=tbatch)


def port_state(w):
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    model, pose = weights.train_modules_from_jax(to_np(w["params"]), to_np(w["pose"]), NeRFConfig(**NERF),
                                                 TransientConfig(**T_NET), N_IMG)
    opt = make_optimizer("adam", LR, LR / 10, MAX_STEPS)
    pose_opt = make_optimizer("adam", POSE_LR, POSE_LR / 10, MAX_STEPS)
    return make_train_state(model, pose, opt, pose_opt, seed=0, device="cpu"), opt, pose_opt


def jax_grads(w, phase, fused=False, depth_scale_reg=0.0):
    jcfg = jax_cfg()
    jcfg = jcfg._replace(loss=jcfg.loss._replace(depth_scale_reg=depth_scale_reg))
    if fused:
        jcfg = jcfg._replace(render=jcfg.render._replace(fused_train=True))
    progress = jnp.asarray(STEP_OF_PHASE[phase], jnp.int32).astype(jnp.float32) / MAX_STEPS
    from upnerf.train.schedules import schedule_mult as jsched

    sched = jsched(progress, jcfg.candidate_schedule)
    noise = {k: jnp.asarray(v) for k, v in w["noise"].items()}

    def f(p, pp):
        return jloss_and_metrics(p, pp, jcfg, w["scene"], w["jbatch"], noise, phase, sched, progress)

    (loss, metrics), (g, pg) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(w["params"], w["pose"])
    return metrics, weights.state_dict_from_jax(jax.tree.map(np.asarray, g), jax.tree.map(np.asarray, pg), 0.0)


def port_grads(w, phase, depth_scale_reg=0.0):
    state, _, _ = port_state(w)
    cfg = torch_cfg()
    cfg = cfg._replace(loss=cfg.loss._replace(depth_scale_reg=depth_scale_reg))
    progress = pe_progress(STEP_OF_PHASE[phase], MAX_STEPS)
    sched = schedule_mult(progress, cfg.candidate_schedule)
    noise = {k: torch.from_numpy(v) for k, v in w["noise"].items()}
    loss, metrics = tstep._loss_and_metrics(state.params, state.pose_params, cfg, w["tscene"], w["tbatch"], noise,
                                            phase, sched, progress)
    loss.backward()
    grads = {k: p.grad for k, p in state.params.named_parameters() if p.requires_grad}
    grads.update({k: p.grad for k, p in state.pose_params.named_parameters()})
    return metrics, grads


def grad_tol(k):
    return 1e-3 if k.endswith("share_sigma.0.bias") else 1e-4


def check_grads(got, want):
    assert set(got) <= set(want)
    for k, g in got.items():
        wv = want[k].numpy()
        gv = np.zeros_like(wv) if g is None else g.detach().numpy()
        scale = max(float(np.abs(wv).max()), 1e-12)
        if not np.any(wv):  # a leaf the phase does not reach
            assert not np.any(gv), k
            continue
        np.testing.assert_allclose(gv / scale, wv / scale, rtol=0, atol=grad_tol(k), err_msg=k)


def check_losses(got, want):
    keys = [k for k in want if k.startswith("loss")]
    assert set(keys) == {k for k in got if k.startswith("loss")}
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_loss_and_grads_match_jax(world, phase):
    jm, jg = jax_grads(world, phase)
    tm, tg = port_grads(world, phase)
    check_losses(tm, jm)
    check_grads(tg, jg)
    np.testing.assert_allclose(tm["img_loss_sum"].numpy(), np.asarray(jm["img_loss_sum"]), rtol=1e-5)
    np.testing.assert_array_equal(tm["img_loss_cnt"].numpy(), np.asarray(jm["img_loss_cnt"]))


def test_depth_scale_regulariser_matches_jax(world):
    """The opt-in variance penalty on the log depth scales (off by default)."""
    jm, jg = jax_grads(world, 1, depth_scale_reg=2.0)
    tm, tg = port_grads(world, 1, depth_scale_reg=2.0)
    assert "loss/l_dscale_reg" in tm
    check_losses(tm, jm)
    check_grads({"depth_scale.weight": tg["depth_scale.weight"]}, jg)


def test_phase1_matches_jax_fused_kernels(world, monkeypatch):
    """The JAX side through its fused Pallas kernels (interpreter)."""
    monkeypatch.setattr(jrt, "INTERPRET", True)
    jm, jg = jax_grads(world, 1, fused=True)
    tm, tg = port_grads(world, 1)
    check_losses(tm, jm)
    check_grads(tg, jg)


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_batch_step_updates_match_jax(world, phase):
    jcfg = jax_cfg()
    jopt = jmake_optimizer("adam", LR, LR / 10, MAX_STEPS)
    jpose_opt = jmake_optimizer("adam", POSE_LR, POSE_LR / 10, MAX_STEPS)
    jstate = JTrainState(step=jnp.asarray(STEP_OF_PHASE[phase], jnp.int32), params=world["params"],
                         pose_params=world["pose"], opt_state=jopt.init(world["params"]),
                         pose_opt_state=jpose_opt.init(world["pose"]),
                         rng=jax.random.key_data(jax.random.key(0, impl="rbg")))
    _, jbatch_step = jmake_train_step(jcfg, jopt, jpose_opt)
    noise = {k: jnp.asarray(v) for k, v in world["noise"].items()}
    jnew, jm = jbatch_step(jstate, world["scene"], world["jbatch"], phase, noise=noise)
    want = weights.state_dict_from_jax(jax.tree.map(np.asarray, jnew.params),
                                       jax.tree.map(np.asarray, jnew.pose_params), 0.0)
    _, jg = jax_grads(world, phase)

    state, opt, pose_opt = port_state(world)
    state = state._replace(step=STEP_OF_PHASE[phase])
    _, batch_step = make_train_step(torch_cfg(), opt, pose_opt)
    new, tm = batch_step(state, world["tscene"], world["tbatch"], phase,
                         noise={k: torch.from_numpy(v) for k, v in world["noise"].items()})
    assert new.step == STEP_OF_PHASE[phase] + 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]), rtol=1e-5)
    got = dict(new.params.named_parameters())
    got.update(dict(new.pose_params.named_parameters()))
    for k, p in got.items():
        if not p.requires_grad:
            continue
        g = jg[k].numpy()
        gmax = max(float(np.abs(g).max()), 1e-30)
        mask = np.abs(g) > 1e-6 * gmax
        lr = POSE_LR if k in ("se3_refine.weight", "depth_scale.weight") else LR
        tol = 1e-3 * lr + 1e-6 + lr * grad_tol(k) * gmax / (np.abs(g) + 1e-8)
        diff = np.abs(p.detach().numpy() - want[k].numpy())
        assert (diff[mask] <= tol[mask]).all(), (k, float((diff - tol)[mask].max()))


def test_lr_schedule_matches_optax():
    sched = optax.exponential_decay(init_value=LR, transition_steps=1, decay_rate=(0.1) ** (1.0 / MAX_STEPS))
    p = torch.nn.Parameter(torch.zeros(2))
    st = make_optimizer("adam", LR, LR / 10, MAX_STEPS).init([p])
    for t in range(5):
        assert st.optimizer.param_groups[0]["lr"] == pytest.approx(float(sched(t)), rel=1e-6)
        p.grad = torch.ones(2)
        st.step()


def test_se3_grad_finite_at_zero_and_depth_clamps(world):
    state, _, _ = port_state(world)
    with torch.no_grad():
        state.pose_params.se3_refine.weight.zero_()
    rays = tstep.build_rays(state.pose_params, world["tscene"], world["tbatch"], True)
    rays[:, :6].sum().backward()
    g = state.pose_params.se3_refine.weight.grad
    assert torch.isfinite(g).all() and g.abs().max() > 0
    # depth prior: clamped entries pass no gradient
    batch = dict(world["tbatch"])
    batch["inv_depth"] = torch.cat([torch.full((4,), -1.0), torch.full((4,), 100.0), batch["inv_depth"][8:]])
    with torch.no_grad():
        state.pose_params.depth_scale.weight.zero_()
    dep = tstep.depth_prior(state.pose_params, batch, 0.1, 5.0)
    assert torch.allclose(dep[:4], torch.full((4,), 5.0)) and torch.allclose(dep[4:8], torch.full((4,), 0.1))
    state.pose_params.depth_scale.weight.grad = None
    dep[:8].sum().backward()
    assert not state.pose_params.depth_scale.weight.grad.any()


def test_exported_checkpoint_renders_through_render_video(world, tmp_path):
    """A few CPU steps of `step`, the state exported in the reference
    layout, and rendered by the serving CLI."""
    state, opt, pose_opt = port_state(world)
    cfg = torch_cfg()
    step, _ = make_train_step(cfg, opt, pose_opt)
    se3_0 = state.pose_params.se3_refine.weight.detach().clone()
    for phase in (0, 1, 2):
        state, m = step(state, world["tscene"], world["tstore"], phase)
        assert torch.isfinite(m["loss"])
    assert state.step == 3
    assert not torch.equal(state.pose_params.se3_refine.weight.detach(), se3_0)
    hp = {"nerf.D": 4, "nerf.W": 32, "nerf.skips": (2,), "nerf.N_emb_xyz": 4, "nerf.N_emb_dir": 2,
          "nerf.feat_dim": 16, "nerf.appearance_dim": 8, "nerf.candidate_dim": 4, "pose.c2f": (0.1, 0.5),
          "nerf.N_samples": 8, "nerf.N_importance": 8, "nerf.near": 0.1, "nerf.far": 5.0, "nerf.use_disp": False,
          "nerf.perturb": 1.0, "val.chunk_size": 32, "tpu.matmul_precision": "float32", "t_net.beta_min": 0.1,
          "t_net.transient_dim": 8, "t_net.feat_dim": 16}
    path = weights.export_reference_ckpt(str(tmp_path / "trained.ckpt"), state.params, state.pose_params, hp,
                                         state.step, pe_progress(state.step, MAX_STEPS))
    sd, hparams, gstep = weights.load_reference_ckpt(path)
    assert gstep == 3 and hparams == hp
    assert torch.equal(sd["se3_refine.weight"], state.pose_params.se3_refine.weight.detach())
    out = render_video.main(["--ckpt", path, "--out", str(tmp_path / "v"), "--frames", "1", "--wh", "8", "4",
                             "--focal", "6", "--device", "cpu"])
    depth = np.load(out["depths"][0])
    assert depth.shape == (4, 8) and np.isfinite(depth).all()
    assert os.path.getsize(out["frames"][0]) > 0
