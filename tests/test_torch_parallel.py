"""The port's data-parallel branches (upnerf_torch.parallel) against the JAX
package's mesh branches and the port's one-rank path, on the CPU: two ranks
spawned by torch.multiprocessing over gloo, one thread each.

The two ranks run every sharded computation once (`_rank_work`); the tests
read what they return:
- the two-rank `batch_step` (teacher-forced: the weights of
  test_torch_train_step.py's JAX init, its batch of 16 and its uniforms),
  phases 0, 1, 2: the loss terms and every metric (img_loss_sum / cnt are
  divided by the mesh's size in both packages) against JAX's
  `make_train_step(..., mesh=make_mesh(2))` at 1e-5 relative, the parameters
  after the update at test_torch_train_step.py's Adam tolerance; against the
  port's one-rank step, the loss at 1e-4 relative and the parameters at 1e-5
  absolute (tests/test_train_step.py's sharding tolerances); the two ranks'
  parameters bit for bit;
- `step_fn`: each rank's indices and uniforms are bit for bit its rows of the
  one-rank draw from the same generator, and its update is the one-rank one
  (1e-5);
- `make_eval_render` and `make_tto_eval` sharded: bit for bit the unsharded
  render that makes calls of as many rays as a rank does (chunk / n: the
  sharded render's calls are that render's, rank by rank), and within 1e-6 of
  each output's max from the unsharded render at the whole chunk (on the CPU
  the BLAS products block by the rows of a call, so the last bit can move:
  146 of 40 x 384 feat_fine values here); the TTO grid also at a chunk that
  does not divide it (padded to whole chunks);
- the TTO step (phases A and B) sharded on B against JAX's value_and_grad of
  the same loss at the same pixels and uniforms: test_torch_tto.py's
  tolerances;
- `fetch`, `put_local_shards`, `all_gather_rows` and `put_replicated`: row
  order and values.
The worker imports no JAX: the JAX side runs in this process only.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.multiprocessing.spawn import ProcessException

from upnerf_torch import parallel
from upnerf_torch.evaluate import tto
from upnerf_torch.models.nerf import NeRFConfig
from upnerf_torch.models.transient import TransientConfig
from upnerf_torch.render.render_rays import RenderConfig
from upnerf_torch.train import (
    LossConfig,
    StepConfig,
    init_params,
    init_pose_params,
    make_eval_render,
    make_optimizer,
    make_ray_store,
    make_scene_constants,
    make_train_state,
    make_train_step,
)
from upnerf_torch.train import step as tstep
from upnerf_torch.utils import weights

NERF = dict(D=4, W=32, skips=(2,), feat_dim=16, xyz_L=4, dir_L=2, appearance_dim=8, candidate_dim=4, c2f=(0.1, 0.5))
T_NET = dict(beta_min=0.1, transient_dim=8, feat_dim=16)
N_IMG, BATCH, MAX_STEPS, LR, POSE_LR = 3, 16, 100, 5e-3, 2e-3
STEP_OF_PHASE = {0: 5, 1: 30, 2: 60}
RANKS = 2
EVAL_CHUNK, EVAL_ROWS = 8, 40  # 5 chunks of 8 pixels: 4 a rank
TTO_CHUNKS = (64, 48)  # the 16 x 16 grid: 4 whole chunks; padded to 6
DRAW_SEED = 21


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def torch_cfg():
    return StepConfig(
        nerf=NeRFConfig(**NERF), transient=TransientConfig(**T_NET),
        render=RenderConfig(N_samples=8, N_importance=8, perturb=1.0, precision="float32"),
        loss=LossConfig(depth_mult=1e-3, alpha_reg=1.0, encode_feat=True, fine=True),
        candidate_schedule=(0.1, 0.5), max_steps=MAX_STEPS, pose_optimize=True, near=0.1, far=5.0, batch_size=BATCH,
    )


def port_state(job, step=0):
    """The train state of `job`'s weights (fresh modules and Adams)."""
    model = init_params(NeRFConfig(**NERF), TransientConfig(**T_NET), N_IMG)
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in job["model"].items()})
    pose = init_pose_params(N_IMG)
    pose.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in job["pose"].items()})
    opt = make_optimizer("adam", LR, LR / 10, MAX_STEPS)
    pose_opt = make_optimizer("adam", POSE_LR, POSE_LR / 10, MAX_STEPS)
    state = make_train_state(model, pose, opt, pose_opt, seed=job["gen_seed"], device="cpu")
    return state._replace(step=step), opt, pose_opt


def port_world(job):
    scene = make_scene_constants(*job["scene"], "cpu", feat_dtype=torch.float32)
    store = make_ray_store(*job["store"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
    noise = {k: torch.from_numpy(v) for k, v in job["noise"].items()}
    return scene, store, batch, noise


def params_np(state):
    out = {k: p.detach().numpy().copy() for k, p in state.params.named_parameters()}
    out.update({k: p.detach().numpy().copy() for k, p in state.pose_params.named_parameters()})
    return out


def tto_world(job):
    """(frozen params, TTOConfig, TTOGroup) of the TTO job."""
    sd, hp, _ = weights.load_reference_ckpt(job["tto_ckpt"])
    frozen, _ = weights.render_params(sd, NeRFConfig.from_hparams(hp), "cpu")
    cfg = tto.TTOConfig(nerf=NeRFConfig.from_hparams(hp),
                        render=RenderConfig.from_hparams(hp)._replace(perturb=1.0, param_grads=False),
                        batch_size=job["tto_B"])
    return frozen, cfg, tto.TTOGroup(*[torch.from_numpy(a) for a in job["tto_group"]])


def tto_trainables(init):
    return {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in init.items()}


def _rank_work(job):
    """Every sharded computation of the tests, in one rank of the group."""
    torch.set_num_threads(1)
    mesh = parallel.make_mesh(0, "cpu")
    assert mesh.size == RANKS and parallel.is_multiprocess()
    cfg = torch_cfg()
    scene, store, batch, noise = port_world(job)
    out = {"rank": mesh.rank, "main": parallel.is_main_process()}

    for phase in (0, 1, 2):  # teacher-forced batch steps
        state, opt, pose_opt = port_state(job, STEP_OF_PHASE[phase])
        _, batch_step = make_train_step(cfg, opt, pose_opt, mesh)
        new, m = batch_step(state, scene, batch, phase, noise=noise)
        parallel.assert_replicated([new.params, new.pose_params], mesh)
        out[f"step{phase}"] = ({k: v.numpy() for k, v in m.items()}, params_np(new), new.step)

    # step_fn: record this rank's indices and uniforms
    seen = {}
    gather, loss_fn = tstep.gather_batch, tstep._loss_and_metrics

    def record_idx(st, idx):
        seen["idx"] = idx.clone()
        return gather(st, idx)

    def record_noise(*args):
        seen["noise"] = {k: v.clone() for k, v in args[5].items()}
        return loss_fn(*args)

    tstep.gather_batch, tstep._loss_and_metrics = record_idx, record_noise
    try:
        state, opt, pose_opt = port_state(job, STEP_OF_PHASE[1])
        step_fn, _ = make_train_step(cfg, opt, pose_opt, mesh)
        new, m = step_fn(state, scene, store, 1)
    finally:
        tstep.gather_batch, tstep._loss_and_metrics = gather, loss_fn
    out["step_fn"] = (seen["idx"].numpy(), {k: v.numpy() for k, v in seen["noise"].items()}, float(m["loss"]),
                      params_np(new))

    state, _, _ = port_state(job)
    ev = {k: torch.from_numpy(v) for k, v in job["eval_batch"].items()}
    render = make_eval_render(cfg, EVAL_CHUNK, mesh)
    out["eval"] = {k: v.numpy() for k, v in render(state.params, state.pose_params, scene, ev, 0.3, 1).items()}

    frozen, tcfg, group = tto_world(job)
    for phase, (pose, x_frac) in {"A": (True, (0.0, 1.0)), "B": (False, (0.0, 0.5))}.items():
        runner = tto.TTORunner(frozen, tcfg, 8, (16, 16), (16, 16), mesh=mesh)
        trainables = tto_trainables(job[f"tto_init{phase}"])
        opt = runner.opt_A(trainables) if pose else runner.opt_B(trainables)
        px, py, tnoise = job[f"tto_draws{phase}"]
        loss = (runner.step_A if pose else runner.step_B)(
            trainables, opt, group, px=torch.from_numpy(px), py=torch.from_numpy(py),
            noise={k: torch.from_numpy(v) for k, v in tnoise.items()})
        out[f"tto{phase}"] = (float(loss), {k: (t.grad.numpy(), t.detach().numpy()) for k, t in trainables.items()})
        for chunk in TTO_CHUNKS:
            ev_fn = tto.make_tto_eval(frozen, tcfg, x_frac=(0.5, 1.0) if phase == "B" else x_frac, chunk=chunk,
                                      mesh=mesh)
            pred, gt = ev_fn(tto_trainables(job["tto_initA"]), group, 16, 16)
            out[f"tto_eval{phase}{chunk}"] = (pred.numpy(), gt.numpy())

    # row order of the collectives
    local = torch.arange(4.0) + 4 * mesh.rank
    out["fetch"] = parallel.fetch(parallel.put_local_shards(local, mesh), mesh)
    chunked = torch.cat([torch.arange(2.0) + c * 4 + 2 * mesh.rank for c in range(3)])
    out["chunked"] = parallel.fetch(chunked, mesh, n_chunks=3)
    out["replicated"] = parallel.fetch(local)
    mine = {"a": torch.full((3,), float(mesh.rank)), "b": torch.nn.Linear(2, 2)}
    with torch.no_grad():
        mine["b"].weight.fill_(mesh.rank + 1.0)
    parallel.put_replicated(mine, mesh)
    out["put_replicated"] = (mine["a"].numpy(), mine["b"].weight.detach().numpy())
    return out


# ---------------------------------------------------------------------------
# the JAX side and the one-rank port, in this process


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from helpers import tiny_scene
    from test_torch_train_step import jax_cfg
    from test_torch_tto import B, HP, draws, group_np
    from upnerf.train import init_params as jinit_params
    from upnerf.train.step import gather_batch as jgather_batch

    torch.set_num_threads(1)
    jcfg = jax_cfg()
    scene, store = tiny_scene(n_img=N_IMG, H=8, W=8, fh=4, fw=4, feat_dim=16, seed=1)
    params = jinit_params(jax.random.PRNGKey(3), jcfg.nerf, jcfg.transient, N_IMG)
    rng = np.random.RandomState(4)
    pose = {"se3": jnp.asarray(rng.randn(N_IMG, 6).astype(np.float32) * 0.02),
            "depth_scale": jnp.asarray(rng.randn(N_IMG, 2).astype(np.float32) * 0.1)}
    idx = rng.choice(store.n_rays, BATCH, replace=False)
    noise = {"coarse": rng.uniform(0.05, 0.95, (BATCH, 8)).astype(np.float32),
             "fine": rng.uniform(0.05, 0.95, (BATCH, 8)).astype(np.float32)}
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    model, tpose = weights.train_modules_from_jax(to_np(params), to_np(pose), NeRFConfig(**NERF),
                                                  TransientConfig(**T_NET), N_IMG)
    store_np = tuple(np.asarray(a) for a in store)
    tstore = make_ray_store(*store_np, device="cpu")
    batch = {k: v.numpy() for k, v in tstep.gather_batch(tstore, torch.from_numpy(idx)).items()}
    eval_idx = rng.choice(store.n_rays, EVAL_ROWS, replace=False)
    eval_batch = {k: np.asarray(store_np[i][eval_idx]).astype(np.float32) for i, k in ((0, "px"), (1, "py"),
                                                                                      (4, "inv_depth"))}
    eval_batch["img_idx"] = store_np[2][eval_idx].astype(np.int64)

    tto_ckpt = str(tmp_path_factory.mktemp("parallel") / "tiny.ckpt")
    weights.init_reference_ckpt(tto_ckpt, HP, n_images=3, seed=7)
    trng = np.random.RandomState(12)
    tto_init = {"fine_a": trng.randn(2, HP["nerf.appearance_dim"]).astype(np.float32),
                "se3": (trng.randn(2, 6) * 0.01).astype(np.float32)}
    job = {
        "model": {k: v.detach().numpy() for k, v in model.state_dict().items()},
        "pose": {k: v.detach().numpy() for k, v in tpose.state_dict().items()},
        "gen_seed": DRAW_SEED,
        "scene": tuple(np.asarray(a) for a in (scene.Ks, scene.poses, scene.near_far, scene.wh, scene.feat_maps)),
        "store": store_np, "batch": batch, "noise": noise, "eval_batch": eval_batch,
        "tto_ckpt": tto_ckpt, "tto_B": B, "tto_group": group_np(),
        "tto_initA": tto_init, "tto_initB": {"fine_a": tto_init["fine_a"]},
        "tto_drawsA": draws(11, (0.0, 1.0)), "tto_drawsB": draws(11, (0.0, 0.5)),
    }
    job["jax"] = dict(scene=scene, params=params, pose=pose, jbatch=jgather_batch(store, jnp.asarray(idx)))
    return job


class _Ranks:
    """What each of the two ranks computed, read by index or iteration. The
    launch runs in a thread from the fixture's setup, so this process's JAX
    side compiles meanwhile; the first read waits for it."""

    def __init__(self, work):
        self._pool = ThreadPoolExecutor(1)
        self._future = self._pool.submit(parallel.launch, _rank_work, (work,), n_local=RANKS, device="cpu")

    def _out(self):
        out = self._future.result()
        assert [o["rank"] for o in out] == [0, 1] and [o["main"] for o in out] == [True, False]
        return out

    def __getitem__(self, i):
        return self._out()[i]

    def __iter__(self):
        return iter(self._out())

    def close(self):
        self._pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(job):
    out = _Ranks({k: v for k, v in job.items() if k != "jax"})
    yield out
    out.close()


def one_rank_step(job, phase):
    scene, _, batch, noise = port_world(job)
    state, opt, pose_opt = port_state(job, STEP_OF_PHASE[phase])
    _, batch_step = make_train_step(torch_cfg(), opt, pose_opt)
    new, m = batch_step(state, scene, batch, phase, noise=noise)
    return {k: v.numpy() for k, v in m.items()}, params_np(new)


def jax_mesh_step(job, phase):
    """JAX's batch step over a 2-device mesh, and its full-batch gradients."""
    import jax
    import jax.numpy as jnp

    from test_torch_train_step import jax_cfg, jax_grads
    from upnerf.parallel import make_mesh as jmake_mesh
    from upnerf.train import TrainState as JTrainState
    from upnerf.train import make_optimizer as jmake_optimizer
    from upnerf.train import make_train_step as jmake_train_step

    w = dict(job["jax"], noise=job["noise"])
    jopt = jmake_optimizer("adam", LR, LR / 10, MAX_STEPS)
    jpose_opt = jmake_optimizer("adam", POSE_LR, POSE_LR / 10, MAX_STEPS)
    jstate = JTrainState(step=jnp.asarray(STEP_OF_PHASE[phase], jnp.int32), params=w["params"],
                         pose_params=w["pose"], opt_state=jopt.init(w["params"]),
                         pose_opt_state=jpose_opt.init(w["pose"]),
                         rng=jax.random.key_data(jax.random.key(0, impl="rbg")))
    _, jbatch_step = jmake_train_step(jax_cfg(), jopt, jpose_opt, mesh=jmake_mesh(RANKS))
    jnew, jm = jbatch_step(jstate, w["scene"], w["jbatch"], phase, noise={k: jnp.asarray(v) for k, v in
                                                                         w["noise"].items()})
    want = weights.state_dict_from_jax(jax.tree.map(np.asarray, jnew.params),
                                       jax.tree.map(np.asarray, jnew.pose_params), 0.0)
    _, jg = jax_grads(w, phase)
    return {k: np.asarray(v) for k, v in jm.items()}, want, jg


# ---------------------------------------------------------------------------
# the train step


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_two_rank_batch_step_matches_jax_mesh_step(job, ranks, phase):
    from test_torch_train_step import grad_tol

    jm, want, jg = jax_mesh_step(job, phase)  # before the ranks' result: it compiles while they run
    tm, tparams, tstep_count = ranks[0][f"step{phase}"]
    assert tstep_count == STEP_OF_PHASE[phase] + 1
    assert set(tm) == set(jm)
    for k in tm:
        if k == "img_loss_cnt":  # pmean'd counts: BATCH / RANKS rays a rank, summed and halved
            np.testing.assert_array_equal(tm[k], jm[k])
        else:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-9, err_msg=k)
    assert np.isclose(tm["img_loss_cnt"].sum(), BATCH / RANKS)
    for k, p in tparams.items():
        g = jg[k].numpy()
        gmax = max(float(np.abs(g).max()), 1e-30)
        mask = np.abs(g) > 1e-6 * gmax
        lr = POSE_LR if k in ("se3_refine.weight", "depth_scale.weight") else LR
        tol = 1e-3 * lr + 1e-6 + lr * grad_tol(k) * gmax / (np.abs(g) + 1e-8)
        diff = np.abs(p - want[k].numpy())
        assert (diff[mask] <= tol[mask]).all(), (k, float((diff - tol)[mask].max()))


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_two_rank_batch_step_matches_one_rank_step(job, ranks, phase):
    tm, tparams, _ = ranks[0][f"step{phase}"]
    om, oparams = one_rank_step(job, phase)
    np.testing.assert_allclose(tm["loss"], om["loss"], rtol=1e-4)
    np.testing.assert_allclose(tm["img_loss_sum"] * RANKS, om["img_loss_sum"], rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(tm["img_loss_cnt"] * RANKS, om["img_loss_cnt"])
    for k, p in tparams.items():
        np.testing.assert_allclose(p, oparams[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_ranks_hold_the_same_bits(ranks, phase):
    (m0, p0, _), (m1, p1, _) = ranks[0][f"step{phase}"], ranks[1][f"step{phase}"]
    for k in m0:
        np.testing.assert_array_equal(m0[k], m1[k], err_msg=k)
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


def test_step_fn_draws_its_rows_of_the_one_rank_draw(job, ranks):
    n_rays = len(job["store"][0])
    gen = torch.Generator().manual_seed(DRAW_SEED)
    idx = torch.randint(0, n_rays, (BATCH,), generator=gen).numpy()
    noise = {"coarse": torch.rand((BATCH, 8), generator=gen).numpy(), "fine": torch.rand((BATCH, 8), generator=gen)
             .numpy()}
    m = BATCH // RANKS
    for r, out in enumerate(ranks):
        got_idx, got_noise, _, _ = out["step_fn"]
        np.testing.assert_array_equal(got_idx, idx[r * m:(r + 1) * m])
        for k, v in noise.items():
            np.testing.assert_array_equal(got_noise[k], v[r * m:(r + 1) * m], err_msg=k)
    scene, store, _, _ = port_world(job)
    state, opt, pose_opt = port_state(job, STEP_OF_PHASE[1])
    new, om = make_train_step(torch_cfg(), opt, pose_opt)[0](state, scene, store, 1)
    _, _, loss, tparams = ranks[0]["step_fn"]
    np.testing.assert_allclose(loss, float(om["loss"]), rtol=1e-4)
    for k, v in params_np(new).items():
        np.testing.assert_allclose(tparams[k], v, rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(ranks[1]["step_fn"][3][k], tparams[k], err_msg=k)


# ---------------------------------------------------------------------------
# renders: sharded against unsharded, bit for bit


def assert_rounding_close(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-6, err_msg=name)


def test_eval_render_sharded_is_the_unsharded_render(job, ranks):
    scene, _, _, _ = port_world(job)
    state, _, _ = port_state(job)
    ev = {k: torch.from_numpy(v) for k, v in job["eval_batch"].items()}
    render = lambda chunk: make_eval_render(torch_cfg(), chunk)(  # noqa: E731
        state.params, state.pose_params, scene, ev, 0.3, 1)
    same_calls, whole = render(EVAL_CHUNK // RANKS), render(EVAL_CHUNK)
    for out in ranks:
        assert set(out["eval"]) == set(whole)
        for k in whole:
            np.testing.assert_array_equal(out["eval"][k], same_calls[k].numpy(), err_msg=k)
            assert_rounding_close(out["eval"][k], whole[k].numpy(), k)


@pytest.mark.parametrize("phase", ["A", "B"])
def test_tto_eval_sharded_is_the_unsharded_render(job, ranks, phase):
    frozen, tcfg, group = tto_world(job)
    x_frac = (0.0, 1.0) if phase == "A" else (0.5, 1.0)

    def render(chunk):
        pred, gt = tto.make_tto_eval(frozen, tcfg, x_frac=x_frac, chunk=chunk)(
            tto_trainables(job["tto_initA"]), group, 16, 16)
        return pred.detach().numpy(), gt.numpy()

    whole, padded = TTO_CHUNKS
    same_calls = render(whole // RANKS)
    for out in ranks:
        for got, want, unsharded in zip(out[f"tto_eval{phase}{whole}"], same_calls, render(whole)):
            np.testing.assert_array_equal(got, want)
            assert_rounding_close(got, unsharded, "whole chunks")
        for got, want in zip(out[f"tto_eval{phase}{padded}"], render(padded)):
            assert_rounding_close(got, want, "padded chunks")


# ---------------------------------------------------------------------------
# TTO


@pytest.mark.parametrize("phase", ["A", "B"])
def test_two_rank_tto_step_matches_jax(job, ranks, phase):
    import jax
    import jax.numpy as jnp
    import optax

    from test_torch_tto import HP, assert_leaf_close, configs, groups
    from test_torch_tto import G as TG
    from upnerf.evaluate import tto as jtto
    from upnerf.utils.ref_ckpt import convert_state_dict

    pose = phase == "A"
    _, jcfg = configs()
    _, jgroup = groups()
    sd, _, _ = weights.load_reference_ckpt(job["tto_ckpt"])
    jparams, _, _ = convert_state_dict(sd)
    jparams = jax.tree.map(jnp.asarray, {k: jparams[k] for k in ("nerf_coarse", "nerf_fine", "embeddings")})
    init = job[f"tto_init{phase}"]
    px, py, noise = job[f"tto_draws{phase}"]
    flat = {k: jnp.asarray(v.reshape(-1, v.shape[-1])) for k, v in noise.items()}

    def loss_fn(tr):
        se3_delta = tr["se3"] if pose else jnp.zeros((TG, 6))
        pred, gt = jtto._render_group_rays(jparams, tr["fine_a"], se3_delta, jcfg, jgroup, jnp.asarray(px),
                                           jnp.asarray(py), None, det=False, noise=flat)
        return ((pred - gt) ** 2).mean()

    jtrain = {k: jnp.asarray(v) for k, v in init.items()}
    jloss, jgrads = jax.value_and_grad(loss_fn)(jtrain)
    jrunner = jtto.TTORunner(jparams, jcfg, HP["nerf.appearance_dim"], (16, 16), (16, 16))
    jopt = jrunner.opt_A if pose else jrunner.opt_B
    updates, _ = jopt.update(jgrads, jopt.init(jtrain), jtrain)
    jnew = optax.apply_updates(jtrain, updates)
    for out in ranks:
        loss, got = out[f"tto{phase}"]
        assert set(got) == set(init)
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        for k, (grad, value) in got.items():
            assert_leaf_close(grad, jgrads[k], 1e-4, k)
            np.testing.assert_allclose(value, np.asarray(jnew[k]), rtol=0, atol=1e-6, err_msg=k)
    for k in init:
        np.testing.assert_array_equal(ranks[0][f"tto{phase}"][1][k][1], ranks[1][f"tto{phase}"][1][k][1])


# ---------------------------------------------------------------------------
# the collectives' row order, and the mesh without a group


def test_fetch_and_local_shards_keep_row_order(ranks):
    for out in ranks:
        np.testing.assert_array_equal(out["fetch"], np.arange(8.0))
        np.testing.assert_array_equal(out["chunked"], np.arange(12.0))
        a, w = out["put_replicated"]
        np.testing.assert_array_equal(a, np.zeros(3))
        np.testing.assert_array_equal(w, np.ones((2, 2)))
    np.testing.assert_array_equal(ranks[1]["replicated"], np.arange(4.0) + 4)  # a plain copy: nothing gathered


def test_mesh_without_a_group():
    mesh = parallel.make_mesh(0, "cpu")
    assert mesh == parallel.DataMesh(0, 1, torch.device("cpu"), None) and not parallel.is_multiprocess()
    assert parallel.is_main_process()
    assert parallel.local_ranks(0, "cpu") == 1 and parallel.local_ranks(3, "cpu") == 3
    with pytest.raises(RuntimeError, match="no process group"):
        parallel.make_mesh(2, "cpu")
    x = torch.arange(6.0).reshape(3, 2)
    assert parallel.shard_batch(mesh, x) is x
    np.testing.assert_array_equal(parallel.fetch({"x": x})["x"], x.numpy())
    assert parallel.all_reduce_mean([x], mesh)[0] is x
    two = parallel.DataMesh(1, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_batch(two, x)
    np.testing.assert_array_equal(parallel.shard_batch(two, torch.arange(8.0).reshape(2, 4), axis=1).numpy(),
                                  [[2.0, 3.0], [6.0, 7.0]])
    with pytest.raises(ValueError, match="go together"):
        parallel.initialize("127.0.0.1:1", num_processes=2)


def test_a_rank_that_fails_fails_the_launch():
    """Rank 1 raises; rank 0, waiting in a barrier, is ended (gloo resets its
    connection, or the launcher terminates it), and the launch raises."""
    with pytest.raises(ProcessException):
        parallel.launch(_fail_on_rank_1, (), n_local=RANKS, device="cpu")
    assert not torch.distributed.is_initialized()


def _fail_on_rank_1():
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    parallel.sync()
    return os.getpid()
