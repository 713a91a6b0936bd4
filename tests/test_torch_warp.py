"""The port's pose-warp mitigations (upnerf_torch.train.warp and the
Trainer's adoption step) against the JAX package's (upnerf.train.warp,
upnerf.train.loop), on the CPU at a tiny width (D=2, W=32, F=8, 8 + 4
samples, float32):
- `propose_candidates` bit for bit from the same RandomState;
- the detector's cooldown and event budget, flag for flag;
- `reset_opt_rows` on an optimizer state carried across from optax
  (`utils.weights.optimizer_state_from_jax`) after 3 updates: the same
  moments as JAX's result, adopted rows exactly zero, step counts untouched;
- the candidate scorer against `upnerf.train.warp.make_pose_scorer`: 1e-4
  relative, in both `tpu.fused_train` routes; all candidates in one render
  against a call per candidate: 1e-6 relative; the true pose ranks first
  on a feature map that is the model's own render from the base pose (its
  score is ~1e-16, f32 rounding of an exact match, so every score is also
  allowed that share of the largest);
- `run_multistart` adopting the same rows and the same table as JAX's;
- the Trainer with the hair-trigger detector of tests/test_warp.py (every
  check flags, one event allowed), multistart and reset: one event, the
  budget spent, finite losses after it, the adopted rows' moments exactly zero
  right after it, and with reset the flagged se3 rows exactly zero at the
  event; `multistart` on the feature-less field warns and falls back to
  `none`.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from upnerf.models import NeRFConfig as JNeRFConfig
from upnerf.models import TransientConfig as JTransientConfig
from upnerf.render import RenderConfig as JRenderConfig
from upnerf.train import LossConfig as JLossConfig
from upnerf.train import StepConfig as JStepConfig
from upnerf.train import init_params as jinit_params
from upnerf.train import warp as jwarp
from upnerf.train.optim import make_optimizer as jmake_optimizer
from upnerf_torch.models.nerf import NeRFConfig
from upnerf_torch.models.transient import TransientConfig
from upnerf_torch.render.render_rays import RenderConfig
from upnerf_torch.train import LossConfig, StepConfig, make_optimizer, make_scene_constants, warp
from upnerf_torch.utils import weights

from helpers import tiny_scene

NERF = dict(D=2, W=32, skips=(1,), feat_dim=8, xyz_L=4, dir_L=2, appearance_dim=8, candidate_dim=4, c2f=(0.1, 0.5))
T_NET = dict(beta_min=0.1, transient_dim=8, feat_dim=8)
N_IMG, HW, SCORE_PROGRESS, N_RAYS = 3, 16, 0.5, 64
WARPED = np.array([0.3, 0.2, -0.3, 0.1, -0.1, 0.2], np.float32)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cfg():
    return JStepConfig(
        nerf=JNeRFConfig(**NERF, fused_trunk=False), transient=JTransientConfig(**T_NET),
        render=JRenderConfig(N_samples=8, N_importance=4, perturb=1.0, encode_feat=True, precision="float32"),
        loss=JLossConfig(encode_feat=True, fine=True), candidate_schedule=(0.1, 0.5), max_steps=100,
        pose_optimize=True, near=0.1, far=5.0, batch_size=64,
    )


def torch_cfg(fused_train=True):
    return StepConfig(
        nerf=NeRFConfig(**NERF), transient=TransientConfig(**T_NET),
        render=RenderConfig(N_samples=8, N_importance=4, perturb=1.0, precision="float32", fused_train=fused_train),
        loss=LossConfig(encode_feat=True, fine=True), candidate_schedule=(0.1, 0.5), max_steps=100,
        pose_optimize=True, near=0.1, far=5.0, batch_size=64,
    )


def own_feature_map(cfg, scene, params, img_i):
    """Image img_i's feature map replaced by the model's own render from its
    base pose at every pixel: the base pose is then the scorer's optimum."""
    from upnerf.geometry import rays as ray_utils
    from upnerf.render import render_rays

    jj, ii = np.meshgrid(np.arange(HW), np.arange(HW), indexing="ij")
    px, py = jnp.asarray(ii.ravel(), jnp.float32), jnp.asarray(jj.ravel(), jnp.float32)
    B = HW * HW
    dirs = ray_utils.pixel_directions(px, py, scene.Ks[img_i])
    rays_o, rays_d = ray_utils.get_rays(dirs, jnp.broadcast_to(scene.poses[img_i], (B, 3, 4)))
    rays = jnp.concatenate([rays_o, rays_d, jnp.broadcast_to(scene.near_far[img_i], (B, 2))], -1)
    rp = {"nerf_coarse": params["nerf_coarse"], "nerf_fine": params["nerf_fine"], "embeddings": params["embeddings"]}
    out = render_rays(rp, cfg.render._replace(perturb=0.0), cfg.nerf, rays, jnp.full((B,), img_i, jnp.int32),
                      key=None, phase=0, sched_mult=jnp.asarray(0.0),
                      progress=jnp.asarray(SCORE_PROGRESS, jnp.float32), det=True)
    maps = np.array(scene.feat_maps, np.float32)
    maps[img_i] = np.asarray(out["feat_fine"]).reshape(HW, HW, -1)
    return scene._replace(feat_maps=jnp.asarray(maps))


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    cfg = jax_cfg()
    scene, _ = tiny_scene(n_img=N_IMG, H=HW, W=HW, fh=HW, fw=HW, feat_dim=8, seed=2)
    params = jinit_params(jax.random.PRNGKey(5), cfg.nerf, cfg.transient, N_IMG)
    scene = own_feature_map(cfg, scene, params, 0)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    pose = {"se3": np.zeros((N_IMG, 6), np.float32), "depth_scale": np.zeros((N_IMG, 2), np.float32)}
    model, _ = weights.train_modules_from_jax(to_np(params), pose, NeRFConfig(**NERF), TransientConfig(**T_NET),
                                              N_IMG)
    tscene = make_scene_constants(*(np.asarray(a) for a in (scene.Ks, scene.poses, scene.near_far, scene.wh,
                                                             scene.feat_maps)), "cpu", feat_dtype=torch.float32)
    return dict(cfg=cfg, scene=scene, params=params, model=model, tscene=tscene)


@pytest.mark.parametrize("kicks", [1, 2, 6, 8, 9])
def test_propose_candidates_bit_equal(kicks):
    cfg = warp.WarpConfig(kicks=kicks, kick_sigma_rot=0.05, kick_sigma_t=0.2)
    cur = np.random.RandomState(kicks).randn(6).astype(np.float32)
    got = warp.propose_candidates(cur, cfg, np.random.RandomState(11))
    want = jwarp.propose_candidates(cur, jwarp.WarpConfig(**cfg._asdict()), np.random.RandomState(11))
    assert got.dtype == want.dtype == np.float32 and got.shape == (kicks + 2, 6)
    np.testing.assert_array_equal(got, want)


def test_cooldown_and_budget_match_jax():
    kw = dict(ratio=2.0, patience=1, decay=0.5, min_progress=0.0, max_progress=1.0, cooldown=2, max_events=2)
    t, j = warp.WarpDetector(4, warp.WarpConfig(**kw)), jwarp.WarpDetector(4, jwarp.WarpConfig(**kw))
    rng = np.random.RandomState(3)
    for i in range(12):
        s = rng.uniform(0.5, 1.5, 4) * np.array([1, 1, 1, 8.0])
        c = np.full(4, 3.0)
        ft, fj = t.update(s, c, 0.5), j.update(s, c, 0.5)
        np.testing.assert_array_equal(ft, fj)
        if ft.any() and t.budget_left:
            t.start_cooldown()
            j.start_cooldown()
        assert (t.events, t.cooldown, t.budget_left) == (j.events, j.cooldown, j.budget_left)
        np.testing.assert_array_equal(t.ema, j.ema)
    assert t.events == 2 and not t.budget_left


def test_unknown_mitigation_raises():
    with pytest.raises(ValueError):
        warp.WarpConfig.from_hparams({"pose.warp.mitigate": "restart"})


@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd"])
def test_reset_opt_rows_matches_jax(kind):
    """Three optax updates of the pose tables, the state carried into torch,
    then both packages' reset_opt_rows on rows 1 and 3."""
    rng = np.random.RandomState(4)
    pose = {"se3": rng.randn(5, 6).astype(np.float32), "depth_scale": rng.randn(5, 2).astype(np.float32)}
    jopt = jmake_optimizer(kind, 2e-3, 1e-5, 100, "ExponentialLR")
    jpose = {k: jnp.asarray(v) for k, v in pose.items()}
    jst = jopt.init(jpose)
    for t in range(3):
        g = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32)) for k, v in pose.items()}
        upd, jst = jopt.update(g, jst, jpose)
        jpose = optax.apply_updates(jpose, upd)
    rows = np.array([1, 3])
    want = jwarp.reset_opt_rows(jst, rows, (5, 6))

    from upnerf_torch.train.state import PoseTables

    tables = PoseTables(5)
    st = make_optimizer(kind, 2e-3, 1e-5, 100).init(tables.parameters())
    adam = jst[0] if kind != "sgd" else None
    weights.optimizer_state_from_jax(st, tables, None if adam is None else jax.tree.map(np.asarray, adam.mu),
                                     None if adam is None else jax.tree.map(np.asarray, adam.nu), 3)
    assert st.optimizer.param_groups[0]["lr"] == pytest.approx(2e-3 * (1e-5 / 2e-3) ** (3 / 100), rel=1e-6)
    warp.reset_opt_rows(st, rows, (5, 6))
    if kind == "sgd":
        assert not any(torch.is_tensor(v) for s in st.optimizer.state.values() for v in s.values())
        return
    wmu, wnu = want[0].mu, want[0].nu
    for name, key in (("se3_refine.weight", "se3"), ("depth_scale.weight", "depth_scale")):
        s = st.optimizer.state[dict(tables.named_parameters())[name]]
        np.testing.assert_array_equal(s["exp_avg"].numpy(), np.asarray(wmu[key]), err_msg=name)
        np.testing.assert_array_equal(s["exp_avg_sq"].numpy(), np.asarray(wnu[key]), err_msg=name)
        assert float(s["step"]) == 3.0
    s = st.optimizer.state[tables.se3_refine.weight]
    assert not s["exp_avg"][rows].any() and not s["exp_avg_sq"][rows].any()
    assert s["exp_avg"][[0, 2, 4]].abs().min() > 0
    assert st.optimizer.state[tables.depth_scale.weight]["exp_avg"].abs().min() > 0


def candidates():
    rng = np.random.RandomState(6)
    return np.concatenate([np.zeros((1, 6)), WARPED[None], rng.randn(2, 6) * 0.05]).astype(np.float32)


def pixels(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, HW, N_RAYS).astype(np.float32), rng.randint(0, HW, N_RAYS).astype(np.float32))


@pytest.mark.parametrize("fused_train", [True, False], ids=["fused_train", "fused_train_off"])
def test_scorer_matches_jax(world, fused_train):
    px, py = pixels(7)
    cands = candidates()
    jscore = jwarp.make_pose_scorer(world["cfg"], N_RAYS, SCORE_PROGRESS)
    want = np.asarray(jscore(world["params"], world["scene"], jnp.asarray(0, jnp.int32), jnp.asarray(px),
                             jnp.asarray(py), jnp.asarray(cands)))
    score = warp.make_pose_scorer(torch_cfg(fused_train), N_RAYS, SCORE_PROGRESS)
    got = score(world["model"], world["tscene"], 0, px, py, cands)
    assert got.shape == (len(cands),) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * want.max())
    one_by_one = torch.cat([score(world["model"], world["tscene"], 0, px, py, c[None]) for c in cands])
    np.testing.assert_allclose(got.numpy(), one_by_one.numpy(), rtol=1e-6, atol=1e-6 * want.max())
    # the base pose is the optimum of image 0's target; the warped incumbent scores far worse
    assert got[0] < 0.5 * got[1], got


def test_run_multistart_matches_jax(world):
    wcfg = dict(kicks=4, score_rays=N_RAYS, score_progress=SCORE_PROGRESS)
    tab = np.zeros((N_IMG, 6), np.float32)
    tab[0] = WARPED
    tab[2] = -0.5 * WARPED
    flags = np.array([True, False, True])
    wh = np.asarray(world["scene"].wh)
    jscore = jwarp.make_pose_scorer(world["cfg"], N_RAYS, SCORE_PROGRESS)
    want_tab, want_rows = jwarp.run_multistart(jscore, world["params"], world["scene"], tab, flags, wh,
                                               jwarp.WarpConfig(**wcfg), np.random.RandomState(1),
                                               log=lambda *a, **k: None)
    score = warp.make_pose_scorer(torch_cfg(), N_RAYS, SCORE_PROGRESS)
    lines = []
    got_tab, got_rows = warp.run_multistart(score, world["model"], world["tscene"], tab, flags, wh,
                                            warp.WarpConfig(**wcfg), np.random.RandomState(1), log=lines.append)
    assert len(lines) == 2 and 0 in want_rows.tolist()
    np.testing.assert_array_equal(got_rows, want_rows)
    np.testing.assert_array_equal(got_tab, want_tab)
    assert np.abs(got_tab[0]).max() < np.abs(tab[0]).max()


# --- the Trainer ----------------------------------------------------------------


@pytest.fixture(scope="module")
def hp(tmp_path_factory):
    from upnerf.data import synthetic
    from upnerf_torch.config import default

    root = tmp_path_factory.mktemp("warp")
    scene_dir = str(root / "scene")
    synthetic.generate_scene(scene_dir, n_train=3, n_test=1, H=20, W=24, feat_hw=6, feat_dim=8)
    hp = default()
    hp.update({
        "dataset_name": "custom", "scene_name": "toy", "exp_name": "warp", "root_dir": scene_dir,
        "feat_dir": os.path.join(scene_dir, "DINO"), "depth_dir": os.path.join(scene_dir, "DPT"),
        "out_dir": str(root / "out"), "max_steps": 40, "debug": True, "phototourism.img_downscale": 1,
        "phototourism.use_cache": False, "nerf.D": 2, "nerf.W": 32, "nerf.skips": (1,), "nerf.N_samples": 8,
        "nerf.N_importance": 4, "nerf.appearance_dim": 8, "nerf.candidate_dim": 4, "nerf.feat_dim": 8,
        "t_net.feat_dim": 8, "t_net.transient_dim": 8, "train.batch_size": 64, "train.ckpt_interval": 100,
        "train.log_pose_interval": 100, "val.log_interval": 100, "val.chunk_size": 128,
        "tpu.matmul_precision": "float32",
        # hair-trigger detector: any image marginally above the median flags at the first check
        "pose.warp.detect": True, "pose.warp.ratio": 1.0001, "pose.warp.patience": 1, "pose.warp.decay": 0.0,
        "pose.warp.min_progress": 0.0, "pose.warp.max_progress": 1.0, "pose.warp.mitigate": "multistart",
        "pose.warp.kicks": 2, "pose.warp.score_rays": 64, "pose.warp.max_events": 1, "pose.warp.cooldown": 1,
    })
    return hp


def spy_on_events(trainer):
    """Records, right after each event that adopted rows, the se3 table and
    the pose optimizer's se3 moments."""
    seen = []
    check = trainer._warp_check

    def spied(step, img_sum, img_cnt):
        n = len(trainer.warp_adoptions)
        check(step, img_sum, img_cnt)
        if len(trainer.warp_adoptions) > n:
            table = trainer.state.pose_params.se3_refine.weight
            state = trainer.state.pose_opt_state.optimizer.state[table]
            seen.append((trainer.warp_adoptions[-1][1], table.detach().clone(),
                         state["exp_avg"].clone(), state["exp_avg_sq"].clone()))

    trainer._warp_check = spied
    return seen


@pytest.mark.parametrize("mitigate", ["multistart", "reset"])
def test_trainer_mitigation_fires(hp, mitigate):
    from upnerf_torch.train.loop import Trainer

    over = {"exp_name": mitigate, "pose.warp.mitigate": mitigate}
    if mitigate == "reset":
        over["pose.warp.min_progress"] = 0.5  # poses drift off zero before the reset
    trainer = Trainer(dict(hp, **over), device="cpu")
    seen = spy_on_events(trainer)
    trainer.fit(log_every=10)
    assert trainer._warp.events == 1 and not trainer._warp.budget_left
    with open(os.path.join(trainer.save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert any("train/warp_flagged" in r for r in rows)
    losses = [r["loss"] for r in rows if "loss" in r]
    assert len(losses) == 4 and np.isfinite(losses).all()
    (adopted, table, mu, nu), = seen  # (multistart could keep every incumbent; this seeded run adopts)
    ev = [r for r in rows if "train/warp_event" in r]
    assert ev[0]["train/warp_event"] == len(adopted) >= 1 and ev[0]["train/warp_events_total"] == 1
    assert not mu[adopted].any() and not nu[adopted].any()
    if mitigate == "reset":
        assert not table[adopted].any()
        assert table.abs().max() > 0  # the other rows kept their refinement
    # training moved the adopted rows on after the event
    assert not torch.equal(trainer.state.pose_params.se3_refine.weight.detach()[adopted], table[adopted])


def test_multistart_without_features_falls_back(hp):
    from upnerf_torch.train.loop import Trainer

    with pytest.warns(UserWarning, match="needs feature encoding"):
        trainer = Trainer(dict(hp, exp_name="featureless", **{"nerf.feat_dim": 0}), device="cpu")
    assert trainer.warp_cfg.mitigate == "none"
