"""The port's training entry point against the JAX package, on the CPU at a
tiny width: data arrays, cache, val renderer, warp detector, Trainer and the
train CLI.

- `resize_bilinear` against PIL's mode-"F" BILINEAR, shrinking and growing,
  2-D and 3-D: equal to the last bit (the same float64 coefficients and sums,
  float32 between the passes);
- `build_arrays` and `load_training_data` against the JAX package's on a
  `synthetic.generate_scene` scene with DINO / DPT .npy files, custom and
  Phototourism layouts: every array equal (the DPT maps through the resize
  above, the images through the LANCZOS downscale, both bit for bit); the
  cache written by either package read by the other, equal;
- `make_eval_render` against JAX's in phases 0, 1, 2 (deterministic chunks,
  pred_depth, feats_gt): 1e-4 absolute, depth 1e-4 relative;
- `WarpDetector` against JAX's on the same loss stream: the same flags and EMA;
- `Trainer` (modelled on tests/test_e2e_train.py): fit and resume under the
  default flags and with `tpu.fused_train false`; a val render of the full
  image; checkpoint retention that keeps the latest and the best; the val
  downscale floor; the non-finite watchdog recovering once and aborting after
  its budget or without a checkpoint; an explicit `resume_ckpt`; the
  `train.profile_at` capture (trace.json and table.txt, one `train.step`
  range a captured step holding its stage ranges);
- `cli.train.main` end to end; its checkpoint loads through
  `cli.tto.load_trained` and renders through `cli.render_video`.
"""

import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from upnerf.data import build_arrays as jbuild_arrays
from upnerf.data import cache as jcache
from upnerf.data import load_scene_meta as jload_scene_meta
from upnerf.data import load_training_data as jload_training_data
from upnerf.data import synthetic
from upnerf.models import NeRFConfig as JNeRFConfig
from upnerf.models import TransientConfig as JTransientConfig
from upnerf.render import RenderConfig as JRenderConfig
from upnerf.train import LossConfig as JLossConfig
from upnerf.train import StepConfig as JStepConfig
from upnerf.train import init_params as jinit_params
from upnerf.train.step import make_eval_render as jmake_eval_render
from upnerf.train.warp import WarpConfig as JWarpConfig
from upnerf.train.warp import WarpDetector as JWarpDetector
from upnerf_torch.config import default
from upnerf_torch.data import build_arrays, cache, load_scene_meta, load_training_data
from upnerf_torch.data.images import resize_bilinear
from upnerf_torch.models.nerf import NeRFConfig
from upnerf_torch.models.transient import TransientConfig
from upnerf_torch.render.render_rays import RenderConfig
from upnerf_torch.train import LossConfig, StepConfig, make_eval_render, make_scene_constants
from upnerf_torch.train.warp import WarpConfig, WarpDetector
from upnerf_torch.utils import weights

from helpers import tiny_scene


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,wh", [((37, 53), (20, 11)), ((37, 53), (90, 70)), ((16, 16, 3), (5, 7)),
                                      ((24, 30), (30, 24)), ((55, 55, 4), (160, 120)), ((100, 133), (17, 13))])
def test_resize_bilinear_matches_pil(shape, wh):
    a = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    chans = [a] if a.ndim == 2 else [a[..., c] for c in range(a.shape[-1])]
    want = [np.asarray(Image.fromarray(c, mode="F").resize(wh, Image.BILINEAR)) for c in chans]
    want = want[0] if a.ndim == 2 else np.stack(want, -1)
    got = resize_bilinear(a, wh)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def scene_hp(root, layout):
    hp = default()
    hp.update({"dataset_name": "phototourism" if layout else "custom", "scene_name": os.path.basename(root),
               "root_dir": root,
               "feat_dir": os.path.join(root, "DINO"), "depth_dir": os.path.join(root, "DPT"),
               "phototourism.img_downscale": 1, "phototourism.use_cache": False})
    return hp


def assert_arrays_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("layout", [False, True], ids=["custom", "phototourism"])
def test_build_arrays_and_cache_match_jax(tmp_path, layout):
    root = str(tmp_path / "scene")
    synthetic.generate_scene(root, n_train=3, n_test=1, H=20, W=24, feat_hw=6, feat_dim=8, seed=2,
                             phototourism_layout=layout)
    hp = scene_hp(root, layout)
    got = build_arrays(load_scene_meta(hp), hp["feat_dir"], hp["depth_dir"], hp["nerf.near"], hp["nerf.far"])
    want = jbuild_arrays(jload_scene_meta(hp), hp["feat_dir"], hp["depth_dir"], hp["nerf.near"], hp["nerf.far"])
    for g, w in zip(got, want):
        assert_arrays_equal(g, w)
    loaded = load_training_data(hp)
    jloaded = jload_training_data(hp)
    for g, w in zip(loaded[:2], jloaded[:2]):
        assert_arrays_equal(g, w)
    # the cache, each package reading what the other wrote (COLMAP bounds, camera_noise=None)
    hp_c = dict(hp, **{"phototourism.use_cache": True})
    meta_c = load_scene_meta(hp_c, camera_noise=None)
    cdir = cache.cache_dir_for(root, meta_c.scale)
    scene_np, store_np = build_arrays(meta_c, hp["feat_dir"], hp["depth_dir"], hp["nerf.near"], hp["nerf.far"])
    cache.save_cache(cdir, meta_c, scene_np, store_np)
    jinfo, jscene_np, jstore_np = jcache.load_cache(cdir)
    assert_arrays_equal(jscene_np, scene_np)
    assert_arrays_equal(jstore_np, store_np)
    for g, w in zip(load_training_data(hp_c)[:2], jload_training_data(hp_c)[:2]):
        assert_arrays_equal(g, w)
    jmeta = jload_scene_meta(hp_c, camera_noise=None)
    jscene2, jstore2 = jbuild_arrays(jmeta, hp["feat_dir"], hp["depth_dir"], hp["nerf.near"], hp["nerf.far"])
    jcache.save_cache(cdir, jmeta, jscene2, jstore2)
    info, scene3, store3 = cache.load_cache(cdir)
    assert_arrays_equal(scene3, jscene2)
    assert_arrays_equal(store3, jstore2)
    assert info["img_ids_train"] == jinfo["img_ids_train"]


NERF = dict(D=4, W=32, skips=(2,), feat_dim=16, xyz_L=4, dir_L=2, appearance_dim=8, candidate_dim=4, c2f=(0.1, 0.5))
T_NET = dict(beta_min=0.1, transient_dim=8, feat_dim=16)


@pytest.mark.parametrize("phase,progress", [(0, 0.05), (1, 0.3), (2, 0.6)])
def test_make_eval_render_matches_jax(phase, progress):
    n_img, chunk = 3, 32
    scene, store = tiny_scene(n_img=n_img, H=8, W=8, fh=4, fw=4, feat_dim=16, seed=1)
    common = dict(candidate_schedule=(0.1, 0.5), max_steps=100, pose_optimize=True, near=0.1, far=5.0, batch_size=16)
    loss = dict(depth_mult=1e-3, alpha_reg=1.0, encode_feat=True, fine=True)
    jcfg = JStepConfig(nerf=JNeRFConfig(**NERF), transient=JTransientConfig(**T_NET),
                       render=JRenderConfig(N_samples=8, N_importance=8, precision="float32"),
                       loss=JLossConfig(**loss), **common)
    tcfg = StepConfig(nerf=NeRFConfig(**NERF), transient=TransientConfig(**T_NET),
                      render=RenderConfig(N_samples=8, N_importance=8, precision="float32"),
                      loss=LossConfig(**loss), **common)
    params = jinit_params(jax.random.PRNGKey(3), jcfg.nerf, jcfg.transient, n_img)
    rng = np.random.RandomState(4)
    pose = {"se3": jnp.asarray(rng.randn(n_img, 6).astype(np.float32) * 0.02),
            "depth_scale": jnp.asarray(rng.randn(n_img, 2).astype(np.float32) * 0.1)}
    n = 2 * chunk
    batch = {"px": rng.randint(0, 8, n).astype(np.float32), "py": rng.randint(0, 8, n).astype(np.float32),
             "img_idx": np.full(n, 1, np.int32), "inv_depth": rng.uniform(0.2, 5, n).astype(np.float32)}
    want = jmake_eval_render(jcfg, chunk)(params, pose, scene, {k: jnp.asarray(v) for k, v in batch.items()},
                                          jnp.float32(progress), phase)
    model, pose_t = weights.train_modules_from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, pose),
                                                   tcfg.nerf, tcfg.transient, n_img)
    tscene = make_scene_constants(np.asarray(scene.Ks), np.asarray(scene.poses), np.asarray(scene.near_far),
                                  np.asarray(scene.wh), np.asarray(scene.feat_maps), "cpu", feat_dtype=torch.float32)
    tbatch = {k: torch.from_numpy(v.astype(np.int64) if k == "img_idx" else v) for k, v in batch.items()}
    got = make_eval_render(tcfg, chunk)(model, pose_t, tscene, tbatch, progress, phase)
    assert set(got) == set(want) and {"pred_depth", "feats_gt"} <= set(got)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-4 if "depth" in k else 0, atol=1e-4,
                                   err_msg=k)


def test_warp_detector_matches_jax():
    hp = {"pose.warp.patience": 2, "pose.warp.min_progress": 0.1}
    t, j = WarpDetector(5, WarpConfig.from_hparams(hp)), JWarpDetector(5, JWarpConfig.from_hparams(hp))
    rng = np.random.RandomState(0)
    flagged = 0
    for i in range(12):
        s = rng.uniform(0.5, 1.5, 5) * (1 + 9 * (np.arange(5) == 3))  # image 3 stalls
        c = rng.randint(0, 4, 5).astype(np.float64)
        ft, fj = t.update(s, c, i / 12), j.update(s, c, i / 12)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(t.ema, j.ema)
        flagged += int(ft.any())
    assert flagged > 0


@pytest.fixture(scope="module")
def hp(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    scene_dir = str(root / "scene")
    synthetic.generate_scene(scene_dir, n_train=3, n_test=1, H=20, W=24, feat_hw=6, feat_dim=8)
    hp = default()
    hp.update({
        "dataset_name": "custom", "scene_name": "toy", "exp_name": "test", "root_dir": scene_dir,
        "feat_dir": os.path.join(scene_dir, "DINO"), "depth_dir": os.path.join(scene_dir, "DPT"),
        "out_dir": str(root / "out"), "max_steps": 40, "debug": True, "phototourism.img_downscale": 1,
        "phototourism.use_cache": False, "nerf.D": 2, "nerf.W": 32, "nerf.skips": (1,), "nerf.N_samples": 8,
        "nerf.N_importance": 4, "nerf.N_emb_xyz": 4, "nerf.N_emb_dir": 2, "nerf.appearance_dim": 8,
        "nerf.candidate_dim": 4, "nerf.feat_dim": 8, "t_net.feat_dim": 8, "t_net.transient_dim": 8,
        "train.batch_size": 64, "train.ckpt_interval": 10, "train.log_pose_interval": 20, "val.log_interval": 15,
        "val.chunk_size": 128, "tpu.matmul_precision": "float32", "optimizer.lr": 5e-3,
        "optimizer.scheduler.lr_end": 5e-4,
    })
    return hp


def trainer_of(hp, **over):
    from upnerf_torch.train.loop import Trainer

    return Trainer(dict(hp, **over), device="cpu")


def records(trainer):
    with open(os.path.join(trainer.save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("fused_train", [True, False], ids=["defaults", "fused_train_off"])
def test_trainer_fit_and_resume(hp, fused_train):
    over = {"exp_name": f"fit_{fused_train}", "tpu.fused_train": fused_train}
    trainer = trainer_of(hp, **over)
    assert trainer.cfg.render.fused_train is fused_train
    state = trainer.fit(log_every=10, max_steps=20)
    assert state.step == 20 and trainer.ckpt.latest_step() == 20
    losses = [r["loss"] for r in records(trainer) if "loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    trainer2 = trainer_of(hp, **over)
    state2 = trainer2.fit(log_every=10, max_steps=40)
    assert state2.step == 40
    assert state2.pose_params.se3_refine.weight.abs().max() > 0
    # the resumed run continued from step 20: its optimizer has taken 40 steps in all
    assert trainer2.state.opt_state.optimizer.state_dict()["state"][0]["step"] == 40


def test_validate_renders_full_image(hp):
    trainer = trainer_of(hp, exp_name="val")
    trainer.state = trainer.state._replace(step=30)  # phase 2: the rgb outputs too
    out, (w, h) = trainer.render_image(0)
    assert out["s_depth_fine"].shape == (w * h,) and out["rgb_fine"].shape == (w * h, 3)
    assert np.isfinite(trainer.validate(30))


def test_ckpt_retention_keeps_latest_and_best(tmp_path):
    from upnerf_torch.utils.ckpt import CheckpointManager

    payload = {"x": torch.arange(3)}
    mngr = CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2)
    mngr.save(1, payload, {"val_psnr": 20.0})
    mngr.save(2, payload, {"val_psnr": 25.0})  # best
    mngr.save(3, payload)  # interval save, no metrics: kept while latest
    assert mngr.all_steps() == [1, 2, 3]
    mngr.save(4, payload, {"val_psnr": 22.0})
    mngr.save(5, payload, {"val_psnr": 18.0})  # final: worse than all before
    assert mngr.latest_step() == 5 and mngr.best_step() == 2
    assert mngr.all_steps() == [2, 4, 5]
    m2 = CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2)
    assert m2.best_step() == 2 and m2.latest_step() == 5
    assert torch.equal(m2.load()["x"], payload["x"])


def test_val_downscale_floor(hp):
    trainer = trainer_of(hp, exp_name="valfloor")
    assert trainer.val_scale == 2 and trainer.val_data is not None
    out, (w, h) = trainer.render_image(0)
    assert (w, h) == (12, 10) and out["s_depth_fine"].shape == (w * h,)
    assert np.isfinite(trainer.validate(0))


def nan_step(state, scene, store, phase):
    return state, {"loss": torch.tensor(float("nan"))}


def test_watchdog_recovers_once_then_continues(hp):
    trainer = trainer_of(hp, exp_name="watchdog_recover")
    trainer.fit(log_every=5, max_steps=10)
    assert trainer.ckpt.latest_step() == 10
    real, calls = trainer.step_fn, {"n": 0}

    def flaky(state, scene, store, phase):
        calls["n"] += 1
        return nan_step(state, scene, store, phase) if calls["n"] <= 5 else real(state, scene, store, phase)

    trainer.step_fn = flaky
    assert trainer.fit(log_every=5, resume=True, max_steps=20).step == 20
    assert trainer._nan_restarts == 1
    assert any("train/nonfinite_restart" in r for r in records(trainer))


def test_watchdog_aborts_after_budget_and_without_checkpoint(hp):
    trainer = trainer_of(hp, exp_name="watchdog_abort", **{"train.max_nan_restarts": 1})
    trainer.fit(log_every=5, max_steps=10)
    trainer.step_fn = nan_step
    with pytest.raises(FloatingPointError, match="diverges reproducibly"):
        trainer.fit(log_every=5, resume=True, max_steps=20)
    assert trainer._nan_restarts == 2  # the budget of 1, and the aborting hit
    fresh = trainer_of(hp, exp_name="watchdog_nockpt")
    fresh.step_fn = nan_step
    with pytest.raises(FloatingPointError, match="before the first"):
        fresh.fit(log_every=5, max_steps=10)


def test_explicit_resume_ckpt(hp):
    src = trainer_of(hp, exp_name="resume_src")
    src.fit(log_every=10, max_steps=10)
    se3 = src.state.pose_params.se3_refine.weight.detach().clone()
    for path in (src.save_dir, src.ckpt.path(10)):  # a run directory, a checkpoint file
        dst = trainer_of(hp, exp_name="resume_dst", resume_ckpt=path)
        assert dst.fit(log_every=10, max_steps=10).step == 10
        assert torch.equal(dst.state.pose_params.se3_refine.weight.detach(), se3)


def test_profile_capture_writes_the_steps_spans(hp):
    """`train.profile_at` writes trace.json and table.txt into <run>/profile/,
    with the program's spans on for the captured steps only: one `train.step`
    range a step, each holding its stages."""
    from upnerf_torch.utils import profiling

    trainer = trainer_of(hp, exp_name="profiled", **{"train.profile_at": 3, "train.profile_steps": 2})
    trainer.fit(log_every=10, max_steps=8)
    out = os.path.join(trainer.save_dir, "profile")
    assert "aten::" in open(os.path.join(out, "table.txt")).read() and profiling._log is None
    with open(os.path.join(out, "trace.json")) as f:
        ranges = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in ranges if e["name"] == "train.step")
    assert len(steps) == 2
    for name in ("train.batch", "train.forward", "train.backward", "train.opt"):
        inside = [e for e in ranges if e["name"] == name and any(a <= e["ts"] <= b for a, b in steps)]
        assert len(inside) == (4 if name == "train.opt" else 2), name


def test_unported_configurations_raise(hp):
    """The data-parallel settings raised until the port had torch.distributed.
    Now a Trainer outside a process group refuses a mesh of 2 ranks only for
    want of the group (cli.train starts the ranks:
    tests/test_torch_multiprocess.py), and one rank of a group
    (`dist.num_processes 1`) trains as a Trainer alone does, bit for bit."""
    from upnerf_torch import parallel

    with pytest.raises(RuntimeError, match="no process group"):
        trainer_of(hp, exp_name="unported", **{"tpu.n_devices": 2})
    alone = trainer_of(hp, exp_name="alone").fit(log_every=5, max_steps=5)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    parallel.initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0, device="cpu")
    try:
        trainer = trainer_of(hp, exp_name="grouped", **{"dist.num_processes": 1})
        assert trainer.mesh.size == 1 and trainer.mesh.group is None and parallel.is_main_process()
        grouped = trainer.fit(log_every=5, max_steps=5)
    finally:
        parallel.shutdown()
    for a, b in zip(alone.params.parameters(), grouped.params.parameters()):
        assert torch.equal(a, b)


def test_default_n_devices_is_one_rank_on_a_multi_card_host(hp, monkeypatch):
    """`tpu.n_devices 0`, every config's default, is this process's one
    device outside a process group, on a host of four cards as on one: the
    mesh, cli.train and the Trainer start no ranks. N > 1 asks for N (clamped
    to the cards), and a host of a multi-process run takes every card."""
    from upnerf_torch import parallel
    from upnerf_torch.cli import train as train_cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda")
    assert hp["tpu.n_devices"] == 0
    assert parallel.make_mesh(0, cuda) == parallel.DataMesh(0, 1, cuda)
    with pytest.raises(RuntimeError, match="no process group"):
        parallel.make_mesh(2, cuda)
    assert [parallel.local_ranks(n, cuda) for n in (0, 1, 2, 8)] == [1, 1, 2, 4]
    assert parallel.local_ranks(0, cuda, every_card=True) == 4
    assert train_cli.ranks(hp, cuda)[:2] == (1, False)
    assert train_cli.ranks(dict(hp, **{"tpu.n_devices": 3}), cuda)[:2] == (3, False)
    host = {"dist.coordinator": "127.0.0.1:1", "dist.num_processes": 2, "dist.process_id": 0}
    assert train_cli.ranks(dict(hp, **host), cuda)[:2] == (4, True)
    assert train_cli.ranks(dict(hp, **{"dist.multiprocess": True}), cuda)[:2] == (1, True)  # torchrun's ranks
    trainer = trainer_of(hp, exp_name="four_cards")
    assert trainer.mesh == parallel.DataMesh(0, 1, torch.device("cpu")) and trainer.is_main


def test_train_cli_end_to_end(hp, tmp_path):
    from upnerf_torch.cli import render_video, tto
    from upnerf_torch.cli import train as train_cli
    from upnerf_torch.config import load

    overrides = {"out_dir": str(tmp_path / "out"), "exp_name": "cli", "max_steps": 6, "val.log_interval": 3,
                 "train.ckpt_interval": 3, "debug": False, "val.img_idx": "[0]"}
    argv = ["--config", os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs", "custom.yaml"),
            "--device", "cpu"]
    keys = ("dataset_name", "scene_name", "root_dir", "feat_dir", "depth_dir", "phototourism.img_downscale",
            "phototourism.use_cache", "nerf.D", "nerf.W", "nerf.skips", "nerf.N_samples", "nerf.N_importance",
            "nerf.N_emb_xyz", "nerf.N_emb_dir", "nerf.appearance_dim", "nerf.candidate_dim", "nerf.feat_dim",
            "t_net.feat_dim", "t_net.transient_dim", "train.batch_size", "val.chunk_size", "tpu.matmul_precision")
    for k in keys:
        v = hp[k]
        argv += [k, str(list(v) if isinstance(v, tuple) else v)]
    for k, v in overrides.items():
        argv += [k, str(v)]
    trainer = train_cli.main(argv)
    assert trainer.state.step == 6 and trainer.ckpt.all_steps() == [3, 6]
    saved = load(os.path.join(trainer.save_dir, "config.yaml"))
    assert saved["max_steps"] == 6 and saved["nerf.skips"] == (1,) and saved["device"] == "cpu"
    assert any(f.startswith("val_0_viz_rgb_GT") for f in os.listdir(os.path.join(trainer.save_dir, "images")))
    ckpt = trainer.ckpt.path(6)
    hparams, params, se3_table, meta = tto.load_trained(ckpt, "cpu")
    assert se3_table.shape == (3, 6) and hparams["max_steps"] == 6
    torch.testing.assert_close(se3_table, trainer.state.pose_params.se3_refine.weight.detach())
    out = render_video.main(["--ckpt", ckpt, "--out", str(tmp_path / "v"), "--frames", "1", "--wh", "8", "6",
                             "--focal", "10", "--device", "cpu"])
    depth = np.load(out["depths"][0])
    assert depth.shape == (6, 8) and np.isfinite(depth).all()
