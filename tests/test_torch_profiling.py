"""upnerf_torch.utils.profiling: `summarize` against upnerf.utils.profiling
over the same metrics.jsonl (a Trainer's, written by the port's
MetricLogger, with non-numeric values and the step / time keys left out);
`trace` writes a Chrome trace and a kernel table on the CPU; the program's
spans:
- off (the default), `span` is one shared no-op that records nothing and
  opens no profiler range;
- on, the log holds each span's name, parent, unit and host-clock interval,
  counts and sums per name, and leaves out other threads; a profiler's
  trace holds each span as a range, and only under a profiler is one
  opened;
- a train step (both entries), a TTO step and a `render_image` frame each
  open their root span once a unit, tiled by their stage spans;
- a train step with spans on leaves the loss, the parameters and the
  optimizers' state bit for bit as with them off.
The Trainer's `train.profile_at` capture is in test_torch_trainer.py."""

import contextlib
import json
import os
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from upnerf.utils import profiling as jprofiling
from upnerf_torch.evaluate import render as trender
from upnerf_torch.evaluate import tto
from upnerf_torch.models.nerf import NeRFConfig
from upnerf_torch.models.transient import TransientConfig
from upnerf_torch.render.render_rays import RenderConfig
from upnerf_torch.train import (LossConfig, StepConfig, init_params, init_pose_params, make_optimizer,
                                make_ray_store, make_scene_constants, make_train_state, make_train_step)
from upnerf_torch.utils import profiling, weights
from upnerf_torch.utils.logging import MetricLogger

from helpers import tiny_scene

N_IMG, BATCH = 3, 16
HP = {
    "nerf.D": 2, "nerf.W": 32, "nerf.skips": (1,), "nerf.N_emb_xyz": 4, "nerf.N_emb_dir": 2,
    "nerf.feat_dim": 8, "nerf.appearance_dim": 8, "nerf.candidate_dim": 4, "pose.c2f": (0.1, 0.5),
    "nerf.N_samples": 8, "nerf.N_importance": 8, "nerf.near": 0.1, "nerf.far": 5.0,
    "nerf.use_disp": False, "nerf.perturb": 1.0, "val.chunk_size": 64, "tpu.matmul_precision": "float32",
    "t_net.transient_dim": 8, "t_net.feat_dim": 8, "t_net.beta_min": 0.1,
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_summarize_matches_jax(tmp_path):
    log = MetricLogger(str(tmp_path))
    for step in range(1, 8):
        log.log(step, {"loss": 1.0 / step, "psnr": 10.0 + step, "lr": 5e-4 * 0.9**step})
        if step % 3 == 0:
            log.log(step, {"val/psnr": 20.0 + step})
    log.close()
    with open(tmp_path / "metrics.jsonl", "a") as f:
        f.write(json.dumps({"step": 8, "time": 0.0, "note": "text", "flag": True}) + "\n")
    path = str(tmp_path / "metrics.jsonl")
    got, want = profiling.summarize(path), jprofiling.summarize(path)
    assert got == want
    assert set(got) == {"loss", "psnr", "lr", "val/psnr", "flag"} and got["loss"]["n"] == 7
    assert got["val/psnr"]["last"] == 26.0


def test_trace_writes_chrome_trace_and_table(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "prof")):
        (x @ x).sum().item()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert "aten::mm" in (tmp_path / "prof" / "table.txt").read_text()


@pytest.fixture
def record_function_calls(monkeypatch):
    """Every name torch.profiler.record_function is opened with."""
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return calls


def test_spans_off_record_nothing_and_open_no_profiler_range(record_function_calls, tmp_path):
    assert profiling._log is None
    assert profiling.span("train.step") is profiling.span("tto.step")
    with profiling.trace(str(tmp_path / "prof")):
        for _ in range(3):
            with profiling.span("train.step"):
                with profiling.span("train.batch"):
                    torch.ones(4).sum()
    assert record_function_calls == []
    assert "train.step" not in (tmp_path / "prof" / "trace.json").read_text()


def test_spans_on_log_names_parents_units_and_sums(record_function_calls, tmp_path):
    with profiling.spans() as log:
        for _ in range(2):
            with profiling.span("step"):
                with profiling.span("a"):
                    with profiling.span("inner"):
                        pass
                with profiling.span("b"):
                    pass
                with profiling.span("a"):
                    pass
        other = threading.Thread(target=lambda: profiling.span("elsewhere").__enter__())
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
        with profiling.spans() as inner:  # a nested block records into its own log
            with profiling.span("nested"):
                pass
        with profiling.span("step"):
            pass
    assert profiling._log is None and record_function_calls == []
    names = [r[0] for r in log.records]
    assert names == ["step", "a", "inner", "b", "a"] * 2 + ["step"]
    assert [r[1] for r in log.records] == [-1, 0, 1, 0, 0, -1, 5, 6, 5, 5, -1]
    assert [r[2] for r in log.records] == [0] * 5 + [5] * 5 + [10]
    for name, parent, unit, t0, t1 in log.records:
        assert t1 is not None and t0 <= t1
        if parent >= 0:
            p = log.records[parent]
            assert p[3] <= t0 and t1 <= p[4] and p[2] == unit
    assert log.units == 3 and [r[0] for r in inner.records] == ["nested"]
    totals = log.totals()
    assert {k: n for k, (n, _) in totals.items()} == {"step": 3, "a": 4, "inner": 2, "b": 2}
    a_s = sum(r[4] - r[3] for r in log.records if r[0] == "a") / 1e9
    assert totals["a"][1] == pytest.approx(a_s)
    summary = json.loads(json.dumps(log.summary()))
    assert summary["units"] == 3 and summary["spans"]["a"] == {"count": 4, "s": pytest.approx(a_s)}

    with profiling.trace(str(tmp_path / "prof")), profiling.spans() as traced:
        with profiling.span("train.step"):
            with profiling.span("train.forward"):
                torch.ones(4).sum()
    assert record_function_calls == ["train.step", "train.forward"] and traced.units == 1
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert {"train.step", "train.forward"} <= {e.get("name") for e in events if e.get("ph") == "X"}


def check_units(log, root, stages, n_units):
    """Each unit: its root span once, and directly under it the stage
    spans `stages` (name -> count), each inside the root's interval."""
    recs = log.records
    roots = [i for i, r in enumerate(recs) if r[1] < 0]
    assert [recs[i][0] for i in roots] == [root] * n_units and log.units == n_units
    for i in roots:
        kids = [r for r in recs if r[2] == i and r[1] >= 0]
        assert all(r[1] == i for r in kids)
        assert Counter(r[0] for r in kids) == Counter(stages)
        assert all(recs[i][3] <= r[3] <= r[4] <= recs[i][4] for r in kids)


def train_world(seed=0):
    """A tiny scene, its ray store and a train state at phase 1's shapes."""
    scene, store = tiny_scene(n_img=N_IMG, H=8, W=8, fh=4, fw=4, feat_dim=8, seed=1)
    tscene = make_scene_constants(np.asarray(scene.Ks), np.asarray(scene.poses), np.asarray(scene.near_far),
                                  np.asarray(scene.wh), np.asarray(scene.feat_maps), "cpu", feat_dtype=torch.float32)
    tstore = make_ray_store(*(np.asarray(a) for a in store), device="cpu")
    cfg = StepConfig(
        nerf=NeRFConfig.from_hparams(HP), transient=TransientConfig.from_hparams(HP),
        render=RenderConfig(N_samples=8, N_importance=8, perturb=1.0, precision="float32"),
        loss=LossConfig(depth_mult=1e-3, alpha_reg=1.0, encode_feat=True, fine=True),
        candidate_schedule=(0.1, 0.5), max_steps=100, pose_optimize=True, near=0.1, far=5.0, batch_size=BATCH,
    )
    model = init_params(cfg.nerf, cfg.transient, N_IMG, generator=torch.Generator().manual_seed(seed))
    opt, pose_opt = make_optimizer("adam", 5e-3, 5e-4, 100), make_optimizer("adam", 2e-3, 2e-4, 100)
    state = make_train_state(model, init_pose_params(N_IMG), opt, pose_opt, seed=seed, device="cpu")
    return cfg, tscene, tstore, state._replace(step=30), make_train_step(cfg, opt, pose_opt)


TRAIN_STAGES = {"train.batch": 1, "train.forward": 1, "train.backward": 1, "train.opt": 2}


@pytest.mark.parametrize("entry", ["step_fn", "batch_step_fn"])
def test_train_step_spans(entry):
    cfg, scene, store, state, (step_fn, batch_step_fn) = train_world()
    with profiling.spans() as log:
        for i in range(2):
            if entry == "step_fn":
                state, _ = step_fn(state, scene, store, 1)
            else:
                idx = torch.arange(i * BATCH, (i + 1) * BATCH)
                batch = {"px": store.px[idx].float(), "py": store.py[idx].float(), "img_idx": store.img_idx[idx],
                         "rgb": store.rgb[idx].float() / 255.0, "inv_depth": store.inv_depth[idx].float()}
                state, _ = batch_step_fn(state, scene, batch, 1)
    check_units(log, "train.step", TRAIN_STAGES, 2)


def test_spans_leave_the_train_step_bit_for_bit():
    def two_steps(spans_on):
        _, scene, store, state, (step_fn, _) = train_world(seed=5)
        with profiling.spans() if spans_on else contextlib.nullcontext():
            losses = []
            for _ in range(2):
                state, m = step_fn(state, scene, store, 1)
                losses.append(m["loss"])
        return losses, state

    (l_off, s_off), (l_on, s_on) = two_steps(False), two_steps(True)
    assert all(torch.equal(a, b) for a, b in zip(l_off, l_on))
    for mod in ("params", "pose_params"):
        for (k, a), (_, b) in zip(getattr(s_off, mod).state_dict().items(), getattr(s_on, mod).state_dict().items()):
            assert torch.equal(a, b), k
    for opt in ("opt_state", "pose_opt_state"):
        a, b = (getattr(s, opt).optimizer.state_dict()["state"] for s in (s_off, s_on))
        assert a.keys() == b.keys()
        for i in a:
            for k in a[i]:
                assert torch.equal(torch.as_tensor(a[i][k]), torch.as_tensor(b[i][k])), (i, k)


@pytest.fixture(scope="module")
def frozen(tmp_path_factory):
    """The render parameters of one seeded tiny model."""
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.ckpt")
    weights.init_reference_ckpt(path, HP, n_images=N_IMG, seed=7)
    sd, _, _ = weights.load_reference_ckpt(path)
    params, _ = weights.render_params(sd, NeRFConfig.from_hparams(HP), "cpu")
    return params


def test_tto_step_spans(frozen):
    G, w, h = 2, 12, 8
    rng = np.random.RandomState(0)
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (G, 1, 1))
    poses[:, 2, 3] = 3.0
    group = tto.TTOGroup(
        Ks=torch.tensor([[10.0, 0, w / 2], [0, 10.0, h / 2], [0, 0, 1]]).expand(G, 3, 3).contiguous(),
        base_poses=torch.from_numpy(poses), rgbs=torch.from_numpy(rng.randint(0, 256, (G, h, w, 3)).astype(np.uint8)),
        wh=torch.tensor([[w, h]] * G), near_far=torch.tensor([[0.1, 5.0]] * G))
    cfg = tto.TTOConfig(nerf=NeRFConfig.from_hparams(HP),
                        render=RenderConfig.from_hparams(HP)._replace(param_grads=False), batch_size=8)
    step = tto.make_tto_step(frozen, cfg, optimize_pose=True, x_frac=(0.0, 1.0))
    tr = {"fine_a": torch.randn(G, HP["nerf.appearance_dim"]).requires_grad_(True),
          "se3": torch.zeros(G, 6, requires_grad=True)}
    opt = torch.optim.Adam(list(tr.values()), lr=1e-3)
    gen = torch.Generator().manual_seed(0)
    with profiling.spans() as log:
        for _ in range(3):
            loss = step(tr, opt, group, gen)
    assert torch.isfinite(loss)
    check_units(log, "tto.step", {"tto.batch": 1, "tto.forward": 1, "tto.backward": 1, "tto.opt": 2}, 3)


def test_render_image_frame_spans(frozen):
    wh, chunk = (16, 8), 48  # 128 pixels: two whole chunks and a padded third
    K = np.array([[12.0, 0, 8], [0, 12.0, 4], [0, 0, 1]], np.float32)
    pose = np.eye(3, 4, dtype=np.float32)
    pose[2, 3] = 3.0
    renderer = trender.make_pose_renderer(RenderConfig.from_hparams(HP)._replace(perturb=0.0), chunk=chunk)
    with profiling.spans() as log:
        for _ in range(2):
            rgb, depth = trender.render_image(renderer, frozen, K, pose, wh, np.array([0.1, 5.0], np.float32), 1,
                                              chunk=chunk, device="cpu")
    assert rgb.shape == (8, 16, 3) and depth.shape == (8, 16)
    check_units(log, "serve.frame", {"serve.upload": 1, "serve.chunk": 3, "serve.to_host": 1}, 2)
