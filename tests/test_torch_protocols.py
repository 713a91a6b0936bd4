"""The port's quality-protocol drivers (upnerf_torch/scripts/{pose,tto,
quality}_protocol.py, analyze_pose_recovery.py, protocol_table.py) against
the JAX scripts under scripts/, loaded with importlib as
tests/test_pose_protocol.py loads them.

- The recipe tables and pass constants equal the JAX scripts'.
- plan_run, load_prior_runs and write_summary give the JAX functions'
  results on the same inputs; each package's run directory is built in its
  own checkpoint layout (JAX: ckpts/<step>/, the port: ckpts/<step>.ckpt).
- The pose perturbation each package's scene loader draws for the same
  JAX-generated scene is the same, bit for bit (noise file and poses).
- train/pose_R_rel (each Trainer's log_pose) and analyze_pose_recovery's
  numbers on one se3 table equal JAX's within 1e-5 deg.
- A tiny end-to-end call of each driver on --device cpu writes a record
  whose keys are the JAX driver's plus "device": the JAX driver's run_one,
  on the run directory the port's driver trained (its reuse path, so JAX
  trains nothing), and write_summary give the JAX record; its rows equal
  the port's.
"""

import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from upnerf_torch.scripts import analyze_pose_recovery as tanalyze
from upnerf_torch.scripts import pose_protocol as tpose
from upnerf_torch.scripts import protocol_table as ttable
from upnerf_torch.scripts import quality_protocol as tqual
from upnerf_torch.scripts import tto_protocol as ttto

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVERS = ("pose_protocol", "tto_protocol", "quality_protocol", "analyze_pose_recovery", "protocol_table")


def _load_jax(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX = {name: _load_jax(name) for name in ("pose_protocol", "tto_protocol", "quality_protocol")}
PORT = {"pose_protocol": tpose, "tto_protocol": ttto, "quality_protocol": tqual}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the tables ----------------------------------------------------------------

CONSTANTS = [("pose_protocol", "RECIPES")] + [
    ("tto_protocol", k) for k in ("SCENE_DIR", "SCENE_KWARGS", "CONFIG", "OUT_DIR", "PROTOCOL_REV", "TTO_KW",
                                  "TRAIN_RECIPES", "PASS_GAP_DB", "CONVERGED_REL_R_DEG")
] + [("quality_protocol", k) for k in ("SCENE_DIR", "SCENE_KWARGS", "CONFIG", "OUT_DIR", "TTO_KW")]


@pytest.mark.parametrize("module,name", CONSTANTS)
def test_tables_equal_the_jax_scripts(module, name):
    assert getattr(PORT[module], name) == getattr(JAX[module], name)


def test_tto_stamp_and_pass_criterion_equal_the_jax_scripts(tmp_path):
    assert ttto._stamp() == JAX["tto_protocol"]._stamp()
    rows = [_tto_row(42), _tto_row(777, tto=20.0, converged=False)]
    port = ttto.write_summary(str(tmp_path / "p.json"), 15000, [42, 777], rows, "abc")
    jax_ = JAX["tto_protocol"].write_summary(str(tmp_path / "j.json"), 15000, [42, 777], rows, "abc")
    assert port["pass_criterion"] == jax_["pass_criterion"] and port["pass"] is jax_["pass"] is True


# --- plan_run ------------------------------------------------------------------

# (max_steps in config.yaml, logged pose steps, checkpoint steps, steps asked, config.yaml written)
PLAN_CASES = {
    "absent": None,
    "complete": (150000, [5000, 150000], [150000], 150000, True),
    "partial_with_ckpt": (150000, [5000, 100000], [50000, 100000], 150000, True),
    "partial_without_ckpt": (150000, [5000, 125000], [], 150000, True),
    "empty_ckpt_dir": (150000, [5000], "empty", 150000, True),
    "longer_schedule": (150000, [5000, 90000, 150000], [150000], 90000, True),
    "missing_config": (60000, [60000], [60000], 60000, False),
    "no_pose_logs": (4000, [], [4000], 4000, True),
}
PLAN_WANT = {"absent": "fresh", "complete": "reuse", "partial_with_ckpt": "resume", "partial_without_ckpt": "fresh",
             "empty_ckpt_dir": "fresh", "longer_schedule": "fresh", "missing_config": "fresh",
             "no_pose_logs": "resume"}


def _run_dir(root, layout, case):
    run = root / layout
    if case is None:
        return str(run)
    max_steps, logged, ckpts, _, config = case
    run.mkdir()
    if config:
        (run / "config.yaml").write_text(f"max_steps: {max_steps}\nseed: 42\n")
    with open(run / "metrics.jsonl", "w") as f:
        f.write(json.dumps({"step": 100, "loss": 0.5}) + "\n")
        for s in logged:
            f.write(json.dumps({"step": s, "train/pose_R_rel": 1.0, "train/pose_t_rel": 0.1}) + "\n")
    if ckpts:
        (run / "ckpts").mkdir()
        for c in ckpts if ckpts != "empty" else ():
            if layout == "jax":
                (run / "ckpts" / str(c)).mkdir()
            else:
                (run / "ckpts" / f"{c}.ckpt").write_bytes(b"")
    return str(run)


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_run_matches_jax(tmp_path, case):
    spec = PLAN_CASES[case]
    steps = spec[3] if spec else 100
    got = tpose.plan_run(_run_dir(tmp_path, "port", spec), steps)
    want = JAX["pose_protocol"].plan_run(_run_dir(tmp_path, "jax", spec), steps)
    assert got == want == PLAN_WANT[case]


def test_plan_run_reads_the_port_checkpoint_layout_only(tmp_path):
    # a ckpts/ directory holding the manager's journal but no checkpoint file is no checkpoint
    run = _run_dir(tmp_path, "port", (100, [50], [], 100, True))
    os.makedirs(os.path.join(run, "ckpts"))
    with open(os.path.join(run, "ckpts", "ckpt_metrics.json"), "w") as f:
        f.write("{}")
    assert tpose.plan_run(run, 100) == "fresh"
    open(os.path.join(run, "ckpts", "50.ckpt"), "wb").close()
    assert tpose.plan_run(run, 100) == "resume"


# --- records -------------------------------------------------------------------


def _pose_row(seed, steps, final=5.0):
    return {"seed": seed, "exp": f"protocol_seed{seed}", "init_rel_R_deg": 29.1, "init_rel_t": 1.0,
            "final_rel_R_deg": final, "final_rel_t": 0.1, "min_rel_R_deg": final, "steps": steps,
            "trace": [[steps, final, 0.1]]}


def _tto_row(seed, steps=15000, psnr=23.0, tto=25.0, converged=True):
    return {"seed": seed, "exp": f"tto_seed{seed}", "steps": steps, "final_val_psnr": psnr, "tto_psnr_mean": tto,
            "tto_psnr_min": tto, "tto_psnr_per_image": [tto] * 4, "tto_ssim_mean": 0.8,
            "gap_db": round(psnr - tto, 2), "pass_3db": psnr - tto <= 3.0, "n_test_images": 4,
            "init_rel_R_deg": 17.0, "final_rel_R_deg": 2.0 if converged else 8.7, "final_rel_t": 0.02,
            "train_converged": converged}


def _quality_row(seed, steps=4000, psnr=23.0):
    return {"seed": seed, "exp": f"quality_seed{seed}", "steps": steps, "final_val_psnr": psnr,
            "tto_psnr_mean": psnr - 11.0, "tto_ssim_mean": 0.3, "n_test_images": 2, "final_rel_R_deg": 24.0,
            "final_rel_t": 0.4}


def _write(module, path, rows, steps, seeds):
    if module == "pose_protocol":
        return PORT[module].write_summary, (path, "identity", steps, seeds, rows, "abc")
    if module == "tto_protocol":
        return PORT[module].write_summary, (path, steps, seeds, rows, "abc", "c2f", {"pose.c2f": (0.1, 0.8)})
    return PORT[module].write_summary, (path, steps, seeds, rows, "abc")


RECORD_CASES = {
    "pose_protocol": (lambda s, st, f=5.0: _pose_row(s, st, f), 60000),
    "tto_protocol": (lambda s, st, f=23.0: _tto_row(s, st, tto=f), 15000),
    "quality_protocol": (lambda s, st, f=23.0: _quality_row(s, st, f), 4000),
}


def _load_args(module, path, steps):
    if module == "pose_protocol":
        return [(path, "identity", steps), (path, "identity", steps + 30000), (path, "identity_hires", steps),
                (path + ".absent", "identity", steps)]
    return [(path, steps), (path, steps * 2), (path + ".absent", steps)]


@pytest.mark.parametrize("module", sorted(RECORD_CASES))
@pytest.mark.parametrize("n_done", [1, 2])
def test_write_summary_and_load_prior_runs_match_jax(tmp_path, module, n_done):
    make, steps = RECORD_CASES[module]
    rows = [make(42, steps), make(777, steps, 7.0)][:n_done]
    recs = {}
    for who, mod in (("port", PORT[module]), ("jax", JAX[module])):
        path = str(tmp_path / f"{who}.json")
        _, args = _write(module, path, rows, steps, [42, 777])
        returned = mod.write_summary(*args)
        with open(path) as f:
            recs[who] = json.load(f)
        assert returned == recs[who]
    assert recs["port"].pop("device") == "cpu"
    assert recs["port"] == recs["jax"]
    for p_args, j_args in zip(_load_args(module, str(tmp_path / "port.json"), steps),
                              _load_args(module, str(tmp_path / "jax.json"), steps)):
        assert PORT[module].load_prior_runs(*p_args) == JAX[module].load_prior_runs(*j_args)


# --- the pose perturbation -----------------------------------------------------


@pytest.mark.parametrize("recipe", ["pose", "tto"])
def test_pose_perturbation_is_jax_bit_for_bit(tmp_path, recipe):
    from upnerf.data import scene as jscene
    from upnerf.data import synthetic as jsynthetic

    from upnerf_torch.data import scene as tscene

    kwargs = tpose.RECIPES["pose"]["scene_kwargs"] if recipe == "pose" else ttto.SCENE_KWARGS
    root = str(tmp_path / "scene")
    jsynthetic.generate_scene(root, **kwargs)
    noise_file = os.path.join(root, "noises", f"{kwargs['n_train']}_0.15.npy")
    np.random.seed(42)
    jmeta = jscene.load_custom(root, 1, 0.15)
    jnoise = np.load(noise_file)
    shutil.rmtree(os.path.join(root, "noises"))  # the port draws its own
    np.random.seed(42)
    tmeta = tscene.load_custom(root, 1, 0.15)
    tnoise = np.load(noise_file)
    assert tnoise.dtype == jnoise.dtype and tnoise.tobytes() == jnoise.tobytes()
    assert tmeta.img_ids_train == jmeta.img_ids_train
    for i in jmeta.img_ids_train:
        a, b = np.asarray(jmeta.poses_dict[i]), np.asarray(tmeta.poses_dict[i])
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes(), i
        assert not np.array_equal(b, np.asarray(tmeta.GT_poses_dict[i]))


# --- pose errors on one se3 table ----------------------------------------------


class _Log:
    def __init__(self):
        self.rows = []

    def log(self, step, m):
        self.rows.append(dict(m, step=step))


@pytest.fixture(scope="module")
def pose_world(tmp_path_factory):
    """(JAX meta, port meta, se3 table) of a JAX-generated 6-view scene with
    pose.noise 0.15, and a seeded se3 table of the size of a mid-run one."""
    import jax

    from upnerf.data import scene as jscene
    from upnerf.data import synthetic as jsynthetic

    from upnerf_torch.data import scene as tscene

    jax.config.update("jax_platforms", "cpu")
    root = str(tmp_path_factory.mktemp("pose_world") / "scene")
    # cameras at varying heights: a ring at one height leaves pose_metric's centre-only Procrustes bistable
    jsynthetic.generate_scene(root, n_train=6, n_test=1, H=16, W=20, feat_hw=4, feat_dim=4, focal=16.0, arc=0.5)
    meta_path = os.path.join(root, "metadata.json")
    with open(meta_path) as f:
        md = json.load(f)
    for k, v in md.items():
        if isinstance(v, dict) and "c2w" in v:
            v["c2w"][1][3] += 0.1 * (int(k) % 3)
    with open(meta_path, "w") as f:
        json.dump(md, f)
    jmeta = jscene.load_custom(root, 1, 0.15)
    tmeta = tscene.load_custom(root, 1, 0.15)
    table = (np.random.RandomState(5).randn(6, 6) * 0.05).astype(np.float32)
    return jmeta, tmeta, table


def _jax_stub(jmeta, table):
    import jax.numpy as jnp

    state = types.SimpleNamespace(pose_params={"se3": jnp.asarray(table)}, step=123)
    return types.SimpleNamespace(meta=jmeta, state=state, debug=True, is_main=True, logger=_Log(),
                                 ckpt=types.SimpleNamespace(restore=lambda s: s))


def _port_stub(tmeta, table):
    weight = torch.nn.Parameter(torch.from_numpy(table.copy()))
    state = types.SimpleNamespace(pose_params=types.SimpleNamespace(se3_refine=types.SimpleNamespace(weight=weight)),
                                  step=123)
    return types.SimpleNamespace(meta=tmeta, state=state, debug=True, is_main=True, logger=_Log())


def test_log_pose_matches_jax_on_one_se3_table(pose_world):
    from upnerf.train.loop import Trainer as JaxTrainer

    from upnerf_torch.train.loop import Trainer

    jmeta, tmeta, table = pose_world
    js, ts = _jax_stub(jmeta, table), _port_stub(tmeta, table)
    JaxTrainer.log_pose(js, 7)
    Trainer.log_pose(ts, 7)
    (j,), (t,) = js.logger.rows, ts.logger.rows
    assert set(t) == set(j)
    assert abs(t["train/pose_R_rel"] - j["train/pose_R_rel"]) <= 1e-5
    assert abs(t["train/pose_t_rel"] - j["train/pose_t_rel"]) <= 1e-6
    assert j["train/pose_R_rel"] > 1.0  # the table moves the poses


def test_analyze_pose_recovery_matches_jax_on_one_se3_table(pose_world, tmp_path, monkeypatch, capsys):
    import upnerf.geometry.procrustes as jprocrustes
    import upnerf.train.loop as jloop

    jmeta, tmeta, table = pose_world
    captured = {}
    real = jprocrustes.relative_pose_error

    def spy(*a, **k):
        captured["rel"] = real(*a, **k)
        return captured["rel"]

    monkeypatch.setattr(jprocrustes, "relative_pose_error", spy)
    monkeypatch.setattr(jloop, "Trainer", lambda hp: _jax_stub(jmeta, table))
    (tmp_path / "config.yaml").write_text("max_steps: 10\n")
    _load_jax("analyze_pose_recovery").main(str(tmp_path))
    jax_lines = capsys.readouterr().out.strip().splitlines()[1:]  # after "checkpoint step"

    b = tanalyze.breakdown(*tanalyze.refined_and_gt(_port_stub(tmeta, table)))
    R_jax = np.asarray(captured["rel"]["R"]) * 180 / math.pi
    # Each pair's angle is the arccos of a float32 trace, which each library rounds its own way: one ulp of
    # cos(theta) moves theta by ulp / sin(theta), ~6e-6 deg at 40 deg and ~3e-5 deg at 7. Each pair within 4 such
    # ulps; the pairwise mean (the logged train/pose_R_rel) within 1e-5 deg, a camera's mean within 2e-5.
    cos_ulp = np.spacing(np.cos(np.deg2rad(R_jax)).astype(np.float32)).astype(np.float64)
    assert (np.abs(b["R_deg"] - R_jax) <= np.rad2deg(4 * cos_ulp / np.sin(np.deg2rad(R_jax)))).all()
    assert abs(b["R_deg"].mean() - R_jax.mean()) <= 1e-5
    n = len(b["per_cam"])
    iu, ju = np.triu_indices(n, k=1)
    per_cam_jax = np.array([R_jax[(iu == c) | (ju == c)].mean() for c in range(n)])
    np.testing.assert_allclose(b["per_cam"], per_cam_jax, rtol=0, atol=2e-5)
    np.testing.assert_allclose(b["t"], np.asarray(captured["rel"]["t"]), rtol=0, atol=1e-6)
    lines = tanalyze.report(b)
    assert len(lines) == len(jax_lines)
    num = re.compile(r"-?\d+\.?\d*")
    for ours, theirs in zip(lines, jax_lines):
        assert num.sub("#", ours) == num.sub("#", theirs)
        np.testing.assert_allclose([float(x) for x in num.findall(ours)], [float(x) for x in num.findall(theirs)],
                                   rtol=0, atol=0.0101)


# --- the drivers end to end ----------------------------------------------------

TINY_CONFIG = (
    "dataset_name: 'custom'\n"
    "scene_name: 'synth'\n"
    "exp_name: 'tiny'\n"
    "root_dir: 'outputs_validation/scene'\n"
    "feat_dir: 'outputs_validation/scene/DINO'\n"
    "depth_dir: 'outputs_validation/scene/DPT'\n"
    "out_dir: '{out}'\n"
    "max_steps: 4\n"
    "debug: True\n"
    "phototourism:\n  img_downscale: 1\n  use_cache: False\n"
    "nerf:\n  N_samples: 8\n  N_importance: 8\n  feat_dim: 8\n  D: 2\n  W: 32\n  skips: []\n"
    "t_net:\n  feat_dim: 8\n"
    "pose:\n  noise: 0.15\n"
    "train:\n  batch_size: 64\n  ckpt_interval: 4\n  log_pose_interval: 2\n"
    "val:\n  log_interval: 4\n  chunk_size: 256\n"
)
TINY_SCENE = dict(n_train=4, n_test=2, H=24, W=32, feat_hw=8, feat_dim=8, focal=24.0)
TINY_TTO_KW = dict(batch_size=64, group_size=2, pose_epochs=1, appearance_epochs=1)
COMMON = ["--seeds", "42", "--device", "cpu", "--out", "records", "--work", "outputs_validation"]


def _tiny_config(tmp_path, out: str) -> str:
    path = tmp_path / "cfg.yaml"
    path.write_text(TINY_CONFIG.format(out=out))
    return str(path)


def _keys_equal(port_rec: dict, jax_rec: dict) -> None:
    assert port_rec["device"] == "cpu"
    assert set(port_rec) == set(jax_rec) | {"device"}
    assert [set(r) for r in port_rec["runs"]] == [set(r) for r in jax_rec["runs"]]
    assert port_rec["runs"] == jax_rec["runs"]


def test_pose_protocol_end_to_end(tmp_path, monkeypatch, capsys):
    # 500 steps: the recipe logs its rel-R every max(500, steps // 30) steps
    monkeypatch.chdir(tmp_path)
    recipe = dict(config=_tiny_config(tmp_path, "outputs_validation/out"),
                  scene_dir="outputs_validation/scene_pose32", scene_kwargs=TINY_SCENE,
                  overrides={"pose.noise": 0.15, "pose.c2f": (0.1, 0.8)}, default_steps=500)
    monkeypatch.setitem(tpose.RECIPES, "tiny", recipe)
    argv = ["--recipe", "tiny", "--tag", "_t"] + COMMON
    got = tpose.main(argv)
    with open("records/pose_protocol_tiny_t.json") as f:
        rec = json.load(f)
    assert rec == got and "partial" not in rec and rec["steps"] == 500
    (run,) = rec["runs"]
    assert run["exp"] == "protocol_tiny_t_seed42" and [r[0] for r in run["trace"]] == [500]
    run_dir = os.path.join("outputs_validation", "out", "synth", run["exp"])
    from upnerf_torch.config import load

    assert load(os.path.join(run_dir, "config.yaml"))["pose.c2f"] == (0.1, 0.8)  # the tuple override, as a list

    # the JAX driver summarizes the same run directory (plan reuse: it trains nothing)
    jrow = JAX["pose_protocol"].run_one(recipe, "tiny", 42, 500, "_t")
    jrec = JAX["pose_protocol"].write_summary(str(tmp_path / "jax.json"), "tiny", 500, [42], [jrow], "abc")
    _keys_equal(rec, jrec)

    # the port's driver again: reused, the same row; the per-camera breakdown of the run
    capsys.readouterr()
    assert tpose.main(argv)["runs"] == rec["runs"]
    assert "plan for " + run_dir + ": reuse" in capsys.readouterr().out
    b = tanalyze.main([run_dir, "--device", "cpu"])
    assert b["per_cam"].shape == (4,) and np.isfinite(b["R_deg"]).all()
    assert abs(b["R_deg"].mean() - run["final_rel_R_deg"]) <= 0.005 + 1e-6


class _OrbaxStub:
    """upnerf.utils.ckpt.CheckpointManager over the port's layout (the JAX
    driver reads only the latest step)."""

    def __init__(self, directory, *a, **k):
        from upnerf_torch.utils.ckpt import CheckpointManager

        self._m = CheckpointManager(directory)

    def latest_step(self):
        return self._m.latest_step()

    def close(self):
        pass


def test_tto_protocol_end_to_end(tmp_path, monkeypatch):
    import upnerf.utils.ckpt as jckpt

    monkeypatch.chdir(tmp_path)
    cfg = _tiny_config(tmp_path, "outputs_validation/out_tto")
    scene = dict(TINY_SCENE, interleave_test=True)
    for mod in (ttto, JAX["tto_protocol"]):
        monkeypatch.setattr(mod, "CONFIG", cfg)
        monkeypatch.setattr(mod, "SCENE_KWARGS", scene)
        monkeypatch.setattr(mod, "TTO_KW", TINY_TTO_KW)
    argv = ["--steps", "4"] + COMMON
    got = ttto.main(argv)
    with open("records/tto_quality_protocol.json") as f:
        rec = json.load(f)
    assert rec == got and "partial" not in rec
    (run,) = rec["runs"]
    assert run["n_test_images"] == 2 and np.isfinite(run["tto_psnr_per_image"]).all()
    assert np.isfinite(run["tto_ssim_mean"]) and "train_converged" in run

    monkeypatch.setattr(jckpt, "CheckpointManager", _OrbaxStub)
    jrow = JAX["tto_protocol"].run_one(42, 4)  # plan reuse, TTO stamped: it trains and optimizes nothing
    jrec = JAX["tto_protocol"].write_summary(str(tmp_path / "jax.json"), 4, [42], [jrow], "abc")
    _keys_equal(rec, jrec)

    # the work directory gone: the record's seed is reused
    shutil.rmtree("outputs_validation")
    again = ttto.main(argv)
    assert again["runs"][0]["reused_from_artifact"] is True
    assert again["runs"][0]["final_val_psnr"] == run["final_val_psnr"]
    assert not os.path.isdir("outputs_validation/out_tto")


def test_quality_protocol_end_to_end(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _tiny_config(tmp_path, "outputs_validation/out_quality")
    for mod in (tqual, JAX["quality_protocol"]):
        monkeypatch.setattr(mod, "CONFIG", cfg)
        monkeypatch.setattr(mod, "SCENE_KWARGS", dict(TINY_SCENE, n_train=3, n_test=1))
        monkeypatch.setattr(mod, "TTO_KW", TINY_TTO_KW)
    argv = ["--steps", "4"] + COMMON
    got = tqual.main(argv)
    with open("records/quality_protocol_synth_small.json") as f:
        rec = json.load(f)
    assert rec == got and "partial" not in rec
    (run,) = rec["runs"]
    assert run["n_test_images"] == 1 and np.isfinite(run["tto_psnr_mean"])

    jrow = JAX["quality_protocol"].run_one(42, 4)  # plan reuse, TTO metrics present: nothing runs
    jrec = JAX["quality_protocol"].write_summary(str(tmp_path / "jax.json"), 4, [42], [jrow], "abc")
    _keys_equal(rec, jrec)


# --- the drivers' rules ----------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["pose_protocol", "--recipe", "pose"],
    ["tto_protocol"],
    ["quality_protocol"],
    ["analyze_pose_recovery", "nowhere"],
], ids=lambda a: a[0])
def test_drivers_default_to_the_card(tmp_path, monkeypatch, argv):
    # without a card, the default --device cuda fails before any work
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"pose_protocol": tpose, "tto_protocol": ttto, "quality_protocol": tqual,
           "analyze_pose_recovery": tanalyze}[argv[0]]
    extra = [] if argv[0] == "analyze_pose_recovery" else ["--out", "r", "--work", "w"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv[1:] + extra)
    assert os.listdir(tmp_path) == []


def test_drivers_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n" + "".join(f"import upnerf_torch.scripts.{d}\n" for d in DRIVERS)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'upnerf', 'scripts'))\n"
            + "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120,
                   env=dict(os.environ, PYTHONPATH=REPO))


def test_protocol_table_sets_records_beside_the_jax_records(tmp_path):
    bench = os.path.join(REPO, "benchmarks")
    before = {p: os.path.getmtime(os.path.join(bench, p)) for p in os.listdir(bench)}
    with open(os.path.join(bench, "pose_protocol_pose.json")) as f:
        jax_pose = json.load(f)
    records = tmp_path / "records"
    tpose.write_summary(str(records / "pose_protocol_pose.json"), "pose", 15000, [42, 777, 1234],
                        [_pose_row(s, 15000, f) for s, f in ((42, 2.5), (777, 3.0), (1234, 4.5))], "abc")
    tpose.write_summary(str(records / "pose_protocol_pose_c2f_smoke.json"), "pose_c2f", 500, [42],
                        [_pose_row(42, 500, 9.0)], "abc")
    table = ttable.main(["--records", str(records)]).splitlines()
    assert len(table) == 4
    row = next(line for line in table if line.startswith("| pose_protocol_pose |"))
    assert "3.00 [2.50-4.50]" in row and f"{jax_pose['final_rel_R_deg']['median']:.2f}" in row
    assert row.endswith("| cpu | yes |")
    assert next(line for line in table if "c2f_smoke" in line).endswith("| - | - | cpu | no |")
    assert {p: os.path.getmtime(os.path.join(bench, p)) for p in os.listdir(bench)} == before
