"""Seed-protocoled pose-recovery benchmarks on the port (scripts/pose_protocol.py).

    python -m upnerf_torch.scripts.pose_protocol --recipe pose [--seeds 42,777,1234] [--steps N] [--tag T]
        [--device cuda] [--out protocols_torch] [--work outputs_torch]

Trains each seed of a recipe through `upnerf_torch.cli.train` and records the
final gauge-free pose errors (train/pose_R_rel, train/pose_t_rel, the only
numbers that judge convergence: the Procrustes ones are reflection-bistable
on camera rings) with each run's descent trace, in
<out>/pose_protocol_<recipe><tag>.json after every seed. The record has the
JAX script's keys plus "device": the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints them,
or "cpu". The recipe table is the JAX script's. The scenes
(`upnerf_torch.data.synthetic`, PNGs) and the run directories live under
--work, at the JAX script's paths with `outputs_validation/` replaced by it.

A seed is idempotent (plan_run): a run whose metric log reaches the steps is
summarized without training; a partial run with a checkpoint resumes through
the Trainer's restore; a seed whose run directory is gone is taken from the
record when it was measured under the same recipe and schedule. The device is
the card unless --device cpu is given; a failing run exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
from typing import Any, Dict, List, Optional

import numpy as np

OUT = "protocols_torch"
WORK = "outputs_torch"

RECIPES = {
    # synth_pose + pose.noise 0.15 + >= 15k steps on a feat_hw=32 scene
    # (rel-R ~17 deg -> 1-4 deg; the final fine alignment is basin / seed
    # dependent below ~5 deg)
    "pose": {
        "config": "configs/validation/synth_pose.yaml",
        "scene_dir": "outputs_validation/scene_pose32",
        "scene_kwargs": dict(
            n_train=16, n_test=2, H=64, W=80, feat_hw=32, feat_dim=32,
            focal=80.0, arc=0.5,
        ),
        "overrides": {"pose.noise": 0.15},
        "default_steps": 15000,
    },
    # identity-init recovery: 32-view 90-degree arc, world-anchored
    # features, identity pose init
    "identity": {
        "config": "configs/validation/synth_identity.yaml",
        "scene_dir": "outputs_validation/scene_identity",
        "scene_kwargs": dict(
            n_train=32, n_test=2, H=128, W=160, feat_hw=32, feat_dim=32,
            focal=160.0, arc=0.25, feature_mode="world",
        ),
        "overrides": {},
        "default_steps": 60000,
    },
    # 2x resolution and 2x ray budget
    "identity_hires": {
        "config": "configs/validation/synth_identity.yaml",
        "scene_dir": "outputs_validation/scene_identity_hi",
        "scene_kwargs": dict(
            n_train=32, n_test=2, H=256, W=320, feat_hw=64, feat_dim=32,
            focal=320.0, arc=0.25, feature_mode="world",
        ),
        "overrides": {"train.batch_size": 2048},
        "default_steps": 90000,
    },
    # a longer coarse-to-fine PE anneal ([0.1, 0.8] against [0.1, 0.5])
    "identity_hires_c2f": {
        "config": "configs/validation/synth_identity.yaml",
        "scene_dir": "outputs_validation/scene_identity_hi",
        "scene_kwargs": dict(
            n_train=32, n_test=2, H=256, W=320, feat_hw=64, feat_dim=32,
            focal=320.0, arc=0.25, feature_mode="world",
        ),
        "overrides": {"train.batch_size": 2048, "pose.c2f": (0.1, 0.8)},
        "default_steps": 90000,
    },
    # the longer anneal on the perturbation-recovery recipe
    "pose_c2f": {
        "config": "configs/validation/synth_pose.yaml",
        "scene_dir": "outputs_validation/scene_pose32",
        "scene_kwargs": dict(
            n_train=16, n_test=2, H=64, W=80, feat_hw=32, feat_dim=32,
            focal=80.0, arc=0.5,
        ),
        "overrides": {"pose.noise": 0.15, "pose.c2f": (0.1, 0.8)},
        "default_steps": 15000,
    },
    # the next point on the anneal-length curve
    "identity_hires_c2f9": {
        "config": "configs/validation/synth_identity.yaml",
        "scene_dir": "outputs_validation/scene_identity_hi",
        "scene_kwargs": dict(
            n_train=32, n_test=2, H=256, W=320, feat_hw=64, feat_dim=32,
            focal=320.0, arc=0.25, feature_mode="world",
        ),
        "overrides": {"train.batch_size": 2048, "pose.c2f": (0.1, 0.9)},
        "default_steps": 90000,
    },
    # feature-space coarse-to-fine: a Gaussian-smoothed pyramid level of the
    # feature targets early, full resolution by 70% of the run
    "identity_hires_featc2f": {
        "config": "configs/validation/synth_identity.yaml",
        "scene_dir": "outputs_validation/scene_identity_hi",
        "scene_kwargs": dict(
            n_train=32, n_test=2, H=256, W=320, feat_hw=64, feat_dim=32,
            focal=320.0, arc=0.25, feature_mode="world",
        ),
        "overrides": {"train.batch_size": 2048,
                      "feat.c2f": (0.0, 0.7), "feat.pyramid_sigma": 3.0},
        "default_steps": 90000,
    },
}


def work_path(path: str, work: str) -> str:
    """A JAX script's scratch path (outputs_validation/...) under --work; any
    other path as it is."""
    head, _, rest = path.partition("/")
    return os.path.join(work, rest) if head == "outputs_validation" and rest else path


def device_stamp(device: str) -> str:
    """The record's "device": nvidia-smi's name and power limit of the card,
    or "cpu". Raises when --device cuda finds no card."""
    import torch

    if torch.device(device).type == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    from upnerf_torch.scripts.bench_mxu_probe import card_line

    return card_line()


def git_commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True,
                              cwd=os.path.dirname(os.path.abspath(__file__))).stdout.strip()
    except Exception:
        return ""


def _arg(v: Any) -> str:
    """A `key value` override's value as cli.train reads it (a tuple as a
    YAML flow list)."""
    if isinstance(v, (tuple, list)):
        return "[" + ", ".join(str(x) for x in v) + "]"
    return str(v)


def train(config: str, overrides: Dict[str, Any], device: str) -> None:
    """`upnerf_torch.cli.train` on `config` with `overrides`, in this process."""
    from upnerf_torch.cli.train import main as train_main

    argv = ["--config", config, "--device", device]
    for k, v in overrides.items():
        argv += [k, _arg(v)]
    train_main(argv)


def artifact_path(recipe_name: str, tag: str, out: str = OUT) -> str:
    return os.path.join(out, f"pose_protocol_{recipe_name}{tag}.json")


def load_prior_runs(path: str, recipe_name: str, steps: int) -> dict:
    """Completed per-seed results of an existing (possibly partial) record,
    keyed by seed; only runs of the same recipe and schedule (max_steps
    drives the lr / c2f / candidate schedules)."""
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            prior = json.load(f)
    except (json.JSONDecodeError, OSError):
        return {}
    if prior.get("recipe") != recipe_name or prior.get("steps") != steps:
        return {}
    return {r["seed"]: r for r in prior.get("runs", []) if r.get("steps") == steps and "trace" in r}


def write_summary(out: str, recipe_name: str, steps: int, seeds: list, results: list, commit: str,
                  device: str = "cpu") -> dict:
    """Write the record after every completed seed; a partial one carries
    "partial": true and the seeds still missing."""
    finals = np.array([r["final_rel_R_deg"] for r in results])
    finals_t = np.array([r["final_rel_t"] for r in results])
    done = [r["seed"] for r in results]
    summary = {
        "recipe": recipe_name,
        "steps": steps,
        "seeds": seeds,
        "git_commit": commit,
        "device": device,
        "final_rel_R_deg": {
            "median": round(float(np.median(finals)), 2),
            "min": round(float(finals.min()), 2),
            "max": round(float(finals.max()), 2),
        },
        "final_rel_t": {
            "median": round(float(np.median(finals_t)), 3),
            "min": round(float(finals_t.min()), 3),
            "max": round(float(finals_t.max()), 3),
        },
        "runs": results,
    }
    missing = [s for s in seeds if s not in done]
    if missing:
        summary["partial"] = True
        summary["seeds_missing"] = missing
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=2)
    os.replace(tmp, out)
    return summary


def plan_run(run_dir: str, steps: int) -> str:
    """'reuse' (complete, same schedule), 'resume' (partial with a checkpoint
    `ckpts/<step>.ckpt`, same schedule) or 'fresh' (absent, another schedule,
    or partial without a checkpoint)."""
    from upnerf_torch.config import yaml_subset
    from upnerf_torch.utils.ckpt import _NAME

    mfile = os.path.join(run_dir, "metrics.jsonl")
    cfg_file = os.path.join(run_dir, "config.yaml")
    if not (os.path.exists(mfile) and os.path.exists(cfg_file)):
        return "fresh"
    with open(cfg_file) as f:
        saved = yaml_subset.safe_load(f.read()) or {}
    if int(saved.get("max_steps", -1)) != steps:
        return "fresh"
    with open(mfile) as f:
        prev = [json.loads(line) for line in f if "pose_R_rel" in line]
    if prev and prev[-1]["step"] >= steps:
        return "reuse"
    ckpt_dir = os.path.join(run_dir, "ckpts")
    if os.path.isdir(ckpt_dir) and any(_NAME.match(n) for n in os.listdir(ckpt_dir)):
        return "resume"
    return "fresh"


def run_one(recipe: dict, recipe_name: str, seed: int, steps: int, tag: str, prior: Optional[dict] = None,
            device: str = "cuda", work: str = WORK) -> dict:
    """One training run; returns {seed, init / final rel-R (deg) and rel-t,
    the trace}. Raises when the run stopped short of its steps."""
    from upnerf_torch.config import default, merge_from_file

    hp = default()
    merge_from_file(hp, recipe["config"])
    scene = work_path(recipe["scene_dir"], work)
    # the JAX script's run names: the first three recipes without a recipe infix
    infix = "" if recipe_name in ("pose", "identity", "identity_hires") else f"_{recipe_name}"
    exp = f"protocol{infix}{tag}_seed{seed}"
    out_dir = work_path(hp["out_dir"], work)
    overrides = dict(recipe["overrides"])
    overrides.update({
        "seed": seed,
        "exp_name": exp,
        "max_steps": steps,
        "root_dir": scene,
        "feat_dir": os.path.join(scene, "DINO"),
        "depth_dir": os.path.join(scene, "DPT"),
        "out_dir": out_dir,
        # pose logging is the measurement; everything else is kept cheap
        "train.log_pose_interval": max(500, steps // 30),
        "val.log_interval": 10**9,
        "train.ckpt_interval": min(steps, 50000),
    })

    run_dir = os.path.join(out_dir, hp["scene_name"], exp)
    mfile = os.path.join(run_dir, "metrics.jsonl")
    plan = plan_run(run_dir, steps)
    print(f"[protocol]   plan for {run_dir}: {plan}", flush=True)
    if plan == "fresh" and prior is not None:
        print(f"[protocol]   seed {seed}: reusing the record's run", flush=True)
        return dict(prior, reused_from_artifact=True)
    if plan == "fresh" and os.path.isdir(run_dir):
        shutil.rmtree(run_dir)
    if plan != "reuse":
        np.random.seed(seed)
        train(recipe["config"], overrides, device)

    with open(mfile) as f:
        rows = [json.loads(line) for line in f if "pose_R_rel" in line]
    rows = [r for r in rows if r["step"] <= steps]
    if not rows:
        raise RuntimeError(f"no pose logs in {mfile}")
    # a preempted run checkpoints and returns: its trajectory is not final
    log_int = max(500, steps // 30)
    if rows[-1]["step"] < (steps // log_int) * log_int:
        raise RuntimeError(f"run {run_dir} stopped at step {rows[-1]['step']} < {steps} (preempted?); re-issue to"
                           " resume from its checkpoint")
    first, last = rows[0], rows[-1]
    return {
        "seed": seed,
        "exp": exp,
        "init_rel_R_deg": round(first["train/pose_R_rel"], 2),
        "init_rel_t": round(first["train/pose_t_rel"], 3),
        "final_rel_R_deg": round(last["train/pose_R_rel"], 2),
        "final_rel_t": round(last["train/pose_t_rel"], 3),
        "min_rel_R_deg": round(min(r["train/pose_R_rel"] for r in rows), 2),
        "steps": steps,
        "trace": [[int(r["step"]), round(r["train/pose_R_rel"], 2), round(r["train/pose_t_rel"], 3)] for r in rows],
    }


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recipe", choices=sorted(RECIPES), required=True)
    ap.add_argument("--seeds", default="42,777,1234")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT, help="directory of the records")
    ap.add_argument("--work", default=WORK, help="directory of the scenes and run directories")
    args = ap.parse_args(argv)

    recipe = RECIPES[args.recipe]
    seeds = [int(s) for s in args.seeds.split(",")]
    # the protocol proper is >= 3 seeds; a --tag'd study may use fewer
    if len(seeds) < 3 and not args.tag:
        ap.error("the protocol requires >= 3 seeds (or pass --tag for a study extension)")
    steps = args.steps or recipe["default_steps"]
    device = device_stamp(args.device)

    scene = work_path(recipe["scene_dir"], args.work)
    if not os.path.isdir(scene):
        from upnerf_torch.data import synthetic

        print(f"[protocol] generating scene {scene}", flush=True)
        synthetic.generate_scene(scene, **recipe["scene_kwargs"])

    out = artifact_path(args.recipe, args.tag, args.out)
    prior_runs = load_prior_runs(out, args.recipe, steps)
    if prior_runs:
        print(f"[protocol] prior record holds seeds {sorted(prior_runs)} at {steps} steps", flush=True)

    commit = git_commit()
    results = []
    for seed in seeds:
        print(f"[protocol] {args.recipe} seed {seed} ({steps} steps)...", flush=True)
        results.append(run_one(recipe, args.recipe, seed, steps, args.tag, prior_runs.get(seed), args.device,
                               args.work))
        print(f"[protocol]   -> {results[-1]}", flush=True)
        summary = write_summary(out, args.recipe, steps, seeds, results, commit, device)
        print(f"[protocol] wrote {out} ({len(results)}/{len(seeds)} seeds)", flush=True)

    print(json.dumps(summary["final_rel_R_deg"]), flush=True)
    return summary


if __name__ == "__main__":
    main()
