"""Seed-protocoled end-to-end quality benchmark on the port: train -> tto ->
eval on the synth_small scene (scripts/quality_protocol.py).

    python -m upnerf_torch.scripts.quality_protocol [--seeds 42,777] [--steps 4000]
        [--device cuda] [--out protocols_torch] [--work outputs_torch]

The reference's evaluation protocol (train, then TTO, then eval) through
`upnerf_torch.cli.train`, `cli.tto` on the last checkpoint and `cli.eval`,
across seeds: the final validation PSNR from training, the per-test-image
PSNR / SSIM after test-time optimization and the gauge-free train-pose
errors. Writes <out>/quality_protocol_synth_small.json after every seed, with
the JAX script's keys plus "device" (nvidia-smi's name and power limit, or
"cpu"), and reuses a finished run, its TTO result, and a seed of the record
whose run directory is gone. Scenes and runs live under --work. The device
is the card unless --device cpu is given; a failing run exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import List, Optional

import numpy as np

from upnerf_torch.scripts.pose_protocol import OUT, WORK, device_stamp, git_commit, plan_run, train, work_path
from upnerf_torch.scripts.tto_protocol import tto_and_eval

SCENE_DIR = "outputs_validation/scene"
SCENE_KWARGS = dict(
    n_train=8, n_test=2, H=64, W=80, feat_hw=16, feat_dim=32, focal=80.0,
)
CONFIG = "configs/validation/synth_small.yaml"
OUT_DIR = "outputs_validation/out_quality"
ARTIFACT = "quality_protocol_synth_small.json"
TTO_KW = dict(batch_size=1024, group_size=4, pose_epochs=50,
              appearance_epochs=20)


def run_one(seed: int, steps: int, device: str = "cuda", work: str = WORK) -> dict:
    """train -> tto -> eval for one seed; returns the quality row."""
    from upnerf_torch.config import default, merge_from_file

    hp = default()
    merge_from_file(hp, CONFIG)
    exp = f"quality_seed{seed}"
    scene, out_dir = work_path(SCENE_DIR, work), work_path(OUT_DIR, work)
    train_kw = {
        "seed": seed,
        "exp_name": exp,
        "max_steps": steps,
        "root_dir": scene,
        "feat_dir": os.path.join(scene, "DINO"),
        "depth_dir": os.path.join(scene, "DPT"),
        "out_dir": out_dir,
    }

    run_dir = os.path.join(out_dir, hp["scene_name"], exp)
    plan = plan_run(run_dir, steps)
    print(f"[quality]   plan for {run_dir}: {plan}", flush=True)
    if plan == "fresh" and os.path.isdir(run_dir):
        shutil.rmtree(run_dir)
    if plan != "reuse":
        np.random.seed(seed)
        train(CONFIG, train_kw, device)

    mfile = os.path.join(run_dir, "metrics.jsonl")
    with open(mfile) as f:
        rows = [json.loads(line) for line in f]
    val = [r for r in rows if "val/psnr" in r]
    if not val:
        raise RuntimeError(f"no val logs in {mfile}")
    pose = [r for r in rows if "train/pose_R_rel" in r]

    reusable = os.path.isfile(os.path.join(run_dir, "a_optimize", "metrics.json"))
    tto = tto_and_eval(run_dir, steps, TTO_KW, device, reusable)

    row = {
        "seed": seed,
        "exp": exp,
        "steps": steps,
        "final_val_psnr": round(val[-1]["val/psnr"], 2),
        "tto_psnr_mean": round(float(np.mean([v["psnr"] for v in tto.values()])), 2),
        "tto_ssim_mean": round(float(np.mean([v["ssim"] for v in tto.values()])), 4),
        "n_test_images": len(tto),
    }
    if pose:
        row["final_rel_R_deg"] = round(pose[-1]["train/pose_R_rel"], 2)
        row["final_rel_t"] = round(pose[-1]["train/pose_t_rel"], 3)
    return row


def write_summary(out: str, steps: int, seeds: list, results: list, commit: str, device: str = "cpu") -> dict:
    def stats(key, nd=2):
        vals = np.array([r[key] for r in results])
        return {
            "median": round(float(np.median(vals)), nd),
            "min": round(float(vals.min()), nd),
            "max": round(float(vals.max()), nd),
        }

    summary = {
        "recipe": "quality_synth_small",
        "steps": steps,
        "seeds": seeds,
        "git_commit": commit,
        "device": device,
        "final_val_psnr": stats("final_val_psnr"),
        "tto_psnr_mean": stats("tto_psnr_mean"),
        "tto_ssim_mean": stats("tto_ssim_mean", nd=4),
        "runs": results,
    }
    missing = [s for s in seeds if s not in [r["seed"] for r in results]]
    if missing:
        summary["partial"] = True
        summary["seeds_missing"] = missing
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=2)
    os.replace(tmp, out)
    return summary


def load_prior_runs(path: str, steps: int) -> dict:
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            prior = json.load(f)
    except (json.JSONDecodeError, OSError):
        return {}
    if prior.get("recipe") != "quality_synth_small" or prior.get("steps") != steps:
        return {}
    return {r["seed"]: r for r in prior.get("runs", []) if r.get("steps") == steps}


def main(argv: Optional[List[str]] = None) -> dict:
    from upnerf_torch.config import default, merge_from_file

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="42,777")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT, help="directory of the records")
    ap.add_argument("--work", default=WORK, help="directory of the scene and run directories")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    artifact = os.path.join(args.out, ARTIFACT)
    device = device_stamp(args.device)

    scene = work_path(SCENE_DIR, args.work)
    if not os.path.isdir(scene):
        from upnerf_torch.data import synthetic

        print(f"[quality] generating scene {scene}", flush=True)
        synthetic.generate_scene(scene, **SCENE_KWARGS)

    hp_probe = default()
    merge_from_file(hp_probe, CONFIG)
    runs_root = os.path.join(work_path(OUT_DIR, args.work), hp_probe["scene_name"])

    commit = git_commit()
    prior_runs = load_prior_runs(artifact, args.steps)
    results = []
    for seed in seeds:
        print(f"[quality] seed {seed} ({args.steps} steps)...", flush=True)
        if seed in prior_runs and plan_run(os.path.join(runs_root, f"quality_seed{seed}"), args.steps) == "fresh":
            print(f"[quality]   seed {seed}: reusing the record's run", flush=True)
            results.append(dict(prior_runs[seed], reused_from_artifact=True))
        else:
            results.append(run_one(seed, args.steps, args.device, args.work))
        print(f"[quality]   -> {results[-1]}", flush=True)
        summary = write_summary(artifact, args.steps, seeds, results, commit, device)
        print(f"[quality] wrote {artifact} ({len(results)}/{len(seeds)} seeds)", flush=True)

    print(json.dumps({k: summary[k] for k in ("final_val_psnr", "tto_psnr_mean", "tto_ssim_mean")}), flush=True)
    return summary


if __name__ == "__main__":
    main()
