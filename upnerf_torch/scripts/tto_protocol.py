"""TTO-success benchmark on the port: train -> tto -> eval on a scene where
TTO is expected to land near validation quality (scripts/tto_protocol.py).

    python -m upnerf_torch.scripts.tto_protocol [--seeds 42,777] [--steps 15000] [--recipe baseline]
        [--tag T] [--device cuda] [--out protocols_torch] [--work outputs_torch]

A 32-view arc=0.5 ring, pose.noise 0.15, 15k steps (rel-R converges to 1-4
deg), 4 test views interleaved between the train views, and the whole
pipeline as a user runs it: `upnerf_torch.cli.train`, then `cli.tto` on the
last checkpoint (sim(3) test-pose init, grouped phases A / B, the left /
right split), then `cli.eval`. Success: every seed whose training converged
(final rel-R < CONVERGED_REL_R_DEG) has a post-TTO right-half PSNR within
PASS_GAP_DB of its training val PSNR, and at least one seed converged.

Writes <out>/tto_quality_protocol[_<recipe>][_<tag>].json after every seed,
with the JAX script's keys plus "device" (nvidia-smi's name and power limit,
or "cpu"); reuses a finished run, a stamped TTO result of this protocol
revision and TTO settings, and a seed of the record whose run directory is
gone. Scenes and runs live under --work. The device is the card unless
--device cpu is given; a failing run exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import List, Optional

import numpy as np

from upnerf_torch.scripts.pose_protocol import OUT, WORK, device_stamp, git_commit, plan_run, train, work_path

SCENE_DIR = "outputs_validation/scene_tto"
SCENE_KWARGS = dict(
    n_train=32, n_test=4, H=64, W=80, feat_hw=32, feat_dim=32, focal=80.0,
    arc=0.5, interleave_test=True,
)
CONFIG = "configs/validation/synth_tto.yaml"
OUT_DIR = "outputs_validation/out_tto"
ARTIFACT = "tto_quality_protocol.json"
# rev 2: orientation-based sim(3) gauge, last + best checkpoint retention,
# phase epochs scaled to the reference's step count (an epoch here is 5
# steps: 400 x 5 = 2000 + anneal)
PROTOCOL_REV = 2
TTO_KW = dict(batch_size=1024, group_size=4, pose_epochs=400,
              appearance_epochs=40, eval_every=10, pose_anneal=0.4)
# training-recipe variants (the basin-stall levers); each trains under its
# own exp tag and writes its own record; TTO / eval settings are identical
TRAIN_RECIPES = {
    "baseline": {},
    "c2f": {"pose.c2f": (0.1, 0.8)},
    "multistart": {"pose.warp.mitigate": "multistart"},
    "c2f_multistart": {"pose.c2f": (0.1, 0.8),
                       "pose.warp.mitigate": "multistart"},
    "reset": {"pose.warp.mitigate": "reset", "pose.warp.max_events": 8},
    "reset_early": {
        "pose.c2f": (0.1, 0.8),
        "pose.warp.mitigate": "reset",
        "pose.warp.ratio": 1.9,
        "pose.warp.min_progress": 0.5,
        "pose.warp.max_progress": 0.75,
        "pose.warp.max_events": 8,
        "pose.warp.cooldown": 3,
    },
}
PASS_GAP_DB = 3.0
# A seed's TTO quality is bounded by its training-pose basin: where train
# poses stalled warped (rel-R >~ 5 deg) no rigid test pose renders the
# interpolated views well, so the gap criterion is gated on converged seeds.
CONVERGED_REL_R_DEG = 5.0


def _stamp() -> dict:
    return {"protocol_rev": PROTOCOL_REV, "tto_kw": dict(TTO_KW)}


def _stamp_path(run_dir: str) -> str:
    return os.path.join(run_dir, "a_optimize", "protocol_stamp.json")


def tto_scratch_reusable(run_dir: str) -> bool:
    """A TTO result is reused only when this protocol revision with these TTO
    settings stamped it."""
    metrics = os.path.join(run_dir, "a_optimize", "metrics.json")
    if not (os.path.isfile(metrics) and os.path.isfile(_stamp_path(run_dir))):
        return False
    try:
        with open(_stamp_path(run_dir)) as f:
            return json.load(f) == _stamp()
    except (json.JSONDecodeError, OSError):
        return False


def tto_argv(kw: dict) -> List[str]:
    """`cli.tto`'s flags for TTO settings `kw`."""
    return [a for k, v in kw.items() for a in (f"--{k}", str(v))]


def tto_and_eval(run_dir: str, steps: int, kw: dict, device: str, reusable: bool) -> dict:
    """`cli.tto` on the run's last checkpoint (which must be step `steps`)
    unless `reusable`, then `cli.eval`; returns TTO's per-image metrics.
    Raises when eval's mean PSNR is not that of the metrics."""
    from upnerf_torch.cli.eval import main as eval_main
    from upnerf_torch.cli.tto import main as tto_main
    from upnerf_torch.utils.ckpt import CheckpointManager

    mngr = CheckpointManager(os.path.join(run_dir, "ckpts"))
    last_step = mngr.latest_step()
    if last_step != steps:
        raise RuntimeError(f"protocol validity: last checkpoint is {last_step}, expected {steps} (TTO on a stale"
                           " model invalidates the quality claim)")
    ckpt = mngr.path(last_step)
    save_root = os.path.join(run_dir, "a_optimize")
    if not reusable:
        shutil.rmtree(save_root, ignore_errors=True)
        tto_main(["--ckpt", ckpt, "--result_dir", run_dir, "--device", device, "--optimize_num", "-1",
                  "--shard", "0/1"] + tto_argv(kw))
    with open(os.path.join(save_root, "metrics.json")) as f:
        tto = json.load(f)
    if not tto:
        raise RuntimeError(f"TTO produced no per-image metrics in {save_root}")
    ev = eval_main(["--ckpt", ckpt, "--result_dir", run_dir, "--device", device])
    mean = float(np.mean([v["psnr"] for v in tto.values()]))
    if not abs(ev.get("PSNR", np.nan) - mean) <= 1e-6 * max(1.0, abs(mean)):
        raise RuntimeError(f"cli.eval's PSNR {ev.get('PSNR')} is not the TTO metrics' mean {mean}")
    return tto


def run_one(seed: int, steps: int, overrides: Optional[dict] = None, tag: str = "", device: str = "cuda",
            work: str = WORK) -> dict:
    """train -> tto -> eval for one seed; returns the quality row."""
    from upnerf_torch.config import default, merge_from_file

    hp = default()
    merge_from_file(hp, CONFIG)
    exp = f"tto{tag}_seed{seed}"
    scene, out_dir = work_path(SCENE_DIR, work), work_path(OUT_DIR, work)
    train_kw = dict(overrides or {})
    train_kw.update({
        "seed": seed,
        "exp_name": exp,
        "max_steps": steps,
        "root_dir": scene,
        "feat_dir": os.path.join(scene, "DINO"),
        "depth_dir": os.path.join(scene, "DPT"),
        "out_dir": out_dir,
    })

    run_dir = os.path.join(out_dir, hp["scene_name"], exp)
    plan = plan_run(run_dir, steps)
    print(f"[tto-protocol]   plan for {run_dir}: {plan}", flush=True)
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

    reusable = tto_scratch_reusable(run_dir)
    tto = tto_and_eval(run_dir, steps, TTO_KW, device, reusable)
    if not reusable:
        with open(_stamp_path(run_dir), "w") as f:
            json.dump(_stamp(), f)

    val_psnr = round(val[-1]["val/psnr"], 2)
    tto_psnr = round(float(np.mean([v["psnr"] for v in tto.values()])), 2)
    row = {
        "seed": seed,
        "exp": exp,
        "steps": steps,
        "final_val_psnr": val_psnr,
        "tto_psnr_mean": tto_psnr,
        "tto_psnr_min": round(min(v["psnr"] for v in tto.values()), 2),
        "tto_psnr_per_image": [round(tto[k]["psnr"], 2) for k in sorted(tto, key=int)],
        "tto_ssim_mean": round(float(np.mean([v["ssim"] for v in tto.values()])), 4),
        "gap_db": round(val_psnr - tto_psnr, 2),
        "pass_3db": bool(val_psnr - tto_psnr <= PASS_GAP_DB),
        "n_test_images": len(tto),
    }
    if pose:
        row["init_rel_R_deg"] = round(pose[0]["train/pose_R_rel"], 2)
        row["final_rel_R_deg"] = round(pose[-1]["train/pose_R_rel"], 2)
        row["final_rel_t"] = round(pose[-1]["train/pose_t_rel"], 3)
        row["train_converged"] = bool(row["final_rel_R_deg"] < CONVERGED_REL_R_DEG)
    return row


def write_summary(out: str, steps: int, seeds: list, results: list, commit: str, train_recipe: str = "baseline",
                  overrides: Optional[dict] = None, device: str = "cpu") -> dict:
    def stats(key, nd=2):
        vals = np.array([r[key] for r in results])
        return {
            "median": round(float(np.median(vals)), nd),
            "min": round(float(vals.min()), nd),
            "max": round(float(vals.max()), nd),
        }

    converged = [r for r in results if r.get("train_converged")]
    summary = {
        "recipe": "tto_quality",
        "protocol_rev": PROTOCOL_REV,
        "steps": steps,
        "seeds": seeds,
        "git_commit": commit,
        "device": device,
        "pass_criterion": (
            f"every seed with final_rel_R_deg < {CONVERGED_REL_R_DEG} "
            f"has val-to-TTO gap <= {PASS_GAP_DB} dB (>= 1 such seed)"
        ),
        "pass": bool(converged) and all(r["pass_3db"] for r in converged),
        "seeds_converged": [r["seed"] for r in converged],
        "pass_3db_all": all(r["pass_3db"] for r in results),
        # every seed converged and within the gap
        "pass_strict": bool(results)
        and all(r.get("train_converged") for r in results)
        and all(r["pass_3db"] for r in results),
        "final_val_psnr": stats("final_val_psnr"),
        "tto_psnr_mean": stats("tto_psnr_mean"),
        "gap_db": stats("gap_db"),
        "tto_ssim_mean": stats("tto_ssim_mean", nd=4),
        "tto_kw": dict(TTO_KW),
        "train_recipe": train_recipe,
        "train_overrides": {k: (list(v) if isinstance(v, tuple) else v) for k, v in (overrides or {}).items()},
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
    if (prior.get("recipe") != "tto_quality" or prior.get("steps") != steps
            or prior.get("protocol_rev") != PROTOCOL_REV):
        return {}
    return {r["seed"]: r for r in prior.get("runs", []) if r.get("steps") == steps}


def main(argv: Optional[List[str]] = None) -> dict:
    from upnerf_torch.config import default, merge_from_file

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="42,777")
    ap.add_argument("--steps", type=int, default=15000)
    ap.add_argument("--recipe", default="baseline", choices=sorted(TRAIN_RECIPES))
    ap.add_argument("--tag", default="",
                    help="record / exp suffix for schedule variants (e.g. '30k'), so a variant never overwrites the"
                         " 15k record of the same recipe")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT, help="directory of the records")
    ap.add_argument("--work", default=WORK, help="directory of the scene and run directories")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    overrides = TRAIN_RECIPES[args.recipe]
    tag = "" if args.recipe == "baseline" else f"_{args.recipe}"
    if args.tag:
        tag += f"_{args.tag}"
    artifact = os.path.join(args.out, ARTIFACT.replace(".json", f"{tag}.json"))
    device = device_stamp(args.device)

    scene = work_path(SCENE_DIR, args.work)
    if not os.path.isdir(scene):
        from upnerf_torch.data import synthetic

        print(f"[tto-protocol] generating scene {scene}", flush=True)
        synthetic.generate_scene(scene, **SCENE_KWARGS)

    hp_probe = default()
    merge_from_file(hp_probe, CONFIG)
    runs_root = os.path.join(work_path(OUT_DIR, args.work), hp_probe["scene_name"])

    commit = git_commit()
    prior_runs = load_prior_runs(artifact, args.steps)
    results = []
    for seed in seeds:
        print(f"[tto-protocol] {args.recipe} seed {seed} ({args.steps} steps)...", flush=True)
        if seed in prior_runs and plan_run(os.path.join(runs_root, f"tto{tag}_seed{seed}"), args.steps) == "fresh":
            print(f"[tto-protocol]   seed {seed}: reusing the record's run", flush=True)
            results.append(dict(prior_runs[seed], reused_from_artifact=True))
        else:
            results.append(run_one(seed, args.steps, overrides, tag, args.device, args.work))
        print(f"[tto-protocol]   -> {results[-1]}", flush=True)
        summary = write_summary(artifact, args.steps, seeds, results, commit, args.recipe, overrides, device)
        print(f"[tto-protocol] wrote {artifact} ({len(results)}/{len(seeds)} seeds)", flush=True)

    print(json.dumps({k: summary[k] for k in
                      ("pass", "seeds_converged", "pass_3db_all", "final_val_psnr", "tto_psnr_mean", "gap_db")}),
          flush=True)
    return summary


if __name__ == "__main__":
    main()
