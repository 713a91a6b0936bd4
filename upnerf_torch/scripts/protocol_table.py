"""The port's protocol records beside the JAX package's (scripts/protocol_table.py).

    python -m upnerf_torch.scripts.protocol_table [--records protocols_torch] [--reference benchmarks]
        [--runs DIR]

Reads the port's records (pose_protocol_*.json, tto_quality_protocol*.json,
quality_protocol_synth_small.json, as upnerf_torch.scripts.{pose,tto,quality}_protocol
write them) and the JAX records of the same names, and prints one markdown
table: steps, seeds, the summary numbers of both, the port's device and
whether the port's record meets its bar against the JAX record. It reads
and never writes.

The bars: pose, every seed's final rel-R below POSE_MAX_DEG and the median
within the JAX seed range widened by NOISE_DEG (the run-to-run noise floor of
benchmarks/tto_quality_protocol_c2f_repro.json); tto, the record's own
pass_criterion; quality, the final val PSNR median within PSNR_TOL_DB of
the JAX median.

With --runs, also one row per run directory under DIR (the drivers' --work,
or a copy of its metric logs): the steps logged, the span of the log's wall
clock, the median step time over the log's 100-step windows
(train.batch_size over the Trainer's logged rays_per_sec, host clock), the
last val PSNR and the last train/pose_R_rel.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
POSE_MAX_DEG = 5.0
NOISE_DEG = 0.1
PSNR_TOL_DB = 0.5


def _range(s: dict, unit: str = "", nd: int = 2) -> str:
    return f"{s['median']:.{nd}f}{unit} [{s['min']:.{nd}f}-{s['max']:.{nd}f}]"


def _steps(d: dict) -> str:
    s = d["steps"]
    return f"{s // 1000}k" if s % 1000 == 0 else str(s)


def row(name: str, port: dict, jax: Optional[dict]) -> str:
    """One table row: the record `name` of the port beside the JAX one."""
    n = f"{len(port['runs'])}" + (" (partial)" if port.get("partial") else "")
    jn = "-" if jax is None else f"{len(jax['runs'])}"
    if port["recipe"] == "tto_quality":
        what = "val PSNR / TTO PSNR / gap dB / pass"

        def show(d):
            return (f"{_range(d['final_val_psnr'])} / {_range(d['tto_psnr_mean'])} / {_range(d['gap_db'])} /"
                    f" {d['pass']} (converged {d['seeds_converged']})")
        ok = bool(port["pass"])
    elif port["recipe"] == "quality_synth_small":
        what = "val PSNR / TTO PSNR / TTO SSIM"

        def show(d):
            return f"{_range(d['final_val_psnr'])} / {_range(d['tto_psnr_mean'])} / {_range(d['tto_ssim_mean'], nd=4)}"
        ok = jax is not None and abs(port["final_val_psnr"]["median"] - jax["final_val_psnr"]["median"]) <= PSNR_TOL_DB
    else:
        what = "final rel-R deg / final rel-t"

        def show(d):
            return f"{_range(d['final_rel_R_deg'])} / {_range(d['final_rel_t'], nd=3)}"
        med = port["final_rel_R_deg"]["median"]
        ok = (jax is not None and all(r["final_rel_R_deg"] < POSE_MAX_DEG for r in port["runs"])
              and jax["final_rel_R_deg"]["min"] - NOISE_DEG <= med <= jax["final_rel_R_deg"]["max"] + NOISE_DEG)
    same = jax is not None and jax.get("steps") == port["steps"]
    ok = ok and same and not port.get("partial")
    return (f"| {name} | {_steps(port)} | {what} | {n} | {show(port)} | {jn} |"
            f" {'-' if jax is None else show(jax)} | {port.get('device', '')} | {'yes' if ok else 'no'} |")


def render(records: str, reference: str) -> str:
    lines = ["| record | steps | numbers (median [min-max]) | port seeds | port | JAX seeds | JAX | port device |"
             " meets bar |",
             "|---|---|---|---|---|---|---|---|---|"]
    for path in sorted(glob.glob(os.path.join(records, "*.json"))):
        name = os.path.basename(path)
        with open(path) as f:
            port = json.load(f)
        if "runs" not in port:
            continue
        ref = os.path.join(reference, name)
        jax = None
        if os.path.isfile(ref):
            with open(ref) as f:
                jax = json.load(f)
        lines.append(row(name[:-5], port, jax))
    return "\n".join(lines)


def runs_table(root: str) -> str:
    """One row per metrics.jsonl under root: its run, last step, wall seconds
    from its first to its last record, median ms a step, last val PSNR and
    rel-R."""
    import statistics

    from upnerf_torch.config import load

    lines = ["| run | steps | log span s | median ms a step (100-step windows) | last val PSNR | last rel-R deg |",
             "|---|---|---|---|---|---|"]
    for mfile in sorted(glob.glob(os.path.join(root, "**", "metrics.jsonl"), recursive=True)):
        run = os.path.dirname(mfile)
        with open(mfile) as f:
            recs = [json.loads(line) for line in f]
        cfg = os.path.join(run, "config.yaml")
        batch = load(cfg).get("train.batch_size") if os.path.isfile(cfg) else None
        rps = [r["rays_per_sec"] for r in recs if "rays_per_sec" in r]
        ms = f"{batch / statistics.median(rps) * 1e3:.3f}" if batch and rps else "-"
        span = recs[-1]["time"] - recs[0]["time"] if recs and "time" in recs[0] else float("nan")
        val = [r["val/psnr"] for r in recs if "val/psnr" in r]
        rel = [r["train/pose_R_rel"] for r in recs if "train/pose_R_rel" in r]
        lines.append(f"| {os.path.relpath(run, root)} | {max(r['step'] for r in recs) if recs else 0} | {span:.1f} |"
                     f" {ms} | {f'{val[-1]:.2f}' if val else '-'} | {f'{rel[-1]:.2f}' if rel else '-'} |")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", default="protocols_torch", help="the port's records")
    ap.add_argument("--reference", default=os.path.join(REPO, "benchmarks"), help="the JAX records")
    ap.add_argument("--runs", default=None, help="also a row per run directory (metrics.jsonl) under this one")
    args = ap.parse_args(argv)
    table = render(args.records, args.reference)
    if args.runs:
        table += "\n\n" + runs_table(args.runs)
    print(table)
    return table


if __name__ == "__main__":
    main()
