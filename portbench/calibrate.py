"""The readings that a cell's limits are set from, for many seeds in one
process (set-up is long):

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... [--control N] [--faults half_batch,...]
        [--frames N] [--out chiprun_out/calibrate_<cell>.jsonl]

For each seed: the program's readings (its first steps, or for a render or
preprocessing cell a short window of N frames or images at the cell's own
load) against the plain reference; on the first --control seeds, the
reference computed in the control's precision (the driver's `control`:
float8 operands, portbench/reference/model.py, unless it names another)
against the float32 reference, and the program with each planted fault of
--faults (the drivers' `fault`) against the reference. One JSON line a
reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=4, help="the control on the first N seeds")
    ap.add_argument("--faults", default="", help="planted faults, each on the seeds the control reads")
    ap.add_argument("--frames", type=int, default=0,
                    help="render and preprocessing cells: frames or images of the short window (0: check_frames or"
                         " check_images)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = run.load_cell(args.workload)
    cfg, traffic = spec["cfg"], spec["traffic"]
    run.set_environment()
    import torch

    import upnerf_torch  # noqa: F401

    from portbench import check

    dev = torch.device("cuda", 0)
    drv_mod = run.load_module(BENCH / "drivers" / f"{traffic['driver']}.py")
    out = open(args.out or (BENCH.parent / "chiprun_out" / f"calibrate_{args.workload}.jsonl"), "a")
    faults = [f for f in args.faults.split(",") if f]
    control = getattr(drv_mod.Driver, "control", "fp8")
    window = traffic.get("check_frames", traffic.get("check_images"))

    def emit(**row):
        line = json.dumps({"cell": args.workload, **row})
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for fault in [None] + (faults if n < args.control else []):
            t0 = time.perf_counter()
            drv = drv_mod.Driver(cfg, traffic, seed, dev, fault=fault)
            if window:
                drv.run(0.0, max_units=args.frames or window)
            prog = drv.prog
            drv.release()
            t1 = time.perf_counter()
            ref = drv.reference("float32")
            t2 = time.perf_counter()
            raw = {} if window else {"prog": prog, "ref": ref}
            emit(seed=seed, kind=fault or "program", readings=check.readings(prog, ref), setup_s=t1 - t0,
                 reference_s=t2 - t1, **raw)
            if fault is None and n < args.control:
                ctl = drv.reference(control)
                raw = {} if window else {"prog": ctl}
                emit(seed=seed, kind=f"control_{control}", readings=check.readings(ctl, ref),
                     reference_s=time.perf_counter() - t2, **raw)
            del drv, prog, ref
            gc.collect()
            torch.cuda.empty_cache()
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
