"""Run one cell of the benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`: its configuration
file (`configs`), its traffic mix (portbench/traffic/<traffic>.json, whose
`driver` names portbench/drivers/<driver>.py) and its limits
(portbench/limits/<cell>.json). Set-up (imports, the scene and weights from
the seed, the kernel build or load, the driver's first units of work) is
timed as `setup_s`; then the window runs for --seconds. With --trace 0 the
result carries the cell's end-to-end metrics; with --trace 1 two short
profiled spans follow the window and the result carries the cell's
per-layer metrics, each read by portbench/metrics/<metric>.py from the
run's record. Then the program's state is freed and the plain reference
(portbench/reference/) checks what the timed path produced. The last line
of standard output is the result, one JSON object; the numbers compared
are its last key and the last lines of standard error.

The run needs the card the cell asks for and exits with 2 without one.
Build and kernel caches stay in build/ inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "upnerf")


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_file_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str) -> Dict:
    """Everything the data files say about one cell."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"cell": cell, "cfg": load_json(ROOT / config["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{name}.json"), "e2e": e2e, "per_layer": per_layer}


def rate(win: Dict, traffic: Dict) -> float:
    """The cell's rate: the window's completed work over its whole length.
    The work is counted under the traffic's `count` key: "rays" unless it
    names another (the preprocessing pass counts "images")."""
    return win[traffic.get("count", "rays")] / win["seconds"]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, and
    one CPU thread for PyTorch's and OpenMP's pools: the run is one process
    whose host side is one Python thread, so idle pool threads only compete
    with it for the host's shared cores. Before torch is imported."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"


def main(argv: Optional[List[str]] = None, *, device=None, cfg_overrides: Optional[Dict] = None,
         fault: Optional[str] = None) -> int:
    """Returns the exit code. `device`, `cfg_overrides` and `fault` serve the
    benchmark's own tests (a CPU run at a small size, a planted fault); a
    run from the command line takes the card and the files as they are."""
    args = parse(argv)
    spec = load_cell(args.workload)
    cfg, traffic = spec["cfg"], spec["traffic"]
    for k, v in (cfg_overrides or {}).items():
        cfg[k] = {**cfg[k], **v} if isinstance(v, dict) else v
    set_environment()
    import torch

    torch.set_num_threads(1)

    if device is None:
        need = spec["cell"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"portbench: the cell needs {need} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    import upnerf_torch  # noqa: F401  (TF32 off, as the program runs)

    from portbench import check, trace

    cuda = device.type == "cuda"
    imports_s = time.perf_counter() - T_START
    driver = load_module(BENCH / "drivers" / f"{traffic['driver']}.py").Driver(cfg, traffic, args.seed, device,
                                                                                fault=fault)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    print(f"setup: {imports_s:.3f} s the imports, {setup_s - imports_s:.3f} s the driver's set-up",
          file=sys.stderr)
    win = driver.run(args.seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1,
                "memory_peak_bytes": int(peak)}
    values = {"setup_s": setup_s, "peak_gib": peak / 2**30, traffic["rate_metric"]: rate(win, traffic)}
    breakdown = None
    if args.trace:
        span, rec = trace.traced(lambda: driver.run(0.0, max_units=traffic["trace_units"]))
        record = {**driver.record(), "window": win, "span": span, "trace": rec}
        values = {}
        for m in spec["per_layer"]:
            v = load_module(BENCH / "metrics" / f"{m['name']}.py").read(record)
            if v is not None:
                values[m["name"]] = v
        dev_info.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        breakdown = trace.breakdown(rec)
        print(f"trace: {span['units']} units, {rec['n_kernels']} kernels, host ops' device s {rec['ops']}; "
              f"ms a unit: window {1e3 * win['seconds'] / max(win['units'], 1):.3f}, device-only span "
              f"{1e3 * rec['host_s'] / span['units']:.3f} (busy {1e3 * rec['busy_s'] / span['units']:.3f}), "
              f"span with host ops {1e3 * rec['host_s.ops'] / span['units']:.3f}", file=sys.stderr)
        wanted = spec["per_layer"]
    else:
        wanted = spec["e2e"]
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in wanted if m["name"] in values}
    missing = [m["name"] for m in wanted if m["name"] not in values and not args.trace]
    if missing:
        raise RuntimeError(f"the run measured no {missing}")
    prog = driver.prog
    driver.release()
    got = check.readings(prog, driver.reference("float32"))
    limits = spec["limits"]
    compared = {k: {"value": got[k], "limit": limits[k]} for k in limits}
    correct = win["failed"] == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                         for c in compared.values())
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found} after the window", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": win["units"], "failed": win["failed"], "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = compared
    print(json.dumps(result), flush=True)
    for k, c in compared.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
