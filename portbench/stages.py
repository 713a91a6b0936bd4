"""The program's spans in one cell: the host's time a unit by stage, and the
card's kernels, device time, idle time and synchronising calls by the
program stage that launched them.

    python3 portbench/stages.py --workload <cell> --seed <n> --seconds <s>

Set-up and the window run as in portbench/run.py, with the program's spans
off (`upnerf_torch.utils.profiling`). Then spans of the traffic's
`trace_units` units each:
- `host_span`, no profiler, three times with the spans on and three with
  them off, in turns (`ROUNDS`): the host's time by stage at its own pace
  (`SpanLog.summary`), and the spans' cost, the ms a unit with them on
  against the ms with them off and against the window's;
- `traced_spans`, under torch.profiler with the host's ops: every program
  span is a range of the Chrome trace, and `attribute` puts each kernel,
  each idle gap and each synchronising runtime call down to the innermost
  program span open when it was launched or made.
`stage_metrics` reduces both to the cell's per-layer numbers.
The last line of standard output is one JSON object; the window's
end-to-end numbers stay portbench/run.py's, which keeps the spans off.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
if str(BENCH.parent) not in sys.path:
    sys.path.insert(0, str(BENCH.parent))

from portbench import run  # noqa: E402

PREFIXES = ("train.", "tto.", "serve.")  # the program's span names (other ranges, e.g. torch's optimizers', are not)
ROOTS = {"train": "train.step", "tto": "tto.step", "render": "serve.frame"}  # a unit's span, by the traffic's driver
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
END = "end of span (synchronise)"
ROUNDS = (False, True, True, False, False, True)  # host spans without and with the spans, in turns
NO_SPAN = "outside the program's spans"


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_span(work: Callable[[], Dict], on: bool = True) -> Dict:
    """`work` (a driver's run of some units) with no profiler and the spans
    on (or off): the run's units and seconds and each span name's count and
    seconds (`spans`)."""
    from upnerf_torch.utils import profiling

    with profiling.spans() if on else contextlib.nullcontext() as log:
        out = work()
    return {"units": out["units"], "seconds": out["seconds"], "spans": log.summary()["spans"] if on else {}}


def merge(runs: List[Dict]) -> Dict:
    """`host_span` results of several runs as one."""
    spans: Dict[str, Dict] = {}
    for r in runs:
        for k, v in r["spans"].items():
            m = spans.setdefault(k, {"count": 0, "s": 0.0})
            m["count"] += v["count"]
            m["s"] += v["s"]
    return {"units": sum(r["units"] for r in runs), "seconds": sum(r["seconds"] for r in runs), "spans": spans}


def traced_spans(work: Callable[[], Dict], device) -> Dict:
    """`work` under torch.profiler (the host's ops, and the card's where
    there is one) with the spans on, inside `trace.SPAN`; its events
    through `attribute`."""
    import torch

    from portbench import trace
    from upnerf_torch.utils import profiling

    P = torch.profiler.ProfilerActivity
    _sync(device)
    with torch.profiler.profile(activities=[P.CPU] + ([P.CUDA] if device.type == "cuda" else [])) as prof:
        with torch.profiler.record_function(trace.SPAN), profiling.spans():
            work()
            _sync(device)
    return attribute(trace._events(prof))


def _nesting(ranges: List[Tuple[float, float, str]]) -> List[int]:
    """Each range's parent (the innermost range holding it) or -1; `ranges`
    are sorted by start, longer first, and nest (one thread's)."""
    parent: List[int] = []
    stack: List[int] = []
    for _, b, _ in ranges:
        while stack and ranges[stack[-1]][1] < b:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(len(parent) - 1)
    return parent


def _innermost(starts: List[float], ranges: List[Tuple[float, float, str]], parent: List[int], t: float) -> int:
    """The index of the innermost range open at t, or -1."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and ranges[i][1] < t:
        i = parent[i]
    return i


def _ranges(events: List[Dict]) -> Tuple[List[Tuple[float, float, str]], List[float], List[int]]:
    rs = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events),
                key=lambda r: (r[0], -r[1]))
    return rs, [r[0] for r in rs], _nesting(rs)


def attribute(events: List[Dict]) -> Dict:
    """From the Chrome-trace events of a span with the host's ops and the
    program's spans (times in us; the span is the range named
    `trace.SPAN`): `units` (root program spans), `idle_s` (the card's idle
    time inside the span), and for each program span name, over the
    launches and calls made while it was the innermost program span open
    (on any thread: the backward's launches fall inside the caller's
    `*.backward` span): `kernels` (their count), `device_s` (the device time
    of their kernels, copies and sets), `idle_s` (the idle time that ended
    with their work), `syncs` and `sync_s` (the synchronising runtime calls
    and the host's time in them) and `sync_ops` (those calls by the
    innermost host op around them on their thread). Idle time with no
    program span open at its ending launch goes to NO_SPAN, after the last
    work to END."""
    from portbench import trace

    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in xs if e.get("name") == trace.SPAN and e.get("cat") in ("user_annotation", "cpu_op")]
    if not marks:
        raise RuntimeError("the traced span is missing from the profiler's trace")
    s0 = float(marks[0]["ts"])
    s1 = s0 + float(marks[0]["dur"])
    spans, starts, parent = _ranges([e for e in xs if e.get("cat") == "user_annotation"
                                     and str(e.get("name", "")).startswith(PREFIXES)])
    ops_by_tid: Dict = {}
    for e in xs:
        if e.get("cat") == "cpu_op":
            ops_by_tid.setdefault(e.get("tid"), []).append(e)
    ops_by_tid = {tid: _ranges(es) for tid, es in ops_by_tid.items()}
    out: Dict[str, Dict] = {}

    def entry(name: str) -> Dict:
        return out.setdefault(name, {"kernels": 0, "device_s": 0.0, "idle_s": 0.0, "syncs": 0, "sync_s": 0.0,
                                     "sync_ops": {}})

    def name_at(t: float) -> str:
        i = _innermost(starts, spans, parent, t)
        return spans[i][2] if i >= 0 else NO_SPAN

    def op_at(tid, t: float) -> str:
        rs, st, par = ops_by_tid.get(tid, ([], [], []))
        i = _innermost(st, rs, par, t)
        return rs[i][2] if i >= 0 else "(no host op)"

    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in trace.LAUNCH_CATS and "correlation" in e.get("args", {})}
    dev = sorted((e for e in xs if e.get("cat") in trace.DEVICE_CATS and s0 <= float(e["ts"]) < s1),
                 key=lambda e: float(e["ts"]))
    label = []
    for e in dev:
        launch = launches.get(e.get("args", {}).get("correlation"))
        name = name_at(float(launch["ts"])) if launch is not None else NO_SPAN
        label.append(name)
        rec = entry(name)
        rec["device_s"] += float(e["dur"]) / 1e6
        rec["kernels"] += e["cat"] == "kernel"
    idle = 0.0
    prev_end = s0
    for e, name in zip(dev, label):
        a, b = float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), s1)
        if a > prev_end:
            entry(name)["idle_s"] += (a - prev_end) / 1e6
            idle += (a - prev_end) / 1e6
        prev_end = max(prev_end, b)
    if s1 > prev_end:
        entry(END)["idle_s"] += (s1 - prev_end) / 1e6
        idle += (s1 - prev_end) / 1e6
    for e in xs:
        n = str(e.get("name", ""))
        if e.get("cat") in trace.LAUNCH_CATS and (n in SYNC_CALLS or n.startswith("cudaMemcpy")) \
                and s0 <= float(e["ts"]) < s1:
            rec = entry(name_at(float(e["ts"])))
            rec["syncs"] += 1
            rec["sync_s"] += float(e["dur"]) / 1e6
            op = op_at(e.get("tid"), float(e["ts"]))
            rec["sync_ops"][op] = rec["sync_ops"].get(op, 0) + 1
    return {"units": sum(1 for p in parent if p < 0), "idle_s": idle, "spans": out}


def stage_metrics(kind: str, host: Optional[Dict], traced: Optional[Dict]) -> Dict[str, Optional[float]]:
    """The per-layer numbers of a cell whose traffic's driver is `kind`,
    from a `host_span` and an `attribute` result, each None where the spans
    it reads are missing: the host's ms a unit in each train stage and the
    whole step, the kernels launched under `train.opt` a step; the host's
    ms a TTO step; the host's ms a frame issuing its work (`serve.frame`
    less `serve.to_host`) and waiting for it in `serve.to_host`."""

    def ms(name: str) -> Optional[float]:
        s = (host or {}).get("spans", {}).get(name)
        return 1e3 * s["s"] / host["units"] if s and host["units"] else None

    def per_unit(name: str, key: str) -> Optional[float]:
        s = (traced or {}).get("spans", {}).get(name)
        return s[key] / traced["units"] if s and traced["units"] else None

    if kind == "train":
        return {"host_ms_per_step.train": ms("train.step"), "host_ms_batch.train": ms("train.batch"),
                "host_ms_forward.train": ms("train.forward"), "host_ms_backward.train": ms("train.backward"),
                "host_ms_opt.train": ms("train.opt"), "launches_opt.train": per_unit("train.opt", "kernels")}
    if kind == "tto":
        return {"host_ms_per_step.tto": ms("tto.step")}
    frame, to_host = ms("serve.frame"), ms("serve.to_host")
    return {"host_ms_issue.render": None if frame is None or to_host is None else frame - to_host,
            "host_ms_to_host.render": to_host}


def stage_idle_share(kind: str, traced: Dict) -> Optional[float]:
    """The share (%) of the span's idle time put down to a stage span: a
    program span other than the unit's root."""
    if traced["idle_s"] <= 0:
        return None
    root = ROOTS[kind]
    named = sum(v["idle_s"] for k, v in traced["spans"].items() if k.startswith(PREFIXES) and k != root)
    return 100.0 * named / traced["idle_s"]


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, *, device=None, cfg_overrides: Optional[Dict] = None) -> int:
    """Returns the exit code. `device` and `cfg_overrides` serve the tests
    (a CPU run at a small size); from the command line the run takes the
    card, and exits with 2 without one."""
    args = parse(argv)
    spec = run.load_cell(args.workload)
    cfg, traffic = spec["cfg"], spec["traffic"]
    for k, v in (cfg_overrides or {}).items():
        cfg[k] = {**cfg[k], **v} if isinstance(v, dict) else v
    run.set_environment()
    import torch

    torch.set_num_threads(1)
    if device is None:
        if not torch.cuda.is_available():
            print("portbench: stages.py needs a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    import upnerf_torch  # noqa: F401

    t0 = time.perf_counter()
    driver = run.load_module(BENCH / "drivers" / f"{traffic['driver']}.py").Driver(cfg, traffic, args.seed, device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    win = driver.run(args.seconds)
    units = traffic["trace_units"]
    runs = {True: [], False: []}
    for on in ROUNDS:
        runs[on].append(host_span(lambda: driver.run(0.0, max_units=units), on))
    host = merge(runs[True])
    traced = traced_spans(lambda: driver.run(0.0, max_units=units), device)
    kind = traffic["driver"]
    window_ms = 1e3 * win["seconds"] / max(win["units"], 1)
    ms = {on: [1e3 * r["seconds"] / max(r["units"], 1) for r in rs] for on, rs in runs.items()}
    host_ms = 1e3 * host["seconds"] / max(host["units"], 1)
    off_ms = 1e3 * sum(r["seconds"] for r in runs[False]) / max(sum(r["units"] for r in runs[False]), 1)
    n = max(traced["units"], 1)
    result = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu", "setup_s": setup_s,
        "window": {"units": win["units"], "ms_per_unit": window_ms},
        "host_span": {"units": host["units"], "ms_per_unit": host_ms, "against_window_ms": host_ms - window_ms,
                      "off_ms_per_unit": off_ms, "spans_cost_ms_per_unit": host_ms - off_ms,
                      "runs_ms_per_unit": {"on": ms[True], "off": ms[False]},
                      "stages_ms_per_unit": {k: 1e3 * v["s"] / max(host["units"], 1)
                                             for k, v in host["spans"].items()}},
        "traced_span": {"units": traced["units"], "idle_ms_per_unit": 1e3 * traced["idle_s"] / n,
                        "stage_idle_share": stage_idle_share(kind, traced),
                        "by_span": {k: {"kernels": v["kernels"] / n, "device_ms": 1e3 * v["device_s"] / n,
                                        "idle_ms": 1e3 * v["idle_s"] / n,
                                        "idle_share": 100.0 * v["idle_s"] / traced["idle_s"]
                                        if traced["idle_s"] > 0 else None,
                                        "syncs": v["syncs"] / n, "sync_ms": 1e3 * v["sync_s"] / n,
                                        "sync_ops": {op: c / n for op, c in v["sync_ops"].items()}}
                                    for k, v in traced["spans"].items()}},
        "metrics": stage_metrics(kind, host, traced),
    }
    found = run.forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
