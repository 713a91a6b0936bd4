"""Two traced spans of a driver's work under torch.profiler, read into the
record that the per-layer metrics take their numbers from.

The first span records the device's activity alone (CUPTI's kernel, copy,
set and runtime records; no host ops), so that the host runs at about its
untraced pace: `window_s`, the span from the synchronise before the work
to the one that ends it, and `busy_s`, the union of every kernel, copy and
set on the device inside it, are read from it. The second span records the
host's ops too, which slows the host; from it:
- `kernels`: name -> [count, seconds] of the device's kernels;
- `ops`: for each host op in ATTRIBUTE_OPS, the device seconds of the
  kernels, copies and sets launched while it ran (any thread; the ops of
  one pass do not overlap in time);
- `gaps`: the device's idle time inside that span, each gap named by the
  innermost host op that launched the work ending it.
Both spans' lengths on the host clock are kept (`host_s`, `host_s.ops`).
Each profiler's Chrome trace goes to a file under TMPDIR, is read and is
removed.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Tuple

import torch

SPAN = "portbench.span"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# Host ops whose kernels a per-layer metric attributes to a pass: the fused
# render's autograd.Function and its backward node (ops/render_train.py).
ATTRIBUTE_OPS = ("RenderTrainRays", "RenderTrainRaysBackward")


def traced(work: Callable[[], Dict]) -> Tuple[Dict, Dict]:
    """Run `work` twice, once under each profiler; returns (the second
    run's result, the trace record)."""
    P = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[P.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        device_host_s = time.perf_counter() - t0
    dev = read_device_span(_events(prof))
    with torch.profiler.profile(activities=[P.CPU, P.CUDA]) as prof:
        with torch.profiler.record_function(SPAN):
            t0 = time.perf_counter()
            result = work()
            torch.cuda.synchronize()
            ops_host_s = time.perf_counter() - t0
    rec = read_events(_events(prof))
    rec.update(window_s=dev["window_s"], busy_s=dev["busy_s"], host_s=device_host_s)
    rec["host_s.ops"] = ops_host_s
    return result, rec


def _events(prof) -> List[Dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def read_device_span(events: List[Dict]) -> Dict:
    """`window_s` and `busy_s` of a span that recorded the device alone: from
    the end of its first cudaDeviceSynchronize to the end of its last
    (without two of them, from its first record to its last)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    syncs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in xs
                   if e.get("cat") in LAUNCH_CATS and e.get("name") == "cudaDeviceSynchronize")
    marks = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in xs
             if e.get("cat") in LAUNCH_CATS + DEVICE_CATS]
    if not marks:
        raise RuntimeError("the device span recorded nothing")
    if len(syncs) >= 2:
        s0, s1 = syncs[0][1], syncs[-1][1]
    else:
        s0, s1 = min(a for a, _ in marks), max(b for _, b in marks)
    busy = _union([(max(float(e["ts"]), s0), min(float(e["ts"]) + float(e["dur"]), s1)) for e in xs
                   if e.get("cat") in DEVICE_CATS and float(e["ts"]) < s1
                   and float(e["ts"]) + float(e["dur"]) > s0])
    return {"window_s": (s1 - s0) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read_events(events: List[Dict]) -> Dict:
    """The record of a span that recorded the host's ops too, from its
    Chrome-trace events (times in us)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in xs if e.get("name") == SPAN and e.get("cat") in ("user_annotation", "cpu_op")]
    if not spans:
        raise RuntimeError("the traced span is missing from the profiler's trace")
    s0 = float(spans[0]["ts"])
    s1 = s0 + float(spans[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS and s0 <= float(e["ts"]) < s1]
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops = [e for e in xs if e.get("cat") == "cpu_op"]
    by_ext = {e["args"]["External id"]: e for e in ops if "External id" in e.get("args", {})}
    ranges = {name: sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in ops if e.get("name") == name)
              for name in ATTRIBUTE_OPS}
    kernels: Dict[str, List[float]] = {}
    op_s = {name: 0.0 for name in ATTRIBUTE_OPS}
    ivals = []
    for e in dev:
        a, d = float(e["ts"]), float(e["dur"])
        ivals.append((a, min(a + d, s1)))
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += d / 1e6
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        t = float(launch["ts"])
        for name, rs in ranges.items():
            i = bisect.bisect_right(rs, (t, float("inf"))) - 1
            if i >= 0 and rs[i][0] <= t <= rs[i][1]:
                op_s[name] += d / 1e6
    busy = _union(ivals)
    gaps: Dict[str, float] = {}
    order = sorted(dev, key=lambda e: float(e["ts"]))
    starts = [float(e["ts"]) for e in order]
    prev_end = s0
    for a, b in busy:
        if a > prev_end:
            ending = order[bisect.bisect_left(starts, a)]
            launch = launches.get(ending.get("args", {}).get("correlation"))
            label = "host"
            if launch is not None:
                op = by_ext.get(launch.get("args", {}).get("External id"))
                label = op["name"] if op is not None else launch.get("name", "host")
            gaps[label] = gaps.get(label, 0.0) + (a - prev_end) / 1e6
        prev_end = max(prev_end, b)
    if s1 > prev_end:
        gaps["end of span (synchronise)"] = gaps.get("end of span (synchronise)", 0.0) + (s1 - prev_end) / 1e6
    return {"window_s": (s1 - s0) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6, "kernels": kernels,
            "n_kernels": sum(v[0] for v in kernels.values()), "ops": op_s, "gaps": gaps}


def breakdown(rec: Dict) -> Dict:
    """The ten device kernels that took most time and the ten largest idle
    times by what the host was doing, each [name, seconds]."""
    ops = sorted(((n, v[1]) for n, v in rec["kernels"].items()), key=lambda x: -x[1])[:10]
    gaps = sorted(rec["gaps"].items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": [[n[:160], s] for n, s in gaps]}
