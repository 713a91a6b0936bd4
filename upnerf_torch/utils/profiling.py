"""Profiling and timing utilities (upnerf/utils/profiling.py).

- `trace(logdir)`: a torch.profiler context over the CPU and, when one is
  present, the card; writes a Chrome trace (`trace.json`, for Perfetto or
  chrome://tracing) and the kernel table (`table.txt`) into `logdir`.
- `StepTimer`: times blocks of steps. Each block ends by calling `readout`,
  which must fetch a value that depends on the timed work (e.g. a parameter
  sum), so the time includes it; on the card the block is also timed by CUDA
  events around it, and those are the recorded times.
- `summarize(metrics_jsonl)`: mean, median, last value and count of every
  numeric key of the training metrics stream.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort = "self_cuda_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
    with open(os.path.join(logdir, "table.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=40))


class StepTimer:
    """Times blocks of steps; `readout` must fetch a value data-dependent on
    the timed computation. `device`: a CUDA device times each block with
    events on its current stream; anything else (the default) by the host
    clock around the block and its readout."""

    def __init__(self, readout: Callable[[], float], device: Optional[torch.device] = None):
        self.readout = readout
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.records: List[float] = []

    @contextlib.contextmanager
    def measure(self, n_steps: int = 1):
        if self.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        yield
        if self.cuda:
            end.record()
        self.readout()
        if self.cuda:
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - t0
        self.records.append(dt / n_steps)

    @property
    def mean(self) -> float:
        return float(np.mean(self.records)) if self.records else float("nan")

    @property
    def p50(self) -> float:
        return float(np.percentile(self.records, 50)) if self.records else float("nan")


def summarize(metrics_jsonl: str) -> Dict[str, Dict[str, float]]:
    rows: Dict[str, List[float]] = {}
    with open(metrics_jsonl) as f:
        for line in f:
            rec = json.loads(line)
            for k, v in rec.items():
                if isinstance(v, (int, float)) and k not in ("step", "time"):
                    rows.setdefault(k, []).append(float(v))
    return {
        k: {"mean": float(np.mean(v)), "p50": float(np.percentile(v, 50)), "last": v[-1], "n": len(v)}
        for k, v in rows.items()
    }
