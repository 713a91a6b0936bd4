"""Profiling, tracing and span utilities (upnerf/utils/profiling.py).

- `trace(logdir)`: a torch.profiler context over the CPU and, when one is
  present, the card; writes a Chrome trace (`trace.json`, for Perfetto or
  chrome://tracing) and the kernel table (`table.txt`) into `logdir`.
- `span(name)` / `spans()`: the program's spans. The train step, the TTO
  step and the served frame open one root span a unit of work and a span a
  stage inside it (`train.*`, `tto.*`, `serve.*`). Spans are off by
  default: `span` then returns a shared no-op after one check of a module
  flag, reads no clock and opens no profiler range. `spans()` turns them on
  for its block and yields the `SpanLog` they record into, in memory, on the
  host clock (`time.perf_counter_ns`). While a profiler is running, each
  span also opens `torch.profiler.record_function(name)`, so that it lands
  in the profiler's trace beside the kernels it launched.
- `summarize(metrics_jsonl)`: mean, median, last value and count of every
  numeric key of the training metrics stream.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

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


class SpanLog:
    """The spans recorded while `spans()` was open, in the order they
    opened. Each record is [name, parent, unit, t0, t1]: the parent's index
    in `records` (-1 for a root span), the unit (the index of the root span
    it opened under, so every span of one step or frame shares it), and the
    host clock in ns at the start and the end (None while it is open). Only
    the thread that opened `spans()` records."""

    def __init__(self):
        self.records: List[list] = []
        self.thread = threading.get_ident()
        self._open: List[int] = []

    @property
    def units(self) -> int:
        """The root spans seen."""
        return sum(1 for r in self.records if r[1] < 0)

    def totals(self) -> Dict[str, Tuple[int, float]]:
        """name -> (count, seconds) of the closed spans. A name opened more
        than once in one unit counts each time and sums."""
        out: Dict[str, Tuple[int, float]] = {}
        for name, _, _, t0, t1 in self.records:
            if t1 is not None:
                n, s = out.get(name, (0, 0.0))
                out[name] = (n + 1, s + (t1 - t0) / 1e9)
        return out

    def summary(self) -> Dict:
        """The units seen and each name's count and seconds, as JSON."""
        return {"units": self.units, "spans": {k: {"count": n, "s": s} for k, (n, s) in self.totals().items()}}


_log: Optional[SpanLog] = None  # the log spans record into; None: spans are off
_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("log", "name", "i", "rf")

    def __init__(self, log: SpanLog, name: str):
        self.log, self.name, self.i, self.rf = log, name, None, None

    def __enter__(self):
        log = self.log
        if threading.get_ident() != log.thread:
            return self
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        parent = log._open[-1] if log._open else -1
        self.i = len(log.records)
        unit = log.records[parent][2] if parent >= 0 else self.i
        log._open.append(self.i)
        log.records.append([self.name, parent, unit, time.perf_counter_ns(), None])
        return self

    def __exit__(self, *exc):
        if self.i is None:
            return False
        self.log.records[self.i][4] = time.perf_counter_ns()
        self.log._open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that records `name` while spans are on, and a
    shared no-op while they are off."""
    log = _log
    if log is None:
        return _NO_SPAN
    return _Span(log, name)


@contextlib.contextmanager
def spans():
    """Turns spans on for the block; yields the `SpanLog` they record into.
    The spans on before it are back on after it."""
    global _log
    prev, _log = _log, SpanLog()
    try:
        yield _log
    finally:
        _log = prev


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
