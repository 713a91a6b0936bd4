"""Arithmetic shared by the per-layer readers. A reader takes the run's
record (portbench/run.py: the driver's record, `window`, `span`, `trace`)
and returns a number, or None where it finds nothing to read."""

from __future__ import annotations

import re
from typing import Dict, Optional

from portbench import work


def idle_pct(rec: Dict) -> Optional[float]:
    """The share of an untraced unit with nothing on the device: the traced
    span's device-busy time a unit over the window's host-clock time a unit.
    The profiler slows the host by some microseconds a launch, so a traced
    span's own length would count that cost as idle time; kernels' device
    times it leaves alone."""
    t, w, units = rec["trace"], rec["window"], rec["span"]["units"]
    if t["busy_s"] <= 0 or units == 0 or w["units"] == 0 or w["seconds"] <= 0:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / units) / (w["seconds"] / w["units"]))


def mfu_pct(rec: Dict) -> Optional[float]:
    """The model FLOPs of the window's completed units over its host-clock
    length and the bf16 peak."""
    w = rec["window"]
    if w["units"] == 0 or w["seconds"] <= 0:
        return None
    return 100.0 * w["units"] * w["unit_flops"] / w["seconds"] / work.PEAK_FLOPS_BF16


def least_s(rec: Dict, kinds) -> float:
    """The least time of the traced span's passes of the given kinds."""
    one = sum(work.pass_least_seconds(rec["dims"], work.mode_of_phase(phase), R, S, kind)
              for kind, phase, R, S in rec["passes"] if kind in kinds)
    return one * rec["span"]["units"]


def roofline_pct(least: float, device_s: float) -> Optional[float]:
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s


def kernel_seconds(rec: Dict, pattern: str) -> float:
    """Device seconds of the span's kernels whose name matches `pattern`."""
    rx = re.compile(pattern)
    return sum(s for name, (n, s) in rec["trace"]["kernels"].items() if rx.search(name))
