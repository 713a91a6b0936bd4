"""Training-progress schedules (upnerf/train/schedules.py), on the host.

progress = step / max_steps in [0, 1]. The candidate schedule maps progress
through a cosine ramp over [start, end]; its value selects the phase:
  phase 0: sched_mult == 0 (feature/candidate training)
  phase 1: 0 < sched_mult < 1 (blend)
  phase 2: sched_mult == 1 (rgb; candidate head off)
Both are host floats computed in float32, as the JAX step computes them on
the device, so no scalar is copied to the device per step.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def pe_progress(step: int, max_steps: int) -> float:
    """step / max_steps in float32, as the JAX step divides state.step."""
    return float(np.float32(step) / np.float32(max_steps))


def schedule_mult(progress: float, candidate_schedule: Tuple[float, float]) -> float:
    """Cosine ramp of the candidate schedule: 0 below start, 1 above end."""
    s, e = (np.float32(v) for v in candidate_schedule)
    x = np.clip((np.float32(progress) - s) / (e - s), np.float32(0.0), np.float32(1.0))
    return float((np.float32(1.0) - np.cos(np.float32(np.pi) * x)) / np.float32(2.0))


def schedule_phase(progress: float, candidate_schedule: Tuple[float, float]) -> int:
    """Phase id for a host-side progress."""
    s, e = candidate_schedule
    if progress < s:
        return 0
    if progress > e:
        return 2
    m = (1.0 - math.cos(math.pi * (progress - s) / (e - s))) / 2.0
    if m <= 0.0:
        return 0
    if m >= 1.0:
        return 2
    return 1
