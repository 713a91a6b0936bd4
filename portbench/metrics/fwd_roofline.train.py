"""The render forward's share of its roofline in training: the least time
of both passes' forward work (portbench/work.py, phase's mode, 2048 rays x
the pass's samples) over the device time of the kernels launched inside the
host op `RenderTrainRays` (the autograd.Function of ops/render_train.py)."""

from portbench.metrics._common import least_s, roofline_pct


def read(rec):
    return roofline_pct(least_s(rec, ("fwd",)), rec["trace"]["ops"]["RenderTrainRays"])
