"""The frozen-model backward's share of its roofline in TTO (data
cotangents only, the fine pass): its least time over the device time of the
kernels launched inside the backward node `RenderTrainRaysBackward`."""

from portbench.metrics._common import least_s, roofline_pct


def read(rec):
    return roofline_pct(least_s(rec, ("bwd_frozen",)), rec["trace"]["ops"]["RenderTrainRaysBackward"])
