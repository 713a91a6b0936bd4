"""The render backward's share of its roofline in training (data and
weight gradients): the least time of both passes' backward work over the
device time of the kernels launched inside the backward node
`RenderTrainRaysBackward` (walk, pre-pass, finishing pass and dW)."""

from portbench.metrics._common import least_s, roofline_pct


def read(rec):
    return roofline_pct(least_s(rec, ("bwd",)), rec["trace"]["ops"]["RenderTrainRaysBackward"])
