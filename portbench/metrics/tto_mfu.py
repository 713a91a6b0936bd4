"""The model FLOPs of the window's completed units (counted from shapes by
portbench/work.py: forward and backward of every sample of both passes, no
recomputation) over the window's host-clock length and the 989 TFLOP/s
bf16 peak."""

from portbench.metrics._common import mfu_pct as read  # noqa: F401
