"""The model FLOPs of the window's completed images (counted from shapes by
portbench/work.py: DINO's patch embedding, nine blocks and block 9's qkv;
DPT's backbone, readouts, reassembly, fusion and head) over the window's
host-clock length and the 989 TFLOP/s bf16 peak. The program runs every
product but attention in float32, whose peak is 67 TFLOP/s: that caps it
near 7%."""

from portbench.metrics._common import mfu_pct as read  # noqa: F401
