"""The flash-attention kernel's share of its roofline in DINO's blocks: the
least time of the traced span's attention calls (portbench/work.py, each
(heads, tokens, head width) call's two products against the bf16 peak, or
its float32 q, k, v and output against HBM) over the device time of the
kernels of csrc/flash_attn_fwd.cu, found by name: the bf16 pre-pass and
the main kernel. DPT's attention (577 tokens) runs dense in PyTorch and is
not counted."""

from portbench import work
from portbench.metrics._common import kernel_seconds, roofline_pct

KERNELS = r"\b(round_kernel|ws_kernel)\b"


def read(rec):
    least = sum(work.attention_least_seconds(*call) for call in rec["attn_calls"]) * rec["span"]["units"]
    return roofline_pct(least, kernel_seconds(rec, KERNELS))
