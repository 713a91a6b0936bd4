"""The serving forward's share of its roofline: the least time of both
passes over every chunk of the span's frames, over the device time of the
forward kernels. The serving forward runs outside any autograd op, so the
kernels are found by name: those of csrc/render_train_fwd.cu (the x0
pre-pass and the bf16 main kernel, or the f32 one)."""

from portbench.metrics._common import kernel_seconds, least_s, roofline_pct

KERNELS = r"\b(x0_rows_kernel|wg_kernel|bf16_kernel)\b"


def read(rec):
    return roofline_pct(least_s(rec, ("fwd",)), kernel_seconds(rec, KERNELS))
