"""Weight gradients of a backward walk: dW = X^T G and db = sum G over the rows
(csrc/dw_gemm.cu), for the walks that store their operands instead of adding
the gradients themselves (render_train_bwd.cu's DW_OPS mode).

The inputs are up to three sources, 2-D and row-major, all bf16 or all f32,
whose rows are the reduction dimension (samples, or rays), and a job table:
each `DwJob`
multiplies a strip of one source's columns (X) by a strip of another's (G),
both whole 64-column blocks, summed over their common rows in f32, and
keeps output rows [0, m_out) and columns [g0, g0 + n_out) at `out_off` of a
flat f32 result with row stride `ldo`. Bias rows (rows x nb f32, each a
partial column sum) are summed into the result's tail [n_dw, n_dw + nb).
`accumulate` adds into the result instead of writing it: a backward call
over several slabs of rays adds the slabs in order.

- `dw_gemm_plain` is the plain version: X^T G of the operands as stored (bf16
  values are exact in f32), products summed in f32, with torch.matmul.
- `dw_gemm` is the wrapper: the plain version for CPU tensors, the kernel
  for CUDA tensors (counted in `dw_launches`), or it raises. It picks the
  kernel's instance by the sources' dtype: bf16 on the tensor cores, f32 in
  SIMT FMAs (no TF32). The kernel sums in a fixed order, so two calls on the
  same inputs give the same bits.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence

import torch

BLOCK = 64  # columns of a strip block (128 bytes of bf16: one TMA box and swizzle span)
SPLIT_ROWS = 8192  # rows of a sample range a kernel block reduces, at most, before the fixed-order sum
# The float32 instance's: each thread sums its range's rows one after another, and f32 rounding grows with that
# run (at 8,192 rows its weight gradients landed 2.3x further from a float64 witness than cuBLAS's, on one
# H100); runs of 512 rows, up to MAX_SPLITS ranges, keep it within the rounding of the atomics it replaced.
SPLIT_ROWS_F32 = 512
MAX_SPLITS = 64

# Kernel launches made in this process by dw_gemm.
dw_launches = 0


class DwJob(NamedTuple):
    """One product X^T G; the field order is the kernel's job row."""

    x_src: int
    x_col: int
    x_cols: int
    g_src: int
    g_col: int
    g_cols: int
    g0: int
    n_out: int
    m_out: int
    out_off: int
    ldo: int


def splits(rows: int, f32: bool = False) -> int:
    """Sample ranges the kernel cuts a job's rows into: one block of the card
    reduces each range, and the partials are then summed in range order."""
    return max(1, min(MAX_SPLITS, math.ceil(rows / (SPLIT_ROWS_F32 if f32 else SPLIT_ROWS))))


def dw_gemm_plain(srcs: Sequence[Optional[torch.Tensor]], jobs: Sequence[DwJob], out: torch.Tensor, n_dw: int,
                  bias_rows: Optional[torch.Tensor], accumulate: bool) -> torch.Tensor:
    """out[:n_dw] (+)= the jobs' products, out[n_dw:] (+)= bias_rows summed
    over its rows; in f32 from the stored operands. Returns out."""
    dw = torch.zeros((n_dw,), dtype=out.dtype, device=out.device)
    for j in jobs:
        x = srcs[j.x_src][:, j.x_col : j.x_col + j.x_cols][:, : j.m_out].to(out.dtype)
        g = srcs[j.g_src][:, j.g_col + j.g0 : j.g_col + j.g0 + j.n_out].to(out.dtype)
        view = dw[j.out_off : j.out_off + (j.m_out - 1) * j.ldo + j.n_out].as_strided((j.m_out, j.n_out), (j.ldo, 1))
        view.copy_(x.t() @ g)
    parts = [dw] + ([bias_rows.to(out.dtype).sum(0)] if bias_rows is not None else [])
    total = torch.cat(parts)
    if accumulate:
        out += total
    else:
        out.copy_(total)
    return out


def dw_gemm(srcs: Sequence[Optional[torch.Tensor]], jobs: Sequence[DwJob], out: torch.Tensor, n_dw: int,
            bias_rows: Optional[torch.Tensor], accumulate: bool) -> torch.Tensor:
    """dw_gemm_plain's function: the plain version for CPU tensors, the
    hand-written kernel for CUDA tensors (bf16 or f32 sources, all of one
    dtype; f32 out and bias rows; all contiguous). Returns out."""
    if out.device.type == "cpu":
        return dw_gemm_plain(srcs, jobs, out, n_dw, bias_rows, accumulate)
    if out.device.type != "cuda":
        raise ValueError(f"no dW kernel for device {out.device}")
    from upnerf_torch.ops import _build

    global dw_launches
    nb = 0 if bias_rows is None else bias_rows.shape[1]
    if out.dtype != torch.float32 or not out.is_contiguous() or out.numel() != n_dw + nb:
        raise ValueError(f"out must be contiguous f32 of {n_dw} + {nb} floats; got {out.dtype} {tuple(out.shape)}")
    srcs = list(srcs) + [None] * (3 - len(srcs))
    dtype = next(t.dtype for t in srcs if t is not None)
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"no dW kernel for {dtype} sources (bf16 or f32)")
    for i, t in enumerate(srcs):
        if t is not None and (t.device != out.device or t.dtype != dtype or t.dim() != 2 or not t.is_contiguous()):
            raise ValueError(f"source {i} must be a contiguous 2-D {dtype} tensor on {out.device}, as the others")
    if bias_rows is not None and (bias_rows.device != out.device or bias_rows.dtype != torch.float32
                                  or not bias_rows.is_contiguous()):
        raise ValueError(f"bias rows must be contiguous f32 on {out.device}")
    rows = [0 if t is None else t.shape[0] for t in srcs]
    n_split = splits(max(rows), dtype == torch.float32)
    ws = torch.empty((n_split * n_dw,), dtype=torch.float32, device=out.device)
    table = (ctypes.c_int * (11 * len(jobs)))(*[v for j in jobs for v in j])
    ints = lambda vals: (ctypes.c_int * 3)(*vals)  # noqa: E731
    lib = _build.library("dw_gemm")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        code = lib.upnerf_dw_gemm(
            (ctypes.c_void_p * 3)(*[0 if t is None else t.data_ptr() for t in srcs]), ints(rows),
            ints([0 if t is None else t.shape[1] for t in srcs]), table, len(jobs), ws.data_ptr(), n_split,
            out.data_ptr(), n_dw, None if bias_rows is None else bias_rows.data_ptr(),
            0 if bias_rows is None else bias_rows.shape[0], nb, int(accumulate), int(dtype == torch.float32), stream,
        )
    if code != 0:
        raise RuntimeError(f"dw_gemm kernel failed ({code}): {lib.upnerf_error_string(code).decode()}")
    dw_launches += 1
    return out
