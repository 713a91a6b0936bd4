"""Fused NeRF trunk, forward (upnerf/ops/pallas_mlp.py:fused_trunk).

D dense + ReLU layers over the positional encoding x0, with the input
[x0, h] at the skip layers: the trunk of NeRFField without its heads. The
sigma-only probe of the fast serving render runs it
(NeRFField.forward(sigma_only=True), upnerf_torch/render/fast.py).

- `fused_trunk_plain` is the plain PyTorch version. In bfloat16 mode every
  product rounds h and W to bf16 and sums in f32, and the bias is added in
  f32, as the TPU kernel's `_dot` does.
- `fused_trunk` is the wrapper: on a CPU tensor it runs the plain version; on
  a CUDA tensor it launches the hand-written kernel (`csrc/mlp_fwd.cu`) or
  raises. It counts its launches in `launches`. Its bf16 weights take the
  fused render forward's trunk layout (render_train.pack_trunk_weight).

Weights come in the JAX kernel's interface: `trunk` is a sequence of
(W (in, out), b (out,)) pairs. The kernel computes no gradient (the JAX
kernel's backward, pallas_mlp.py:193-244, is not ported: no path of the port
differentiates the trunk outside the fused render).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from upnerf_torch.ops.linear import canonical_precision, matmul
from upnerf_torch.ops.render_train import X0_PAD, _ptrs, _raise_on, pack_trunk_weight

KERNEL_W = 256  # the trunk width the CUDA kernel takes
MAX_D = 16

# Kernel launches made in this process by fused_trunk.
launches = 0


def fused_trunk_plain(
    x: torch.Tensor,  # (N, in0) PE input
    trunk: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    skips: Tuple[int, ...],
    precision: str = "float32",
) -> torch.Tensor:
    """(N, W) last trunk activation, plain PyTorch."""
    prec = canonical_precision(precision)
    h = x
    for i, (w, b) in enumerate(trunk):
        if i in skips and i > 0:
            h = torch.cat([x, h], dim=-1)
        h = torch.relu(matmul(h, w, prec) + b)
    return h


def _check_args(x: torch.Tensor, trunk, skips) -> None:
    N, in0 = x.shape
    D = len(trunk)
    if x.dtype != torch.float32 or in0 > X0_PAD or not 0 < D <= MAX_D:
        raise ValueError(f"the CUDA trunk kernel takes f32 x with 3 + 6L <= {X0_PAD} columns and D <= {MAX_D};"
                         f" got {x.dtype} {tuple(x.shape)}, D = {D}")
    for i, (w, b) in enumerate(trunk):
        fan_in = in0 if i == 0 else (in0 + KERNEL_W if i in skips else KERNEL_W)
        for name, t, shape in ((f"trunk[{i}].w", w, (fan_in, KERNEL_W)), (f"trunk[{i}].b", b, (KERNEL_W,))):
            if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
                raise ValueError(f"{name}: {t.device} {t.dtype} {tuple(t.shape)}, the kernel takes"
                                 f" {x.device} torch.float32 {shape} (W = {KERNEL_W})")


def fused_trunk(
    x: torch.Tensor,
    trunk: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    skips: Tuple[int, ...],
    precision: str = "float32",
) -> torch.Tensor:
    """(N, W) last trunk activation: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors; the same arguments either way. The kernel
    takes W = 256, 3 + 6L <= 64 and D <= 16, and is forward-only: inputs that
    require grad are refused while grad mode is on."""
    if x.device.type == "cpu":
        return fused_trunk_plain(x, trunk, skips, precision)
    if x.device.type != "cuda":
        raise ValueError(f"no trunk kernel for device {x.device}")
    global launches
    from upnerf_torch.ops import _build

    _check_args(x, trunk, skips)
    if torch.is_grad_enabled() and any(t.requires_grad for wb in trunk for t in (x, *wb)):
        raise RuntimeError("the CUDA trunk kernel is forward-only: run it under torch.no_grad()")
    N, in0 = x.shape
    bf16 = canonical_precision(precision) == "bfloat16"
    ws, bs = [], []
    for i, (w, b) in enumerate(trunk):
        ws.append(pack_trunk_weight(w, in0 if i == 0 or i in skips else None) if bf16 else w.contiguous())
        bs.append(b.contiguous())
    x = x.contiguous()
    out = torch.empty((N, KERNEL_W), dtype=torch.float32, device=x.device)
    lib = _build.library("mlp_fwd")
    skip_mask = sum(1 << i for i in skips if 0 < i < len(trunk))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.upnerf_mlp_fwd(x.data_ptr(), _ptrs(ws), _ptrs(bs), len(trunk), skip_mask, out.data_ptr(), N, in0,
                                  int(bf16), stream)
    _raise_on(code, "mlp_fwd", lib)
    launches += 1
    return out
