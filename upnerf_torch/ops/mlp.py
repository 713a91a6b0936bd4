"""Fused NeRF trunk, forward (upnerf/ops/pallas_mlp.py:fused_trunk).

D dense + ReLU layers over the positional encoding x0, with the input
[x0, h] at the skip layers: the trunk of NeRFField without its heads. The
sigma-only probe of the fast serving render runs it
(NeRFField.forward(sigma_only=True), upnerf_torch/render/fast.py).

- `trunk_chain` is the plain PyTorch trunk, every layer's input and output;
  `fused_trunk_plain` its last activation. In bfloat16 mode every product
  rounds h and W to bf16 and sums in f32, and the bias is added in f32, as the
  TPU kernel's `_dot` does. The plain versions of the trunk + heads kernels
  (ops/heads.py) and of the static render (ops/render.py) start from it.
- `fused_trunk` is the wrapper: on a CPU tensor it runs the plain version; on
  a CUDA tensor it launches the trunk-only mode of the trunk + heads forward
  kernel (`csrc/heads_fwd.cu`, no head pointers) or raises. It counts its
  launches in `launches`.
- `_padded_trunk` / `_layout` give the trunk weights in the layout of the
  heads kernels (forward and backward).

Weights come in the JAX kernel's interface: `trunk` is a sequence of
(W (in, out), b (out,)) pairs. The kernel computes no gradient (the JAX
kernel's backward, pallas_mlp.py:193-244, is not ported: no path of the port
differentiates the trunk alone).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from upnerf_torch.ops.linear import canonical_precision, matmul
from upnerf_torch.ops.render_train import X0_PAD, _pack_fragments, _pad_x0_rows, _ptrs, _raise_on

KERNEL_W = 256  # the trunk width the CUDA kernel takes
MAX_D = 16

# Kernel launches made in this process by fused_trunk.
launches = 0


def trunk_chain(
    x: torch.Tensor,  # (N, in0) PE input
    trunk: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    skips: Tuple[int, ...],
    precision: str = "float32",
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(layer inputs, layer activations) of the trunk, plain PyTorch."""
    prec = canonical_precision(precision)
    inputs, acts = [], []
    h = x
    for i, (w, b) in enumerate(trunk):
        if i in skips and i > 0:
            h = torch.cat([x, h], dim=-1)
        inputs.append(h)
        h = torch.relu(matmul(h, w, prec) + b)
        acts.append(h)
    return inputs, acts


def fused_trunk_plain(
    x: torch.Tensor,  # (N, in0) PE input
    trunk: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    skips: Tuple[int, ...],
    precision: str = "float32",
) -> torch.Tensor:
    """(N, W) last trunk activation, plain PyTorch."""
    return trunk_chain(x, trunk, skips, precision)[1][-1]


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


def _padded_trunk(trunk, skips, in0):
    """Each layer's (in, W) weight with the x0 rows padded to X0_PAD (layer 0, skips)."""
    return [_pad_x0_rows(w, in0) if i == 0 or i in skips else w for i, (w, _) in enumerate(trunk)]


def _layout(w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A product's (K, N) weight: bf16 packed in fragment order, or f32 row-major."""
    return _pack_fragments(w) if bf16 else w.contiguous()


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
    ws = [_layout(w, bf16) for w in _padded_trunk(trunk, skips, in0)]
    bs = [b.contiguous() for _, b in trunk]
    x = x.contiguous()
    out = torch.empty((N, KERNEL_W), dtype=torch.float32, device=x.device)
    lib = _build.library("heads_fwd")
    skip_mask = sum(1 << i for i in skips if 0 < i < len(trunk))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.upnerf_heads_fwd(x.data_ptr(), None, _ptrs(ws), _ptrs(bs), len(trunk), skip_mask, None,
                                    _ptrs([out]), N, in0, 0, int(bf16), stream)
    _raise_on(code, "heads_fwd (trunk only)", lib)
    launches += 1
    return out
