"""Fused NeRF trunk, forward and backward (upnerf/ops/pallas_mlp.py:fused_trunk).

D dense + ReLU layers over the positional encoding x0, with the input
[x0, h] at the skip layers: the trunk of NeRFField without its heads. The
sigma-only probe of the fast serving render runs it
(NeRFField.forward(sigma_only=True), upnerf_torch/render/fast.py), and so
does the feature-less field (`nerf.feat_dim: 0`, NeRFField.forward), which
trains through its backward.

- `trunk_chain` is the plain PyTorch trunk, every layer's input and output;
  `fused_trunk_plain` its last activation. In bfloat16 mode every product
  rounds h and W to bf16 and sums in f32, and the bias is added in f32, as the
  TPU kernel's `_dot` does. The plain versions of the trunk + heads kernels
  (ops/heads.py) and of the static render (ops/render.py) start from it.
- `trunk_walk_plain` walks the trunk back from the last activation's
  cotangent (the JAX kernel's `_bwd_kernel` loop); `fused_trunk_bwd_plain`
  recomputes the chain and walks it: dx0 and every layer's (dW, db).
- `fused_trunk_fwd` / `fused_trunk_bwd` are the wrappers: on CPU tensors they
  run the plain versions; on CUDA tensors they launch the trunk-only modes of
  the trunk + heads kernels (`csrc/heads_fwd.cu`, `csrc/heads_bwd.cu`, no head
  pointers) or raise. They count their launches in `launches` and
  `bwd_launches`.
- `fused_trunk` is the differentiable entry (the JAX custom VJP): with grad
  mode on and a trainable input, an autograd.Function whose backward
  recomputes the chain, as the JAX one does; otherwise the forward alone.
- `_padded_trunk` / `_layout` give the trunk weights in the layout of the
  heads kernels (forward and backward).

Weights come in the JAX kernel's interface: `trunk` is a sequence of
(W (in, out), b (out,)) pairs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from upnerf_torch.ops.linear import canonical_precision, matmul
from upnerf_torch.ops.render_train import X0_PAD, _pack_fragments, _pad_x0_rows, _ptrs, _raise_on, unpad_trunk_grad

KERNEL_W = 256  # the trunk width the CUDA kernels take
MAX_D = 16
BT = 32  # rows per tile of the backward kernel (csrc/walk_common.cuh)

# Kernel launches made in this process by fused_trunk_fwd / fused_trunk_bwd.
launches = 0
bwd_launches = 0


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


def trunk_walk_plain(x0, trunk, skips, precision: str, inputs, acts, g):
    """The trunk walked back, last layer first, from g (the cotangent of the
    last activation) through the chain (inputs, acts) of trunk_chain: the
    ReLU masks, each layer's (dW, db), the input cotangent split at the skip
    layers. Returns (dx0, [(dW, db)] per layer). Products as trunk_chain's."""
    prec = canonical_precision(precision)
    in0 = x0.shape[1]
    dx0 = torch.zeros_like(x0)
    dtrunk = [None] * len(trunk)
    for k in reversed(range(len(trunk))):
        g = g * (acts[k] > 0)
        dtrunk[k] = (matmul(inputs[k].t(), g, prec), g.sum(0))
        g_in = matmul(g, trunk[k][0].t(), prec)
        if k in skips and k > 0:
            dx0 = dx0 + g_in[:, :in0]
            g = g_in[:, in0:]
        elif k == 0:
            dx0 = dx0 + g_in
        else:
            g = g_in
    return dx0, dtrunk


def fused_trunk_bwd_plain(x, trunk, skips, precision: str, g):
    """Plain backward (pallas_mlp.py:_bwd_kernel, recomputing the chain):
    (dx (N, in0), [(dW, db)] per layer) for the cotangent g (N, W) of the last
    activation. float64 inputs run in float64 with precision float32
    (chip_smoke.py's witness)."""
    inputs, acts = trunk_chain(x, trunk, skips, precision)
    return trunk_walk_plain(x, trunk, skips, precision, inputs, acts, g.to(x.dtype))


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


def fused_trunk_fwd(
    x: torch.Tensor,
    trunk: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    skips: Tuple[int, ...],
    precision: str = "float32",
) -> torch.Tensor:
    """(N, W) last trunk activation: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors; the same arguments either way. The kernel
    takes W = 256, 3 + 6L <= 64 and D <= 16, and computes no gradient: inputs
    that require grad are refused while grad mode is on (train through
    `fused_trunk`)."""
    if x.device.type == "cpu":
        return fused_trunk_plain(x, trunk, skips, precision)
    if x.device.type != "cuda":
        raise ValueError(f"no trunk kernel for device {x.device}")
    global launches
    from upnerf_torch.ops import _build

    _check_args(x, trunk, skips)
    if torch.is_grad_enabled() and any(t.requires_grad for wb in trunk for t in (x, *wb)):
        raise RuntimeError("the CUDA trunk kernel is forward-only: run it under torch.no_grad()"
                           " or train through fused_trunk")
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
                                    _ptrs([out]), N, in0, 0, 0, int(bf16), stream)
    _raise_on(code, "heads_fwd (trunk only)", lib)
    launches += 1
    return out


def fused_trunk_bwd(x, trunk, skips, precision: str, g):
    """Backward: `fused_trunk_bwd_plain` for CPU tensors, the trunk-only mode
    of the trunk + heads backward kernel for CUDA tensors, with the same
    arguments and results. The kernel recomputes the chain per 32-row tile
    and adds the weight gradients over all rows with f32 atomic adds, so their
    last bits change from run to run; like the JAX kernel it computes them
    always."""
    if x.device.type == "cpu":
        return fused_trunk_bwd_plain(x, trunk, skips, precision, g)
    if x.device.type != "cuda":
        raise ValueError(f"no trunk kernel for device {x.device}")
    global bwd_launches
    from upnerf_torch.ops import _build

    _check_args(x, trunk, skips)
    N, in0 = x.shape
    W, D, dev = KERNEL_W, len(trunk), x.device
    if g.device != dev or g.dtype != torch.float32 or tuple(g.shape) != (N, W):
        raise ValueError(f"cotangent: {g.device} {g.dtype} {tuple(g.shape)}, expected {dev} torch.float32 {(N, W)}")
    bf16 = canonical_precision(precision) == "bfloat16"
    padded = _padded_trunk(trunk, skips, in0)
    tw = [_layout(w, bf16) for w in padded]
    tT = [_layout(w.t(), bf16) for w in padded]
    tb = [b.contiguous() for _, b in trunk]
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((N, in0), **f32)
    dtw = [torch.zeros(t.shape, **f32) for t in padded]
    dtb = [torch.zeros((W,), **f32) for _ in range(D)]
    # persistent blocks: two per SM in bfloat16 mode (~78 KB of shared memory each), one in float32 mode
    per_sm = 2 if bf16 else 1
    grid = min((N + BT - 1) // BT, per_sm * torch.cuda.get_device_properties(dev).multi_processor_count)
    scratch = torch.empty((grid * BT * D * W,), dtype=torch.bfloat16 if bf16 else torch.float32, device=dev)
    lib = _build.library("heads_bwd")
    skip_mask = sum(1 << i for i in skips if 0 < i < D)
    stream = torch.cuda.current_stream(dev).cuda_stream
    x, g = x.contiguous(), g.contiguous()
    with torch.cuda.device(dev):
        code = lib.upnerf_heads_bwd(x.data_ptr(), None, _ptrs([g]), _ptrs(tw), _ptrs(tb), _ptrs(tT), D, skip_mask,
                                    None, None, _ptrs([dx, None]), _ptrs(dtw), _ptrs(dtb), None, scratch.data_ptr(),
                                    N, in0, 0, 0, int(bf16), grid, stream)
    _raise_on(code, "heads_bwd (trunk only)", lib)
    bwd_launches += 1
    return dx, [(unpad_trunk_grad(dtw[i], i, skips, in0), dtb[i]) for i in range(D)]


class FusedTrunk(torch.autograd.Function):
    """Differentiable trunk (the JAX kernel's custom VJP): the forward kernel,
    and a backward that recomputes the chain.

    apply(x, skips, precision, *trunk_flat) -> (N, W)."""

    @staticmethod
    def forward(ctx, x, skips, precision, *weights):
        trunk = [(weights[2 * i], weights[2 * i + 1]) for i in range(len(weights) // 2)]
        ctx.skips, ctx.precision = skips, precision
        ctx.save_for_backward(x, *weights)
        return fused_trunk_fwd(x, trunk, skips, precision)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        trunk = [(weights[2 * i], weights[2 * i + 1]) for i in range(len(weights) // 2)]
        dx, dtrunk = fused_trunk_bwd(x, trunk, ctx.skips, ctx.precision, g.float())
        return (dx, None, None, *[t for wb in dtrunk for t in wb])


def fused_trunk(
    x: torch.Tensor,
    trunk: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    skips: Tuple[int, ...],
    precision: str = "float32",
) -> torch.Tensor:
    """(N, W) last trunk activation, differentiable: through FusedTrunk (the
    kernels on CUDA tensors, the plain versions on CPU tensors) when grad mode
    is on and an input requires grad, else fused_trunk_fwd."""
    flat = [t for wb in trunk for t in wb]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *flat)):
        return FusedTrunk.apply(x, tuple(skips), precision, *flat)
    return fused_trunk_fwd(x, trunk, skips, precision)
