"""The matrix-unit probe (scripts/bench_mxu_probe.py): a chain of L products
(M, W) @ (W, W), in three kinds, the functions of the JAX probe's kernel bodies:

- "pure" (`kern_pure`): h = bf16(x); per layer h = bf16(h @ bf16(W_i)) with f32
  accumulation;
- "epi" (`kern_epi`): h = x in f32; per layer h = relu(bf16(h) @ bf16(W_i) + b)
  with f32 accumulation;
- "int8" (`kern_int8`): h = q(x), q(v) = int8(clip(v 127, -127, 127)) truncated
  toward zero; per layer acc = h @ W_i in int32 (W_i int8), h = q(max(acc /
  127^2, 0)).

Each returns h as f32 (M, W). `copies` repeats the chain over the M rows as the
TPU probe's grid repeats its block; the result is the chain applied once.

- `mxu_probe_plain` is the plain PyTorch version: a loop of torch.matmul in
  f32 (TF32 off) on the rounded operands. The int8 chain runs as f32 products
  of the int8 values, which is exact: |acc| <= W 127^2 < 2^24 for W <= 1040.
- `mxu_probe` is the wrapper: on CPU tensors the plain version, on CUDA
  tensors the hand-written kernel (`csrc/mxu_probe.cu`, W = 256) or an error.
  It counts its launches per kind in `launches`.
- `probe_inputs` draws x, the weights and the bias from a seed in the JAX
  script's order, and the int8 weights as it quantises them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

CHAINS = ("pure", "epi", "int8")
KERNEL_W = 256  # the width the CUDA kernel takes
SCALE = 1.0 / (127 * 127)  # the int8 chain's dequantisation, as the JAX body writes it

# Kernel launches made in this process by mxu_probe, per chain.
launches: Dict[str, int] = {c: 0 for c in CHAINS}


def probe_inputs(M: int, W: int, L: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(x (M, W) f32, ws (L, W, W) f32, b (W,) f32, ws_i8 (L, W, W) int8) drawn
    from np.random.RandomState(seed) in the order of scripts/bench_mxu_probe.py
    (:43-46), ws_i8 quantised as :117-119 does."""
    rng = np.random.RandomState(seed)
    x = rng.randn(M, W).astype(np.float32) * 0.1
    ws = rng.randn(L, W, W).astype(np.float32) * 0.05
    b = rng.randn(W).astype(np.float32) * 0.01
    ws_i8 = np.clip(ws * 127 / np.abs(ws).max(), -127, 127).astype(np.int8)
    return x, ws, b, ws_i8


def _quant(v: torch.Tensor) -> torch.Tensor:
    """int8(clip(v 127, -127, 127)), truncated toward zero, held in f32."""
    return torch.clamp(v * 127.0, -127, 127).to(torch.int8).float()


def mxu_probe_plain(x: torch.Tensor, ws: torch.Tensor, b: Optional[torch.Tensor], chain: str,
                    copies: int = 1) -> torch.Tensor:
    """The chain in plain PyTorch: x (M, W) f32, ws (L, W, W) (f32 for "pure" and
    "epi", int8 for "int8"), b (W,) f32 ("epi"). Runs on copies x M rows and
    returns the first M (all copies are equal)."""
    if chain not in CHAINS:
        raise ValueError(f"chain must be one of {CHAINS}; got {chain!r}")
    M = x.shape[0]
    h = x.repeat(copies, 1) if copies > 1 else x
    if chain == "int8":
        h = _quant(h)
        for w in ws.float():
            h = _quant(torch.relu(torch.matmul(h, w) * SCALE))
        return h[:M]
    wb = ws.to(torch.bfloat16).float()
    h = h.to(torch.bfloat16).float() if chain == "pure" else h
    for w in wb:
        acc = torch.matmul(h.to(torch.bfloat16).float(), w)
        h = acc.to(torch.bfloat16).float() if chain == "pure" else torch.relu(acc + b)
    return h[:M]


def pack_weights(ws: torch.Tensor) -> torch.Tensor:
    """(L, K, N) weights -> the kernel's fragment order, one contiguous run of
    K N elements a layer: per 8-column tile nt and k-step ks, lane g*4 + t
    holds its two B registers. bf16 (m16n8k16): W[16 ks + 2t + {0, 1}, 8 nt + g]
    then W[16 ks + 8 + 2t + {0, 1}, 8 nt + g]; int8 (m16n8k32): W[32 ks + 4t +
    {0..3}, 8 nt + g] then W[32 ks + 16 + 4t + {0..3}, 8 nt + g]."""
    L, K, N = ws.shape
    e = 4 if ws.dtype == torch.int8 else 2
    wt = ws.transpose(1, 2)  # (L, N, K): adjacent k adjacent in memory
    return wt.reshape(L, N // 8, 8, K // (8 * e), 2, 4, e).permute(0, 1, 3, 2, 5, 4, 6).contiguous()


def mxu_probe(x: torch.Tensor, ws: torch.Tensor, b: Optional[torch.Tensor], chain: str,
              copies: int = 1, packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The chain (arguments as mxu_probe_plain's): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (W = 256; x f32, ws f32 rounded
    to bf16 by the wrapper, or int8; b f32), copies x ceil(M / 64) blocks.
    packed: pack_weights of ws in the kernel's type, where the caller keeps
    it (a timing loop); None packs ws here."""
    if x.device.type == "cpu":
        return mxu_probe_plain(x, ws, b, chain, copies)
    if x.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {x.device}")
    if chain not in CHAINS:
        raise ValueError(f"chain must be one of {CHAINS}; got {chain!r}")
    from upnerf_torch.ops import _build
    from upnerf_torch.ops.render_train import _raise_on

    M, W = x.shape
    L = ws.shape[0]
    want = torch.int8 if chain == "int8" else torch.float32
    if W != KERNEL_W or tuple(ws.shape) != (L, W, W) or x.dtype != torch.float32 or ws.dtype != want:
        raise ValueError(f"the probe kernel takes x f32 (M, {KERNEL_W}) and ws {want} (L, {KERNEL_W}, {KERNEL_W});"
                         f" got x {x.dtype} {tuple(x.shape)}, ws {ws.dtype} {tuple(ws.shape)}")
    if chain == "epi" and (b is None or b.dtype != torch.float32 or tuple(b.shape) != (W,)):
        raise ValueError(f"the epi chain takes b f32 ({W},)")
    if ws.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("x, ws and b must be on one device")
    if copies <= 0:
        raise ValueError(f"copies must be positive; got {copies}")
    kdt = torch.int8 if chain == "int8" else torch.bfloat16
    if packed is None:
        packed = pack_weights(ws.to(kdt))
    elif packed.dtype != kdt or packed.numel() != L * W * W or not packed.is_contiguous():
        raise ValueError(f"packed must be pack_weights of ws in {kdt}")
    x = x.contiguous()
    bias = b.contiguous() if chain == "epi" else None
    out = torch.empty((M, W), dtype=torch.float32, device=x.device)
    lib = _build.library("mxu_probe")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.upnerf_mxu_probe(x.data_ptr(), packed.data_ptr(), None if bias is None else bias.data_ptr(),
                                    out.data_ptr(), M, W, L, copies, CHAINS.index(chain), stream)
    _raise_on(code, f"mxu_probe ({chain})", lib)
    launches[chain] += 1
    return out
