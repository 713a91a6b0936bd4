"""Forward-only flash attention for the offline extractors
(upnerf/ops/pallas_attention.py).

`softmax(q k^T * scale) v` per leading index g, for q, k, v of shape
(G, N, hd) float32 (G = batch * heads folded), without materializing the
(N, N) scores: the online softmax walks the keys in tiles and keeps the
running row max m, row sum l and the value accumulator in float32.

- `flash_attention_plain` is the plain PyTorch version: the same online
  softmax as a loop over key tiles of `block_k`, rounding where the kernel
  rounds. In bfloat16 mode q is scaled in float32 and then rounded, k and v
  are rounded, and each tile's p = exp(s - m_new) is rounded for the p v
  product while l sums the float32 p. The result therefore depends on the
  key-tile size: p is rounded relative to the running max at its tile.
- `flash_attention` is the wrapper: on CPU tensors it runs the plain version
  at the kernel's key tile (BLOCK_K); on CUDA tensors it launches the CUDA
  kernel (`csrc/flash_attn_fwd.cu`) on the current stream, or raises. It
  counts its calls in `launches`.

The CUDA kernel replaces the TPU kernel `_flash_kernel`
(upnerf/ops/pallas_attention.py:41, reached through `flash_attention`
:102). At the DINO extractor's shape (6 heads x 12,322 tokens x 64) a call
is 233 GFLOP of products (0.236 ms at the H100's 989 TFLOP/s bf16 peak)
and 911 M exponentials (~0.22 ms at the SFU's 16 a clock per SM), so both
the tensor cores and the SFUs bound it. In bfloat16 mode one call is two
kernels, counted as one launch of this function:
- a pre-pass writes q * scale, k and v rounded to bf16 into three scratch
  tensors allocated here (28 MB at the DINO shape), as `_bf16` rounds them,
  so that no block reads or converts f32 k and v;
- a warp-specialised kernel: a producer warp streams the block's q tile and
  128-key tiles of k and v by TMA into a ring of shared-memory stages, and
  three consumer warpgroups (64 query rows each, 192 a block) run
  S = Q K^T and O += P V as wgmma products with P from registers, issuing
  the next tile's S with the previous tile's P V so that the softmax
  (exponentials on the SFUs) overlaps the products. Each block reads its
  group's bf16 k and v once from L2: ~1.2 GB a call, 390 blocks in 2.95
  waves at the DINO shape.
The float32 mode is a SIMT kernel (no TF32).

There is no VJP: the extractors are offline inference, as in the JAX
package.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # finite: exp(NEG_INF - m) == 0 with no inf - inf
BLOCK_K = 128  # the CUDA kernel's key tile in bfloat16 mode (csrc/flash_attn_fwd.cu:WS_BN)
BLOCK_Q = 192  # its query rows a block: 3 consumer warpgroups x 64 (csrc/flash_attn_fwd.cu:WS_BM)
HEAD_DIM = 64  # the head width the CUDA kernel takes

# Calls of the CUDA kernel made in this process by flash_attention (in
# bfloat16 mode each is the pre-pass and the main kernel).
launches = 0


def _is_bf16(compute_dtype) -> bool:
    if compute_dtype in (torch.bfloat16, "bfloat16"):
        return True
    if compute_dtype in (torch.float32, "float32"):
        return False
    raise ValueError(f"compute_dtype must be bfloat16 or float32, got {compute_dtype!r}")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back: a product of two such values is exact in
    float32, so an f32 matmul of rounded operands is the bf16 x bf16 -> f32
    product."""
    return x.to(torch.bfloat16).float()


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    compute_dtype=torch.bfloat16,
    block_k: int = BLOCK_K,
) -> torch.Tensor:
    """The online softmax over key tiles of `block_k`, in PyTorch; f32
    (G, N, hd) out."""
    bf16 = _is_bf16(compute_dtype)
    G, N, hd = q.shape
    if k.shape != (G, N, hd) or v.shape != (G, N, hd):
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    qs = q.float() * scale
    kf, vf = k.float(), v.float()
    if bf16:
        qs, kf, vf = _bf16(qs), _bf16(kf), _bf16(vf)
    m = torch.full((G, N, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((G, N, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((G, N, hd), dtype=torch.float32, device=q.device)
    for j0 in range(0, N, block_k):
        s = qs @ kf[:, j0 : j0 + block_k].transpose(1, 2)  # (G, N, bk); keys >= N are not there to mask
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        pv = (_bf16(p) if bf16 else p) @ vf[:, j0 : j0 + block_k]
        acc = acc * alpha + pv
        m = m_new
    return acc / l


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _dense_aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself if it is contiguous with a 16-byte aligned data pointer (the
    kernels read 16 bytes a thread), else a fresh contiguous copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, bf16: bool):
    """One call of the CUDA kernel on (G, N, 64) float32 CUDA tensors that
    `flash_attention` has checked; returns (out, (qb, kb, vb)), the bf16
    scratch that the pre-pass wrote (None in float32 mode)."""
    from upnerf_torch.ops import _build

    G, N, hd = q.shape
    q, k, v = _dense_aligned(q), _dense_aligned(k), _dense_aligned(v)
    out = torch.empty_like(q)
    scratch = None
    ptrs = (None, None, None)
    if bf16:
        scratch = tuple(torch.empty((G, N, hd), dtype=torch.bfloat16, device=q.device) for _ in range(3))
        ptrs = tuple(t.data_ptr() for t in scratch)
        if any(p % 16 for p in ptrs):  # TMA reads 16-byte aligned bases; the caching allocator gives 512
            raise RuntimeError("bf16 scratch of the attention kernel is not 16-byte aligned")
    lib = _build.library("flash_attn_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.upnerf_flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *ptrs, G, N, hd,
                                         float(scale), int(bf16), stream)
    if code != 0:
        raise RuntimeError(f"flash_attn_fwd kernel failed ({code}): {lib.upnerf_error_string(code).decode()}")
    return out, scratch


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """`softmax(q k^T * scale) v` for (G, N, hd) float32 q, k, v; float32
    (G, N, hd) out. Products in bfloat16 (default) or float32.

    CPU tensors: `flash_attention_plain` at block_k = BLOCK_K. CUDA tensors:
    the CUDA kernel, which takes hd = 64, G <= 65535 and N < 2^31; inputs
    that are not contiguous or not 16-byte aligned are copied first."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, compute_dtype=compute_dtype, block_k=BLOCK_K)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    global launches
    bf16 = _is_bf16(compute_dtype)
    G, N, hd = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, (G, N, HEAD_DIM))
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the CUDA attention kernel is forward-only: run it under torch.no_grad()")
    out, _ = _launch(q, k, v, scale, bf16)
    launches += 1
    return out
