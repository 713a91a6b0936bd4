"""The CUDA flash-attention kernel against its plain PyTorch version, on the
card, at the DINO extractor's shape (G = 6 heads, hd = 64) and N = 300
(ragged tiles), 1,024 and 12,322 tokens. Every test here needs an NVIDIA
card: it carries the `cuda` marker and skips without one.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest tests/test_torch_attention_cuda.py -q --noconftest -p no:cacheprovider

The plain version runs at the kernel's key tile (64), so both round at the
same places. Tolerances (absolute, unit-normal q, k, v; as in
chip_smoke.py): float32 1e-5 (f32 sums in another order); bfloat16 1e-3
(an f32 score or sum on the other side of a bf16 rounding boundary moves a
p by one bf16 ulp, 2^-8 relative); bfloat16 with logits x 20 1e-2 (the
softmax is peaked, so such a flip lands on a weight near 1).
"""

import pytest
import torch

from upnerf_torch.ops import attention

TOL = {"float32": 1e-5, "bfloat16": 1e-3}
PEAKED_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
G, HD = 6, 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def make_qkv(N, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(G, N, HD, generator=g, device=device) for _ in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [300, 1024, 12322])
def test_kernel_matches_plain(cuda_device, dtype, N):
    q, k, v = make_qkv(N, cuda_device, seed=N)
    before = attention.launches
    with torch.no_grad():
        got = attention.flash_attention(q, k, v, scale=0.125, compute_dtype=dtype)
        want = attention.flash_attention_plain(q, k, v, scale=0.125, compute_dtype=dtype, block_k=attention.BLOCK_K)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert got.shape == (G, N, HD) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_large_logits(cuda_device, dtype):
    """Logits x 20: the online max subtraction keeps every exp finite."""
    q, k, v = make_qkv(1024, cuda_device, seed=11)
    with torch.no_grad():
        got = attention.flash_attention(20.0 * q, k, v, scale=0.125, compute_dtype=dtype)
        want = attention.flash_attention_plain(20.0 * q, k, v, scale=0.125, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=PEAKED_TOL[dtype])


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q, k, v = make_qkv(100, cuda_device)
    with pytest.raises(ValueError, match="shape"):
        attention.flash_attention(q[..., :32], k[..., :32], v[..., :32], scale=0.125)
    with pytest.raises(ValueError, match="dtype"):
        attention.flash_attention(q.half(), k, v, scale=0.125)
    with pytest.raises(RuntimeError, match="forward-only"):
        attention.flash_attention(q.requires_grad_(), k, v, scale=0.125)
