"""The CUDA flash-attention kernel against its plain PyTorch version, on the
card, at the DINO extractor's head width (hd = 64): G = 6 heads at every
ragged edge of the kernel's tiles (N = 1 .. 12,322; 192 query rows and 128
keys a tile in bfloat16 mode), G = 1 and 12, logits x 20, the bf16 pre-pass
bit for bit, and inputs that are not contiguous or not 16-byte aligned.
Every test here needs an NVIDIA card: it carries the `cuda` marker and
skips without one.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest tests/test_torch_attention_cuda.py -q --noconftest -p no:cacheprovider

The plain version runs at the kernel's key tile (BLOCK_K), so both round at
the same places. Tolerances (absolute, unit-normal q, k, v; as in
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
# every edge of a 128-key tile and of the 64-row warpgroup / 192-row block
EDGES = [1, 63, 64, 127, 128, 129, 191, 193, 300, 1024, 12322]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def make_qkv(N, device, seed=0, groups=G):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(groups, N, HD, generator=g, device=device) for _ in range(3))


def check_against_plain(q, k, v, dtype, tol):
    before = attention.launches
    with torch.no_grad():
        got = attention.flash_attention(q, k, v, scale=0.125, compute_dtype=dtype)
        want = attention.flash_attention_plain(q, k, v, scale=0.125, compute_dtype=dtype, block_k=attention.BLOCK_K)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", EDGES)
def test_kernel_matches_plain(cuda_device, dtype, N):
    q, k, v = make_qkv(N, cuda_device, seed=N)
    check_against_plain(q, k, v, dtype, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups,N", [(1, 300), (1, 12322), (12, 193), (12, 12322)])
def test_kernel_matches_plain_per_group_count(cuda_device, dtype, groups, N):
    """G = 1 and 12: each group reads its own rows (the tensor maps are 3-D,
    so a tile past N loads zeros, not the next group's rows)."""
    q, k, v = make_qkv(N, cuda_device, seed=groups + N, groups=groups)
    check_against_plain(q, k, v, dtype, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [300, 1024, 12322])
def test_kernel_large_logits(cuda_device, dtype, N):
    """Logits x 20: the online max subtraction keeps every exp finite."""
    q, k, v = make_qkv(N, cuda_device, seed=11)
    check_against_plain(20.0 * q, k, v, dtype, PEAKED_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 193, 12322])
def test_prepass_rounds_as_the_plain_version(cuda_device, N):
    """The bf16 scratch the pre-pass writes is `_bf16(q * scale)`, `_bf16(k)`
    and `_bf16(v)` bit for bit."""
    q, k, v = make_qkv(N, cuda_device, seed=3)
    with torch.no_grad():
        out, (qb, kb, vb) = attention._launch(q, k, v, 0.125, True)
    torch.cuda.synchronize()
    assert qb.dtype == kb.dtype == vb.dtype == torch.bfloat16
    assert torch.equal(qb.float(), attention._bf16(q * 0.125))
    assert torch.equal(kb.float(), attention._bf16(k))
    assert torch.equal(vb.float(), attention._bf16(v))
    assert attention._launch(q, k, v, 0.125, False)[1] is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unaligned_and_strided_inputs_are_copied(cuda_device, dtype):
    """q as a strided slice of a wider tensor and k, v 4 bytes past a 16-byte
    boundary: the wrapper copies them to fresh contiguous tensors (it
    documents so), and the result is the plain version's."""
    N = 300
    q, k, v = make_qkv(N, cuda_device, seed=7)
    wide = torch.zeros(G, N, 2 * HD, device=cuda_device)
    wide[..., :HD] = q
    q_strided = wide[..., :HD]
    assert not q_strided.is_contiguous()
    flat = torch.zeros(2, G * N * HD + 1, device=cuda_device)
    k_off = flat[0, 1:].view(G, N, HD)
    v_off = flat[1, 1:].view(G, N, HD)
    k_off.copy_(k)
    v_off.copy_(v)
    assert k_off.data_ptr() % 16 == 4 and k_off.is_contiguous()
    check_against_plain(q_strided, k_off, v_off, dtype, TOL[dtype])


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q, k, v = make_qkv(100, cuda_device)
    with pytest.raises(ValueError, match="shape"):
        attention.flash_attention(q[..., :32], k[..., :32], v[..., :32], scale=0.125)
    with pytest.raises(ValueError, match="dtype"):
        attention.flash_attention(q.half(), k, v, scale=0.125)
    with pytest.raises(RuntimeError, match="forward-only"):
        attention.flash_attention(q.requires_grad_(), k, v, scale=0.125)
