"""upnerf_torch.ops.attention and the port's ViT attention against the JAX
package on the CPU.

The JAX side runs the Pallas flash kernel in interpret mode, as
tests/test_pallas_attention.py does. Inputs come from numpy seeds.

Tolerances (absolute, on outputs that are weighted means of unit-normal v):
- float32: 1e-5. The plain version and the Pallas kernel run the same
  online softmax over the same key tiles in float32; only the order of the
  sums differs.
- bfloat16: 1e-3. Both round q * scale, k, v and each tile's p to bf16 at
  the same places; where a float32 sum rounds to the other side of a bf16
  boundary, a p or a q moves by one bf16 ulp (2^-8 relative).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.features import vit as jvit
from upnerf.ops import pallas_attention
from upnerf_torch.features import vit
from upnerf_torch.ops import _build, attention

TOL = {"float32": 1e-5, "bfloat16": 1e-3}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def interpret_mode():
    torch.set_num_threads(1)
    pallas_attention.INTERPRET = True
    yield
    pallas_attention.INTERPRET = False


def make_qkv(G, N, hd=64, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(G, N, hd).astype(np.float32) for _ in range(3))


# (G, N, block_q, block_k, logit scale): a ragged N (key and query tiles
# padded), an exact fit of several key tiles, and logits x 20 (the online
# max subtraction must not overflow); then the CUDA kernel's own tiles
# (BLOCK_Q query rows, BLOCK_K keys) at an N that is a multiple of neither.
CASES = {
    "ragged_300": (3, 300, 128, 128, 1.0),
    "tiles_256": (2, 256, 64, 64, 1.0),
    "logits_x20": (1, 160, 64, 64, 20.0),
    "kernel_tiles_331": (2, 331, attention.BLOCK_Q, attention.BLOCK_K, 1.0),
    "kernel_tiles_x20": (1, 200, attention.BLOCK_Q, attention.BLOCK_K, 20.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas(case, dtype):
    G, N, bq, bk, mult = CASES[case]
    q, k, v = make_qkv(G, N, seed=len(case))
    q = q * mult
    scale = 0.125
    want = np.asarray(pallas_attention.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, block_q=bq, block_k=bk,
        compute_dtype=JDT[dtype],
    ))
    got = attention.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=scale, compute_dtype=dtype, block_k=bk,
    ).numpy()
    assert got.shape == want.shape == (G, N, 64) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])


def test_plain_f32_matches_dense():
    """The online softmax in float32 is softmax(q k^T * scale) v (1e-5)."""
    q, k, v = (torch.from_numpy(a) for a in make_qkv(2, 300, seed=5))
    want = torch.softmax(q @ k.transpose(1, 2) * 0.125, -1) @ v
    got = attention.flash_attention_plain(q, k, v, scale=0.125, compute_dtype=torch.float32, block_k=64)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_bf16_result_depends_on_key_tile():
    """In bf16 mode each p is rounded relative to its tile's running max, so
    the tile size changes the last bits; both stay near dense f32 (2e-2, the
    JAX package's own bf16 bound)."""
    q, k, v = (torch.from_numpy(a) for a in make_qkv(1, 512, seed=9))
    dense = torch.softmax(q @ k.transpose(1, 2) * 0.125, -1) @ v
    a = attention.flash_attention_plain(q, k, v, scale=0.125, block_k=64)
    b = attention.flash_attention_plain(q, k, v, scale=0.125, block_k=512)
    assert not torch.equal(a, b)
    for x in (a, b):
        torch.testing.assert_close(x, dense, rtol=0, atol=2e-2)


def test_wrapper_on_cpu_is_the_plain_version_at_the_kernel_tile():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(2, 200, seed=3))
    before = attention.launches
    for dtype in (torch.bfloat16, torch.float32):
        got = attention.flash_attention(q, k, v, scale=0.125, compute_dtype=dtype)
        want = attention.flash_attention_plain(q, k, v, scale=0.125, compute_dtype=dtype,
                                               block_k=attention.BLOCK_K)
        assert torch.equal(got, want)
    assert attention.launches == before  # the CPU path launches no kernel
    with pytest.raises(ValueError):
        attention.flash_attention(q, k, v, scale=0.125, compute_dtype=torch.float16)


def _cuda_source():
    return (Path(attention.__file__).resolve().parent.parent / "csrc" / "flash_attn_fwd.cu").read_text()


def test_tiles_are_the_cuda_kernels():
    """BLOCK_K and BLOCK_Q name the bf16 kernel's key tile and query rows a
    block (csrc/flash_attn_fwd.cu), and the C entry point takes as many
    arguments as the ctypes binding passes."""
    src = _cuda_source()
    consumers = int(re.search(r"constexpr int CONSUMERS = (\d+);", src).group(1))
    assert attention.BLOCK_K == int(re.search(r"constexpr int WS_BN = (\d+);", src).group(1)) == 128
    assert attention.BLOCK_Q == 64 * consumers
    sig = re.search(r"int upnerf_flash_attn_fwd\(([^)]*)\)", src).group(1)
    assert len(sig.split(",")) == len(_build._ARGTYPES["upnerf_flash_attn_fwd"]) == 13


def test_wrapper_on_cpu_runs_the_new_key_tile():
    """On the CPU the wrapper is the plain version at block_k = 128, which in
    bf16 differs from the old 64-key tile in the last bits (p is rounded per
    tile) and stays near dense f32 (2e-2, as above)."""
    q, k, v = (torch.from_numpy(a) for a in make_qkv(2, 300, seed=4))
    got = attention.flash_attention(q, k, v, scale=0.125)
    assert torch.equal(got, attention.flash_attention_plain(q, k, v, scale=0.125, block_k=128))
    assert not torch.equal(got, attention.flash_attention_plain(q, k, v, scale=0.125, block_k=64))
    dense = torch.softmax(q @ k.transpose(1, 2) * 0.125, -1) @ v
    torch.testing.assert_close(got, dense, rtol=0, atol=2e-2)


def test_inputs_are_copied_when_strided_or_unaligned():
    """The CUDA path reads 16 bytes a thread: a contiguous, 16-byte aligned
    input goes through as it is; a strided or unaligned one is copied."""
    x = torch.randn(2, 10, 64)
    assert attention._dense_aligned(x) is x
    wide = torch.randn(2, 10, 128)[..., :64]
    off = torch.randn(2 * 10 * 64 + 1)[1:].view(2, 10, 64)
    for t in (wide, off):
        y = attention._dense_aligned(t)
        assert y.is_contiguous() and y.data_ptr() % 16 == 0 and torch.equal(y, t)


def _attn_params(D, seed):
    rng = np.random.RandomState(seed)
    return {
        "qkv": {"w": rng.randn(D, 3 * D).astype(np.float32) * 0.2, "b": rng.randn(3 * D).astype(np.float32) * 0.1},
        "proj": {"w": rng.randn(D, D).astype(np.float32) * 0.2, "b": rng.randn(D).astype(np.float32) * 0.1},
    }


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("impl", ["dense", "chunked", "flash"])
def test_vit_attention_matches_jax(impl, monkeypatch):
    """vit.attention (output and key facet) against the JAX one, per impl.
    Chunked runs at a chunk of 16 over 50 tokens (ragged last chunk); flash
    runs the plain version on the CPU at the JAX call's key tile (one tile
    of round_up(50, 8) = 56 keys), in bf16 as the JAX call does.
    Tolerances: dense / chunked 1e-5, flash 2e-3 (bf16 products, one ulp
    flips on outputs of magnitude ~1)."""
    B, N, D, H = 1, 50, 96, 6
    rng = np.random.RandomState(1)
    x = rng.randn(B, N, D).astype(np.float32)
    p = _attn_params(D, 2)
    monkeypatch.setattr(jvit, "ATTN_Q_CHUNK", 16)
    monkeypatch.setattr(vit, "ATTN_Q_CHUNK", 16)
    monkeypatch.setattr(attention, "BLOCK_K", 56)
    want, want_keys = jvit.attention(jnp.asarray(x), jax.tree.map(jnp.asarray, p), H, return_keys=True, impl=impl)
    got, got_keys = vit.attention(torch.from_numpy(x), _to_torch(p), H, return_keys=True, impl=impl)
    tol = 2e-3 if impl == "flash" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)
    np.testing.assert_allclose(got_keys.numpy(), np.asarray(want_keys), rtol=0, atol=1e-5)


def test_auto_resolution():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert vit._resolve_attn_impl("auto", 577, cuda) == "dense"  # DPT-L at 384
    assert vit._resolve_attn_impl("auto", vit.ATTN_CHUNK_THRESHOLD, cuda) == "dense"
    assert vit._resolve_attn_impl("auto", 12322, cuda) == "flash"  # DINO at stride 4
    assert vit._resolve_attn_impl("auto", 12322, cpu) == "chunked"
    assert vit._resolve_attn_impl("flash", 100, cpu) == "flash"
    assert vit.ATTN_CHUNK_THRESHOLD == jvit.ATTN_CHUNK_THRESHOLD and vit.ATTN_Q_CHUNK == jvit.ATTN_Q_CHUNK
    with pytest.raises(ValueError):
        vit._resolve_attn_impl("sdpa", 100, cpu)
