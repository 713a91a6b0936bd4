"""The matrix-unit probe (upnerf_torch.ops.mxu_probe) against the JAX probe's
kernel bodies.

The bodies are closures inside scripts/bench_mxu_probe.py:main and cannot be
imported, so `jax_chain` below copies them (kern_pure :48-56, kern_epi
:58-66, kern_int8 :98-110) as functions of arrays, with nothing changed but
the refs. At M=64, W=32, L=4 on the script's seeded inputs:
- the int8 chain equals the JAX body's bit for bit (int8 values, exact int32
  sums, the same f32 requantisation);
- the bf16 chains by RMS: RMS(plain - JAX) / RMS(JAX) <= 1e-3. Both round the
  same operands to bf16 and sum exactly in f32 products, but in another
  order, so an f32 sum can land on the other side of a bf16 rounding
  boundary and move one value by one bf16 ulp (2^-8 relative), which the
  next layers carry; a chain that skipped a rounding would be ~2^-9 away in
  every value (checked against the f32 chain: the bf16 chain is at least
  10x further from it than from the JAX body).
Also the kernel's weight packing (fragment order) and the script on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf_torch.ops import mxu_probe as mp
from upnerf_torch.ops import render_train as rt
from upnerf_torch.scripts import bench_mxu_probe as bench

M, W, L = 64, 32, 4
RMS_TOL = 1e-3


def jax_chain(chain, x, ws, b):
    """The JAX probe's kernel bodies on whole arrays (x_ref[:] -> x, w_ref[i] -> ws[i], b_ref[:] -> b)."""
    if chain == "pure":  # kern_pure, scripts/bench_mxu_probe.py:48-56
        h = x.astype(jnp.bfloat16)
        for i in range(L):
            h = jnp.dot(h, ws[i].astype(jnp.bfloat16), preferred_element_type=jnp.float32).astype(jnp.bfloat16)
        return h.astype(jnp.float32)
    if chain == "epi":  # kern_epi, :58-66
        h = x
        for i in range(L):
            acc = jnp.dot(h.astype(jnp.bfloat16), ws[i].astype(jnp.bfloat16), preferred_element_type=jnp.float32)
            h = jnp.maximum(acc + b, 0.0)
        return h
    h = jnp.clip(x * 127.0, -127, 127).astype(jnp.int8)  # kern_int8, :98-110
    for i in range(L):
        acc = jnp.dot(h, ws[i], preferred_element_type=jnp.int32)
        f = jnp.maximum(acc.astype(jnp.float32) * (1.0 / (127 * 127)), 0.0)
        h = jnp.clip(f * 127.0, -127, 127).astype(jnp.int8)
    return h.astype(jnp.float32)


@pytest.fixture(scope="module")
def inputs():
    return mp.probe_inputs(M, W, L, seed=0)


def rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def test_inputs_follow_the_jax_script(inputs):
    """The script's draws (:43-46) and int8 quantisation (:117-119), which
    passes the f32 array through jnp.asarray(..., jnp.int8)."""
    x, ws, b, ws_i8 = inputs
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(x, jnp.asarray(rng.randn(M, W).astype(np.float32) * 0.1))
    jws = jnp.asarray(rng.randn(L, W, W).astype(np.float32) * 0.05)
    np.testing.assert_array_equal(ws, jws)
    np.testing.assert_array_equal(b, jnp.asarray(rng.randn(W).astype(np.float32) * 0.01))
    want = jnp.asarray(np.clip(np.asarray(jws) * 127 / np.abs(jws).max(), -127, 127), jnp.int8)
    np.testing.assert_array_equal(ws_i8, np.asarray(want))


def test_int8_chain_matches_jax_bit_for_bit(inputs):
    x, _, b, ws_i8 = inputs
    got = mp.mxu_probe_plain(torch.from_numpy(x), torch.from_numpy(ws_i8), None, "int8")
    want = np.asarray(jax_chain("int8", jnp.asarray(x), jnp.asarray(ws_i8), None))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() > 1  # the chain does not collapse to zero at this size
    # copies repeat the same rows
    again = mp.mxu_probe(torch.from_numpy(x), torch.from_numpy(ws_i8), None, "int8", copies=3)
    assert torch.equal(again, got)


@pytest.mark.parametrize("chain", ["pure", "epi"])
def test_bf16_chains_match_jax_by_rms(inputs, chain):
    x, ws, b, _ = inputs
    T = torch.from_numpy
    got = mp.mxu_probe(T(x), T(ws), T(b), chain, copies=2).numpy()
    want = np.asarray(jax_chain(chain, jnp.asarray(x), jnp.asarray(ws), jnp.asarray(b)))
    assert got.shape == (M, W) and np.isfinite(got).all()
    d = rms(got - want) / rms(want)
    assert d <= RMS_TOL, d
    # the f32 chain (no rounding of the operands) is far from both: the bf16 roundings are there
    h = T(x)
    for w in T(ws):
        acc = h @ w
        h = acc if chain == "pure" else torch.relu(acc + T(b))
    d32 = rms(h.numpy() - want) / rms(want)
    assert d32 >= 10 * max(d, 1e-6), (d, d32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_weight_packing_is_the_fragment_order(dtype):
    """pack_weights: bf16 as the render kernels' _pack_fragments (m16n8k16);
    int8 in the m16n8k32 B-fragment order, element by element."""
    K = N = 64
    g = torch.Generator().manual_seed(0)
    ws = torch.randint(-127, 128, (2, K, N), generator=g).to(dtype)
    packed = mp.pack_weights(ws)
    if dtype == torch.bfloat16:
        for i in range(2):
            assert torch.equal(packed[i].flatten(), rt._pack_fragments(ws[i].float()).flatten())
        return
    flat = packed.reshape(2, N // 8, K // 32, 32, 8)  # (layer, n-tile, k-step, lane, 8 bytes)
    for lane in (0, 5, 31):
        gq, t = lane // 4, lane % 4
        for e in range(8):
            k = 32 * 1 + (16 if e >= 4 else 0) + 4 * t + e % 4
            assert flat[1, 3, 1, lane, e] == ws[1, k, 8 * 3 + gq]


def test_plain_chain_refuses_unknown_kinds(inputs):
    x, ws, b, _ = inputs
    with pytest.raises(ValueError, match="chain"):
        mp.mxu_probe_plain(torch.from_numpy(x), torch.from_numpy(ws), None, "fp8")
    with pytest.raises(ValueError, match="no probe kernel"):
        mp.mxu_probe(torch.from_numpy(x).to("meta"), torch.from_numpy(ws), None, "pure")


def test_bench_script_on_cpu():
    got = bench.main(["--device", "cpu", "--m", "64", "--w", "32", "--layers", "4", "--grid", "2", "--steps", "1"])
    assert got["device"] == "cpu, host clock"
    assert all(got[c]["plain_ms"] > 0 for c in mp.CHAINS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(["--steps", "1"])
