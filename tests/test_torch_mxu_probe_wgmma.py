"""The Hopper design of the matrix-unit probe (csrc/mxu_probe.cu:wg_probe_kernel)
as far as the CPU reaches it:

- its weight stream, upnerf_torch.ops.mxu_probe.pack_stream: per layer and half
  of 128 columns, each K-strip unpacking to its block of the weight (bf16, the
  layout of render_train.pack_wgmma), or to the weight's rows in PI order
  (int8), in the order the consumers read them;
- PI against the two fragment layouts it reconciles: the s32 accumulators'
  and the s8 A operand's;
- a plain emulation of the consumers (each thread's accumulators, the packing
  of its own values into the next layer's A fragments, the operand the
  product reads back from those registers, the strips in stream order, the
  tiles of every copy two by two with the last consumer idle or ragged): the
  int8 chain equal to `mxu_probe_plain` and to a copy of the JAX `kern_int8`
  body bit for bit, the bf16 chains within tests/test_torch_mxu_probe.py's
  tolerances of both;
- the mma.sync design as a timing variant that no route reaches.
W = 256, L = 4, a few rows, one thread.
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mxu_probe import RMS_TOL, jax_chain
from test_torch_walk_wgmma import unpack_strip
from upnerf_torch.ops import _build
from upnerf_torch.ops import mxu_probe as mp
from upnerf_torch.ops import render_train as rt
from upnerf_torch.scripts import bench_mxu_probe as bench

W, L = 256, 4  # jax_chain runs test_torch_mxu_probe.L = 4 layers
ROWS = 64  # a consumer's tile


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unpack_strip_s8(flat: torch.Tensor, off: int, nbytes: int = mp.STRIP_BYTES) -> torch.Tensor:
    """An int8 K-strip of pack_stream -> its (128, nb) block of the (row-permuted) weight."""
    nb = nbytes // 128
    t = flat[off : off + nbytes].reshape(nb, 8, 16)  # (n, chunk position, e)
    n = torch.arange(nb)[:, None]
    pos = torch.arange(8)[None, :] ^ (n % 8)  # chunk c sits at position c ^ (n % 8)
    out = torch.empty_like(t)
    out[n, torch.arange(8)[None, :]] = t[n, pos]
    return out.reshape(nb, 128).t()


def pi_rows(K: int) -> torch.Tensor:
    """The weight row that each packed int8 row holds: 32 b + PI[k] for row 32 b + k."""
    return (torch.arange(K).reshape(-1, 32)[:, list(mp.PI)]).reshape(-1)


def strips(flat: torch.Tensor, s8: bool):
    """The stream's strips in order, unpacked: (layer, half, strip, block)."""
    per_half = 2 if s8 else 4
    n = flat.numel() * flat.element_size() // mp.STRIP_BYTES
    for j in range(n):
        off = j * mp.STRIP_BYTES
        block = unpack_strip_s8(flat, off) if s8 else unpack_strip(flat, off, mp.STRIP_BYTES)
        yield j // (2 * per_half), (j // per_half) % 2, j % per_half, block


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_stream_strips_unpack_to_the_weights_blocks(dtype):
    """Every 16 KB strip of the stream is the next block that the consumers
    multiply by: layer by layer, half by half, K-strip by K-strip; bf16
    strips are 64 rows of the weight (render_train.pack_wgmma's bytes), int8
    strips 128 rows taken in PI order."""
    g = torch.Generator().manual_seed(0)
    ws = torch.randint(-127, 128, (2, W, W), generator=g).to(dtype)
    flat = mp.pack_stream(ws)
    s8 = dtype == torch.int8
    kr = 128 if s8 else 64
    assert flat.dtype == dtype and flat.numel() * flat.element_size() == 2 * (4 if s8 else 8) * mp.STRIP_BYTES
    seen = 0
    for layer, half, ks, block in strips(flat, s8):
        w = ws[layer][pi_rows(W)] if s8 else ws[layer]
        assert torch.equal(block, w[kr * ks : kr * ks + kr, 128 * half : 128 * half + 128]), (layer, half, ks)
        seen += 1
    assert seen == 2 * 2 * (W // kr)
    if not s8:
        assert torch.equal(flat, torch.cat([rt.pack_wgmma(w, 128) for w in ws]))


# The fragment layouts of a consumer warpgroup (thread T = 32 w + l), as the PTX ISA
# gives them for wgmma m64nNk16 (bf16) and m64nNk32 (s8), and the kernel's packing.


def acc_place(T, i):
    """Accumulator d[i] of thread T (m64n128, f32 or s32): (row, column)."""
    j, e = i // 4, i % 4
    return 16 * (T // 32) + (T % 32) // 4 + 8 * (e // 2), 8 * j + 2 * (T % 4) + e % 2


def operand_place(T, r, i, s8: bool):
    """Element i of A register r of thread T: (row, k within the k-step)."""
    row = 16 * (T // 32) + (T % 32) // 4 + 8 * (r % 2)
    return row, (16 * (r // 2) + 4 * (T % 4) + i) if s8 else (8 * (r // 2) + 2 * (T % 4) + i)


def packed_index(kk, r, i, s8: bool):
    """The accumulator of a half (0..63) that the kernel packs into element i of
    register r of the half's k-step kk: wg_stream.cuh:pack_half (bf16 pairs),
    mxu_probe.cu:pack_s8_half (bytes)."""
    if s8:
        return 16 * kk + 8 * (r // 2) + 2 * (r % 2) + 4 * (i // 2) + i % 2
    return 8 * kk + 4 * (r // 2) + 2 * (r % 2) + i


def test_pi_reconciles_the_accumulator_and_operand_layouts():
    """Byte i of register r of an s8 A fragment is, for the product, column
    16 (r // 2) + 4 t + i of its k-step; the kernel puts there the accumulator
    of column 16 (r // 2) + PI[4 t + i], of the same row: the permutation the
    stream applies to the weight's rows. Both layouts give the same row, and
    PI is a permutation within each 16."""
    assert sorted(mp.PI) == list(range(32))
    assert all(p // 16 == k // 16 for k, p in enumerate(mp.PI))
    T = torch.arange(128)
    for kk in range(4):
        for r in range(4):
            for i in range(4):
                idx = packed_index(kk, r, i, True)
                arow, acol = acc_place(T, torch.tensor(idx))
                orow, ok = operand_place(T, r, i, True)
                assert torch.equal(arow, orow)
                assert torch.equal(acol - 32 * kk, torch.tensor(mp.PI)[ok])
    # bf16 needs no permutation: the packed pair is the operand's pair
    for kk in range(8):
        for r in range(4):
            for i in range(2):
                arow, acol = acc_place(T, torch.tensor(packed_index(kk, r, i, False)))
                orow, ok = operand_place(T, r, i, False)
                assert torch.equal(arow, orow) and torch.equal(acol - 16 * kk, ok)


def quant(v):
    """q of f32 values, as exact f64 operands."""
    return torch.clamp(v.float() * 127.0, -127, 127).to(torch.int8).to(torch.float64)


def emulate(x, ws, b, chain, copies):
    """The consumers of wg_probe_kernel in plain PyTorch, f32 (bf16 chains) or
    exact (int8). Returns each copy's output, (copies, M, W)."""
    s8 = chain == "int8"
    M = x.shape[0]
    flat = mp.kernel_weights(ws, chain)
    order = list(strips(flat, s8))
    kstep = 32 if s8 else 16
    n_ks = W // kstep
    T = torch.arange(128)[:, None]
    arow, acol = acc_place(T, torch.arange(64)[None, :])  # (128, 64)
    # the operand element each fragment slot feeds: (T, k-step, register, element)
    n_el = 4 if s8 else 2
    r_ = torch.arange(4)[None, None, :, None]
    i_ = torch.arange(n_el)[None, None, None, :]
    ks_ = torch.arange(n_ks)[None, :, None, None]
    T4 = torch.arange(128)[:, None, None, None]
    orow, ok = operand_place(T4, r_, i_, s8)
    ocol = kstep * ks_ + ok
    src = packed_index(ks_ % (n_ks // 2), r_, i_, s8) + 64 * (ks_ // (n_ks // 2))  # index into [half 0 | half 1]
    dt = torch.float64 if s8 else torch.float32

    def pack(v):
        """v (128, 128): each thread's two halves' values -> fragments (128, n_ks, 4, n_el)."""
        if s8:
            v = quant(v)
        else:
            v = v.to(torch.bfloat16).to(torch.float32)
        return v.gather(1, src.expand(128, n_ks, 4, n_el).reshape(128, -1)).reshape(128, n_ks, 4, n_el)

    def operand(frags):
        """The (64, W) A matrix the product reads from the fragments."""
        a = torch.zeros(ROWS, W, dtype=dt)
        a[orow.expand_as(frags), ocol.expand_as(frags)] = frags
        return a

    tiles = -(-M // ROWS)
    n_tiles = tiles * copies
    out = torch.full((copies, M, W), float("nan"))
    for item in range(-(-n_tiles // 2)):
        for c in range(2):
            tile = 2 * item + c
            if tile >= n_tiles:
                continue  # the kernel runs this consumer on zeros and stores nothing
            copy, row0 = divmod(tile, tiles)
            row0 *= ROWS
            xt = torch.zeros(ROWS, W)
            n = min(ROWS, M - row0)
            xt[:n] = x[row0 : row0 + n]
            v = torch.cat([xt[arow, acol], xt[arow, acol + 128]], 1)  # each thread's halves, accumulator layout
            frags = pack(v)
            q = iter(order)
            for layer in range(L):
                a = operand(frags)
                halves = []
                for half in range(2):
                    acc = torch.zeros(ROWS, 128, dtype=dt)
                    for s in range(W // (128 if s8 else 64)):
                        lay, hf, ks, block = next(q)
                        assert (lay, hf, ks) == (layer, half, s)
                        kr = block.shape[0]
                        acc = acc + a[:, kr * ks : kr * ks + kr] @ block.to(dt)
                    if s8:
                        acc = torch.relu(acc.float() * mp.SCALE)  # f32, as the kernel's epilogue
                    elif chain == "epi":
                        acc = torch.relu(acc + b[128 * half : 128 * half + 128])
                    halves.append(acc[arow, acol])
                v = torch.cat(halves, 1)
                if layer < L - 1:
                    frags = pack(v)
            if s8:
                v = quant(v).float()
            elif chain == "pure":
                v = v.to(torch.bfloat16).float()
            res = torch.zeros(ROWS, W)
            res[arow, acol] = v[:, :64].float()
            res[arow, acol + 128] = v[:, 64:].float()
            out[copy, row0 : row0 + n] = res[:n]
    return out


def rms(t):
    return float(torch.as_tensor(t).double().pow(2).mean().sqrt())


@pytest.mark.parametrize("M, copies", [(100, 2), (1, 1), (64, 3)], ids=["M100x2", "M1", "M64x3"])
def test_emulated_int8_chain_equals_plain_and_jax_bit_for_bit(M, copies):
    """The consumers' int8 arithmetic with PI: exact s32 sums, the f32
    requantisation, bytes packed in accumulator order, at ragged tiles (100
    rows: 36 in the second), one row, and an odd number of tiles (the last
    item's second consumer idle); every copy writes the same rows."""
    x, _, _, ws_i8 = mp.probe_inputs(M, W, L, seed=M)
    got = emulate(torch.from_numpy(x), torch.from_numpy(ws_i8), None, "int8", copies)
    assert not got.isnan().any()
    plain = mp.mxu_probe_plain(torch.from_numpy(x), torch.from_numpy(ws_i8), None, "int8", copies)
    want = np.asarray(jax_chain("int8", jnp.asarray(x), jnp.asarray(ws_i8), None))
    for c in range(copies):
        assert torch.equal(got[c], plain)
        np.testing.assert_array_equal(got[c].numpy(), want)
    assert (plain != 0).float().mean() > 0.2 and plain.abs().max() > 64  # the chain does not collapse


def test_emulated_int8_chain_needs_pi():
    """Without the row permutation the same arithmetic gives another chain:
    the test above sees PI."""
    x, _, _, ws_i8 = mp.probe_inputs(64, W, L, seed=5)
    xt, wt = torch.from_numpy(x), torch.from_numpy(ws_i8)
    inverse = torch.argsort(pi_rows(W))
    got = emulate(xt, wt[:, inverse], None, "int8", 1)[0]  # the stream then holds the weight unpermuted
    assert not torch.equal(got, mp.mxu_probe_plain(xt, wt, None, "int8"))


@pytest.mark.parametrize("chain", ["pure", "epi"])
def test_emulated_bf16_chains_match_plain_and_jax(chain):
    """The bf16 chains in the consumers' order (bf16 operands from the packed
    accumulators, f32 sums strip by strip) against the plain chain and the JAX
    body by RMS (RMS_TOL), and at least 10x further from the f32 chain, in
    which no operand is rounded."""
    x, ws, b, _ = mp.probe_inputs(100, W, L, seed=7)
    X, Ws, B = (torch.from_numpy(a) for a in (x, ws, b))
    got = emulate(X, Ws, B, chain, 2)
    assert torch.isfinite(got).all() and torch.equal(got[0], got[1])
    got = got[0]
    plain = mp.mxu_probe_plain(X, Ws, B, chain)
    want = np.array(jax_chain(chain, jnp.asarray(x), jnp.asarray(ws), jnp.asarray(b)))
    d_plain, d_jax = rms(got - plain) / rms(plain), rms(got.numpy() - want) / rms(want)
    assert d_plain <= RMS_TOL and d_jax <= RMS_TOL, (d_plain, d_jax)
    h = X
    for w in Ws:
        h = h @ w if chain == "pure" else torch.relu(h @ w + B)
    assert rms(h - got) / rms(h) >= 10 * max(d_plain, 1e-6)


def test_the_kernel_streams_what_pack_stream_packs():
    """The kernel's strip count and size against the stream: L x 8 bf16 or
    L x 4 int8 strips of wg_stream.cuh's stage size, which is STRIP_BYTES."""
    src = (Path(_build.CSRC_DIR) / "mxu_probe.cu").read_text()
    assert "p.n_chunks = L * (CHAIN == INT8 ? 4 : 8);" in src
    stage = re.search(r"constexpr int STREAM_STAGE_BYTES = (\d+);", (Path(_build.CSRC_DIR) / "wg_stream.cuh").read_text())
    assert int(stage.group(1)) == mp.STRIP_BYTES
    for dtype, per_layer in ((torch.bfloat16, 8), (torch.int8, 4)):
        flat = mp.pack_stream(torch.zeros(3, W, W, dtype=dtype))
        assert flat.numel() * flat.element_size() == 3 * per_layer * mp.STRIP_BYTES


def test_the_mma_sync_probe_is_a_timing_variant():
    """The design the Hopper probe replaced is built beside it from the same
    source with one macro; the route (mxu_probe) and the benchmark script
    take the Hopper design, and the variant's name is the one chip_smoke.py
    and the card tests select."""
    assert _build.VARIANTS["mxu_probe_mma_sync"] == ("mxu_probe", ("-DUPNERF_PROBE_MMA_SYNC",))
    assert [k for k, (src, _) in _build.VARIANTS.items() if src == "mxu_probe"] == ["mxu_probe_mma_sync"]
    assert mp.PROBE_DESIGNS == ("wgmma", "mma_sync")
    assert mp.PROBE_LIBS == {"wgmma": "mxu_probe", "mma_sync": "mxu_probe_mma_sync"}
    assert inspect.signature(mp.mxu_probe_launch).parameters["design"].default == "wgmma"
    assert inspect.signature(mp.kernel_weights).parameters["design"].default == "wgmma"
    route = inspect.getsource(mp.mxu_probe)
    assert "mxu_probe_launch(" in route and "design" not in route and "mma_sync" not in route
    script = inspect.getsource(bench.main)
    assert "mp.kernel_weights(w, chain)" in script and "pack_weights" not in script
    x, ws = torch.zeros(4, W), torch.zeros(1, W, W)
    with pytest.raises(ValueError, match="design must be one of"):
        mp.mxu_probe_launch(x, ws, None, "pure", design="other")
    with pytest.raises(ValueError, match="design must be one of"):
        mp.kernel_weights(ws, "pure", "other")
    # the variant's packing is the fragment order the old tests hold
    assert torch.equal(mp.kernel_weights(ws, "pure", "mma_sync"), mp.pack_weights(ws.bfloat16()))


def test_int8_epilogue_bit_patterns():
    """mxu_probe.cu:s32_to_f32 and q_bits take the int8 epilogue off the
    conversion unit with the same bits: every s32 sum the chain can reach at
    W = 256 (|acc| <= 256 x 127^2 < 2^22) plus 0x4B400000 is the f32 pattern
    of 1.5 x 2^23 + acc, which less 1.5 x 2^23 is float(acc); 2^23 + n (n =
    trunc(min(v 127, 127)) in 0..127, the sum rounded down) holds n in its low
    byte and less 2^23 is float(n)."""
    src = (Path(_build.CSRC_DIR) / "mxu_probe.cu").read_text()
    assert "__int_as_float(acc + 0x4B400000), 12582912.f)" in src and "__fadd_rd(" in src and "8388608.f" in src
    lim = W * 127 * 127
    assert lim < 2**22
    acc = np.arange(-lim, lim + 1, dtype=np.int64)
    f = (acc + 0x4B400000).astype(np.int32).view(np.float32) - np.float32(12582912.0)
    np.testing.assert_array_equal(f, acc.astype(np.float32))
    n = np.arange(128, dtype=np.float32)
    bits = (n + np.float32(8388608.0)).view(np.uint32)
    np.testing.assert_array_equal(bits & 0xFF, n.astype(np.uint32))
    np.testing.assert_array_equal(bits.view(np.float32) - np.float32(8388608.0), n)
    # q (truncation of min(v 127, 127) for v >= 0) is the floor the rounded-down sum keeps
    v = np.random.RandomState(0).uniform(0, 1.5, 100000).astype(np.float32)
    y = np.minimum(v * np.float32(127.0), np.float32(127.0))
    np.testing.assert_array_equal(np.floor(y), mp._quant(torch.from_numpy(v)).numpy())
