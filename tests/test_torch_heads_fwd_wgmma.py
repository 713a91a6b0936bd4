"""The Hopper forward of kernels 5 and 6 (csrc/heads_fwd.cu:wg_fwd_kernel) as far
as the CPU reaches it:

- its weight stream, upnerf_torch.ops.heads._fwd_wgmma_weights: every
  product's K-strips in the order the consumers read them (the trunk layer by
  layer and half by half, xyzf, feat, then c1, c2 and cfeat), each strip
  unpacking to its block of the weight, for F = 32 / 64 / 384, the candidate
  branch on and off, the trunk-only mode and trunks with skip layers; the
  narrow heads' 8 KB; within the kernel's strip table (wf::MAX_CHUNKS) at
  D = 16 with every layer a skip layer; and the strips that the backward's
  rebuild streams (heads_bwd.cu) the same bytes;
- a plain emulation of the consumers' order (products strip by strip from
  the packed stream, bf16 operands, f32 sums, each activation rounded once)
  against the plain versions (`fused_trunk_heads_plain`, `fused_trunk_plain`)
  and against `upnerf.ops.pallas_heads.fused_trunk_heads` /
  `upnerf.ops.pallas_mlp.fused_trunk` in the Pallas interpreter;
- the mma.sync forward as a timing variant that no route loads.
Kernel widths (W = 256, HC = 128, C = 16), few rows, one thread.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_walk_wgmma import unpack_strip
from upnerf.ops import pallas_heads as jph
from upnerf.ops import pallas_mlp
from upnerf_torch.ops import _build
from upnerf_torch.ops import heads as th
from upnerf_torch.ops import mlp
from upnerf_torch.ops.render_train import X0_PAD, feat_pad, softplus

KW, KHC, KC, L = 256, 128, 16, 10
IN0 = 3 + 6 * L
MODES = ("candidate", "heads", "trunk")
DEPTHS = {"D8": (8, (4,)), "D3skips": (3, (1, 2))}
# The emulation, the plain versions and the Pallas kernels sum each product in their
# own f32 order, so an activation near a bf16 rounding boundary can round one ulp
# apart (2^-8 of its value) and move what follows it: at these widths the plain
# version and the Pallas kernel differ by up to 1.1e-3 of an output's max, where at
# tests/test_torch_heads.py's W = 32 they agree to 1e-5. So all three are held to 5e-3
# of each output's max, the bf16 forward's tolerance on the card (chip_smoke.py:
# TRUNK_TOL, tests/test_torch_kernel_cuda.py), and the emulation to the bf16 plain
# version by RMS (test_emulation_rounds_as_the_kernel_does).
EMU_TOL = 5e-3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def world(D, skips, F, mode, n=64, seed=0):
    """Seeded numpy weights (torch-default init), x0 rows and c_emb (None but
    in the candidate mode), as torch tensors; heads None in the trunk-only mode."""
    rng = np.random.RandomState(seed)

    def lin(i, o):
        b = i**-0.5
        return (torch.from_numpy(rng.uniform(-b, b, (i, o)).astype(np.float32)),
                torch.from_numpy(rng.uniform(-b, b, o).astype(np.float32)))

    trunk = [lin(IN0 if i == 0 else (IN0 + KW if i in skips else KW), KW) for i in range(D)]
    heads = None
    if mode != "trunk":
        shapes = {"sigma": (KW, 1), "xyzf": (KW, KW), "feat": (KW, F)}
        if mode == "candidate":
            shapes.update(c1=(KW + KC, KHC), c2=(KHC, KHC), csig=(KHC, 1), cfeat=(KHC, F))
        heads = {}
        for k, (i, o) in shapes.items():
            heads[k + "_w"], heads[k + "_b"] = lin(i, o)
    x0 = torch.from_numpy(rng.randn(n, IN0).astype(np.float32))
    c_emb = torch.from_numpy(rng.randn(n, KC).astype(np.float32)) if mode == "candidate" else None
    return trunk, heads, x0, c_emb


def stream(trunk, heads, skips, mode):
    return th._fwd_wgmma_weights(trunk, heads, skips, IN0, KC if mode == "candidate" else 0)


def cols(m, n):
    return torch.cat([m, m.new_zeros(m.shape[0], n - m.shape[1])], 1)


def expected_strips(trunk, heads, skips, F):
    """Each K-strip's (64, nb) block of its weight, in the consumers' order, as
    the kernel's design states it."""
    FP = feat_pad(F, True)
    NB = min(FP, 128)
    out = []

    def add(m, nb):
        for b in range(m.shape[1] // nb):
            for ks in range(m.shape[0] // 64):
                out.append(m[64 * ks : 64 * ks + 64, nb * b : nb * b + nb])

    for i, (w, _) in enumerate(trunk):
        if i == 0 or i in skips:
            w = torch.cat([w[:IN0], w.new_zeros(X0_PAD - IN0, KW), w[IN0:]], 0)
        add(w, 128)
    if heads is not None:
        add(heads["xyzf_w"], 128)
        add(cols(heads["feat_w"], FP), NB)
    if heads is not None and "c1_w" in heads:
        c1 = heads["c1_w"]
        add(torch.cat([c1[KW:], c1.new_zeros(X0_PAD - KC, KHC), c1[:KW]]), 128)
        add(heads["c2_w"], 128)
        add(cols(heads["cfeat_w"], FP), NB)
    return out


def max_chunks() -> int:
    src = (Path(_build.CSRC_DIR) / "heads_fwd.cu").read_text()
    expr = re.search(r"constexpr int MAX_CHUNKS = ([^;]*);", src).group(1)
    return eval(expr.replace("MAX_D", "16"))  # noqa: S307 (the kernel's own constant expression)


@pytest.mark.parametrize("depth", DEPTHS.values(), ids=DEPTHS.keys())
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("F", [32, 64, 384])
def test_forward_weight_stream_covers_every_product_in_order(F, mode, depth):
    """Each K-strip of the schedule unpacks to the next block of the next
    product's weight (bf16-rounded), every product is covered, and the narrow
    heads' 8 KB hold sigma_w and csig_w zero-padded to 8 columns."""
    D, skips = depth
    trunk, heads, _, _ = world(D, skips, F, mode)
    flat, sched = stream(trunk, heads, skips, mode)
    assert flat.dtype == torch.bfloat16
    want = expected_strips(trunk, heads, skips, F)
    strips = sched[:-1] if heads is not None else sched
    assert len(strips) == len(want) <= max_chunks()
    for i, ((off, nbytes), w) in enumerate(zip(strips, want)):
        assert off % 1024 == 0 and nbytes == 128 * w.shape[1] <= 16384, i
        assert torch.equal(unpack_strip(flat, off, nbytes), w.bfloat16()), i
    if heads is not None:
        off, nbytes = sched[-1]
        assert (off % 1024, nbytes) == (0, th.WG_HEADS_BYTES)
        narrow = torch.cat([unpack_strip(flat, off + 1024 * ks, 1024) for ks in range(KW // 64)])
        assert torch.equal(narrow, cols(heads["sigma_w"], 8).bfloat16())
        rest = flat[(off + 4096) // 2 : (off + nbytes) // 2]
        if mode == "candidate":
            csig = torch.cat([unpack_strip(flat, off + 4096 + 1024 * ks, 1024) for ks in range(KHC // 64)])
            assert torch.equal(csig, cols(heads["csig_w"], 8).bfloat16())
            rest = rest[KHC * 8 :]
        assert not rest.float().abs().any()


@pytest.mark.parametrize("mode", MODES)
def test_forward_stream_fits_the_strip_table_at_the_deepest_trunk(mode):
    """At D = 16 with every layer a skip layer and F = 384 the candidate mode
    streams exactly the kernel's MAX_CHUNKS strips a tile, the others fewer."""
    skips = tuple(range(1, 16))
    trunk, heads, _, _ = world(16, skips, 384, mode)
    _, sched = stream(trunk, heads, skips, mode)
    n = len(sched) - (heads is not None)
    assert n <= max_chunks()
    assert (n == max_chunks()) == (mode == "candidate")


@pytest.mark.parametrize("mode", MODES)
def test_backward_rebuild_streams_the_forwards_strips(mode):
    """The backward's rebuild (its first strips: the trunk, xyzf, then c1 and
    c2) reads the same bytes as the forward's trunk, xyzf, c1 and c2 strips."""
    D, skips = DEPTHS["D8"]
    trunk, heads, _, _ = world(D, skips, 384, mode)
    C = KC if mode == "candidate" else 0
    fflat, fsched = th._fwd_wgmma_weights(trunk, heads, skips, IN0, C)
    bflat, bsched = th._bwd_wgmma_weights(trunk, heads, skips, IN0, C)
    n_chain = 2 + 8 * (D - 1) + 2 * len(skips) + (8 if heads is not None else 0)
    fwd = list(fsched[:n_chain])
    bwd = list(bsched[:n_chain])
    if mode == "candidate":
        n_feat = 12
        fwd += list(fsched[n_chain + n_feat : n_chain + n_feat + 7])
        bwd += list(bsched[n_chain : n_chain + 7])
    strip = lambda flat, p: flat[p[0] // 2 : (p[0] + p[1]) // 2]  # noqa: E731
    assert len(fwd) == len(bwd)
    for i, (a, b) in enumerate(zip(fwd, bwd)):
        assert a[1] == b[1] and torch.equal(strip(fflat, a), strip(bflat, b)), i


def emulate(trunk, heads, skips, x0, c_emb, F, mode):
    """The kernel's consumers in plain PyTorch: each product strip by strip
    from the packed stream (bf16 operands, f32 sums in strip order), the bias
    added in f32, each activation rounded to bf16 once; the trunk-only mode's
    output the last layer's f32 values. Returns as the plain versions."""
    flat, sched = stream(trunk, heads, skips, mode)
    order = iter(sched)
    r = lambda t: t.bfloat16().float()  # noqa: E731

    def product(blocks):
        """sum over the strips of A_j B_j, A_j the 64-column blocks given."""
        acc = None
        for a in blocks:
            off, nbytes = next(order)
            p = a @ unpack_strip(flat, off, nbytes).float()
            acc = p if acc is None else acc + p
        return acc

    def split(a):
        return [a[:, 64 * j : 64 * j + 64] for j in range(a.shape[1] // 64)]

    def wide(blocks, bias, relu, n_out=KW, nb=128):
        outs = []
        for b in range(n_out // nb):
            v = product(blocks) + bias[nb * b : nb * b + nb]
            outs.append(torch.relu(v) if relu else v)
        return torch.cat(outs, 1)

    x0t = r(torch.cat([x0, x0.new_zeros(x0.shape[0], X0_PAD - x0.shape[1])], 1))
    h = None
    for i, (_, b) in enumerate(trunk):
        blocks = [x0t] if i == 0 else ([x0t] if i in skips else []) + split(h)
        v = wide(blocks, b, True)
        h = r(v)
    if heads is None:
        return v
    noff = sched[-1][0]
    narrow = lambda k, off: torch.cat([unpack_strip(flat, off + 1024 * ks, 1024)  # noqa: E731
                                       for ks in range(k // 64)]).float()[:, :1]
    s_sigma = softplus(h @ narrow(KW, noff) + heads["sigma_b"])
    xyzf = r(wide(split(h), heads["xyzf_b"], False))
    FP = feat_pad(F, True)
    nb = min(FP, 128)
    pad = lambda t: torch.cat([t, t.new_zeros(FP - F)])  # noqa: E731
    s_feat = wide(split(xyzf), pad(heads["feat_b"]), False, FP, nb)[:, :F]
    if c_emb is None:
        return s_sigma, s_feat
    ce = r(torch.cat([c_emb, c_emb.new_zeros(c_emb.shape[0], X0_PAD - c_emb.shape[1])], 1))
    h1 = r(wide([ce] + split(xyzf), heads["c1_b"], True, KHC))
    h2 = r(wide(split(h1), heads["c2_b"], True, KHC))
    c_sigma = softplus(h2 @ narrow(KHC, noff + 4096) + heads["csig_b"])
    c_feat = wide(split(h2), pad(heads["cfeat_b"]), False, FP, nb)[:, :F]
    assert next(order, None) == sched[-1]
    return s_sigma, s_feat, c_sigma, c_feat


def rel(a, b) -> float:
    b = np.asarray(b, np.float64)
    return float(np.abs(np.asarray(a, np.float64) - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("depth", DEPTHS.values(), ids=DEPTHS.keys())
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("F", [32, 384])
def test_emulated_consumer_order_matches_plain_and_pallas(F, mode, depth, monkeypatch):
    """The emulation of the kernel's order against the plain version (bf16)
    and the JAX kernels in the Pallas interpreter (bf16), and those two
    against each other: EMU_TOL of each output's max."""
    monkeypatch.setattr(jph, "INTERPRET", True)
    monkeypatch.setattr(pallas_mlp, "INTERPRET", True)
    D, skips = depth
    trunk, heads, x0, c_emb = world(D, skips, F, mode)
    with torch.no_grad():
        got = emulate(trunk, heads, skips, x0, c_emb, F, mode)
    jt = tuple((jnp.asarray(w.numpy()), jnp.asarray(b.numpy())) for w, b in trunk)
    if heads is None:
        got = (got,)
        plain = (mlp.fused_trunk_plain(x0, trunk, skips, "bfloat16"),)
        jax_out = (pallas_mlp.fused_trunk(jnp.asarray(x0.numpy()), jt, skips, 64, "bfloat16"),)
    else:
        plain = th.fused_trunk_heads_plain(x0, c_emb, trunk, heads, skips, "bfloat16")
        jh = {k: jnp.asarray(v.numpy()) for k, v in heads.items()}
        jax_out = jph.fused_trunk_heads(jnp.asarray(x0.numpy()), None if c_emb is None else jnp.asarray(c_emb.numpy()),
                                        jt, jh, skips, 32, "bfloat16")
    assert len(got) == len(plain) == len(jax_out) == {"candidate": 4, "heads": 2, "trunk": 1}[mode]
    for a, p, j in zip(got, plain, jax_out):
        assert a.shape == p.shape and torch.isfinite(a).all()
        assert rel(a.numpy(), p.numpy()) <= EMU_TOL
        assert rel(a.numpy(), j) <= EMU_TOL
        assert rel(p.numpy(), j) <= EMU_TOL


@pytest.mark.parametrize("mode", MODES)
def test_emulation_rounds_as_the_kernel_does(mode):
    """The emulation rounds where the bf16 plain version does: its RMS
    distance to it is under a quarter of its distance to the f32 plain version
    (chip_smoke.py: TRUNK_RMS_RATIO), output by output."""
    trunk, heads, x0, c_emb = world(8, (4,), 384, mode)
    with torch.no_grad():
        got = emulate(trunk, heads, (4,), x0, c_emb, 384, mode)
        if heads is None:
            got = (got,)
            bf = (mlp.fused_trunk_plain(x0, trunk, (4,), "bfloat16"),)
            f32 = (mlp.fused_trunk_plain(x0, trunk, (4,), "float32"),)
        else:
            bf = th.fused_trunk_heads_plain(x0, c_emb, trunk, heads, (4,), "bfloat16")
            f32 = th.fused_trunk_heads_plain(x0, c_emb, trunk, heads, (4,), "float32")
    rms = lambda t: t.double().pow(2).mean().sqrt().item()  # noqa: E731
    for a, b, c in zip(got, bf, f32):
        assert rms(a - b) <= 0.25 * rms(a - c)


def test_the_mma_sync_forward_is_a_timing_variant():
    """The design the Hopper forward replaced is built beside it (one nvcc per
    source and variant) from the same source with one macro; both routes (the
    heads and the trunk-only wrapper) take the Hopper design, and the variant's
    name is the one chip_smoke.py and the card tests select."""
    assert _build.VARIANTS["heads_fwd_mma_sync"] == ("heads_fwd", ("-DUPNERF_HEADS_FWD_MMA_SYNC",))
    assert th.HEADS_FWD_DESIGNS[0] == "wgmma"
    assert th.HEADS_FWD_LIBS == {"wgmma": "heads_fwd", "mma_sync": "heads_fwd_mma_sync"}
    import inspect

    assert inspect.signature(th.fused_trunk_heads_fwd_launch).parameters["design"].default == "wgmma"
    for fn in (th.fused_trunk_heads_fwd, mlp.fused_trunk_fwd):
        src = inspect.getsource(fn)
        assert "fused_trunk_heads_fwd_launch(" in src and "design=" not in src and "mma_sync" not in src
    with pytest.raises(ValueError, match="design must be one of"):
        th.fused_trunk_heads_fwd_launch(torch.zeros(1, IN0), None, [], None, (), "bfloat16", "other")
