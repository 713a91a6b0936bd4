"""Kernels 5 and 6's backward as their CUDA route splits it, on the CPU
through the plain route: per slab of rows the plain backward's operands are
stored into the buffer of `upnerf_torch.ops.heads.heads_dw_layout` (rounded
to the compute dtype, a row of f32 bias sums a tile), then
`ops.dw_gemm.dw_gemm_plain` sums every weight gradient
(`heads.fused_trunk_heads_bwd_dw_plain`, `mlp.fused_trunk_bwd_dw_plain`).

At tests/test_torch_heads.py's sizes (D=4, W=32, skip 2, L=4, HC=16, C=4),
feature widths F = 32, 64 and 384, with the candidate branch, without it,
and trunk-only:
- the layout covers every product: the route's weight gradients equal the
  plain backward's direct products within 1e-6 of each gradient's max, its
  biases within 1e-6 of the sum of |terms| of their largest column (a bias
  can cancel far below its terms), its per-row outputs bit for bit, in f32
  and bf16;
- slabs of 3 rows over 70 rows (ragged) equal one slab to f32 rounding;
- the route against `jax.vjp` of `upnerf.ops.pallas_heads.fused_trunk_heads`
  and `upnerf.ops.pallas_mlp.fused_trunk` in the Pallas interpreter, at the
  tolerances tests/test_torch_heads.py and tests/test_torch_featureless.py
  state (1e-5; bf16 2e-2 / 1e-4 where pallas_heads.py:217's bare dot applies,
  1e-4 for the trunk kernel);
- dw_gemm_plain with f32 sources (the float32 instance's), against float64
  products;
- the layout at the kernels' widths (D=8, W=256, skip 4, HC=128, C=16): whole
  64-column blocks, the trunk's operands at i W from the first, every float
  of the result's weight part written by exactly one job.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.ops import pallas_heads as jph
from upnerf.ops import pallas_mlp
from upnerf_torch.ops import dw_gemm
from upnerf_torch.ops import heads as th
from upnerf_torch.ops import mlp
from upnerf_torch.ops.render_train import feat_pad

D, W, SK, L, HC, C, N = 4, 32, (2,), 4, 16, 4, 70
IN0 = 3 + 6 * L
PRECS = ("float32", "bfloat16")
ROUTE_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def world(F=16, cand=True, seed=0, n=N):
    """Numpy trunk, heads, x0, c_emb (None without the candidate branch) and
    cotangents, seeded."""
    rng = np.random.RandomState(seed)

    def lin(i, o):
        b = i**-0.5
        return rng.uniform(-b, b, (i, o)).astype(np.float32), rng.uniform(-b, b, o).astype(np.float32)

    trunk = [lin(IN0 if i == 0 else (IN0 + W if i in SK else W), W) for i in range(D)]
    shapes = dict(sigma=(W, 1), xyzf=(W, W), feat=(W, F))
    if cand:
        shapes.update(c1=(W + C, HC), c2=(HC, HC), csig=(HC, 1), cfeat=(HC, F))
    heads = {}
    for k, (i, o) in shapes.items():
        heads[k + "_w"], heads[k + "_b"] = lin(i, o)
    x0 = rng.randn(n, IN0).astype(np.float32)
    ce = rng.randn(n, C).astype(np.float32) if cand else None
    cots = [rng.randn(n, 1).astype(np.float32), rng.randn(n, F).astype(np.float32)]
    if cand:
        cots += [rng.randn(n, 1).astype(np.float32), rng.randn(n, F).astype(np.float32)]
    return trunk, heads, x0, ce, cots, rng.randn(n, W).astype(np.float32)


def to_torch(trunk, heads, x0, ce, cots, g):
    T = torch.from_numpy
    return ([(T(w), T(b)) for w, b in trunk], {k: T(v) for k, v in heads.items()}, T(x0),
            None if ce is None else T(ce), [T(c) for c in cots], T(g))


def rel(a, b):
    a, b = np.asarray(a, np.float64).reshape(-1), np.asarray(b, np.float64).reshape(-1)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def bias_scale(ops, g):
    """The largest column's sum of |terms| of a bias's cotangent."""
    return float(ops[g].abs().reshape(ops[g].shape[0], -1).sum(0).max())


def routes(mode, precision, F, slab_rows=None, seed=0):
    """(the plain backward, its operands, the route's result) in a mode."""
    trunk, heads, x0, ce, cots, g = to_torch(*world(F, mode == "candidate", seed))
    ops = {}
    if mode == "trunk":
        inputs, acts = mlp.trunk_chain(x0, trunk, SK, precision)
        ops.update({"x0": x0, **{f"act{i}": a for i, a in enumerate(acts)}})
        plain = mlp.trunk_walk_plain(x0, trunk, SK, precision, inputs, acts, g, ops)
        route = mlp.fused_trunk_bwd_dw_plain(x0, trunk, SK, precision, g, slab_rows)
        return (plain[0], None, plain[1], {}), ops, (route[0], None, route[1], {})
    plain = th.fused_trunk_heads_bwd_plain(x0, ce, trunk, heads, SK, precision, cots, ops)
    return plain, ops, th.fused_trunk_heads_bwd_dw_plain(x0, ce, trunk, heads, SK, precision, cots, slab_rows)


@pytest.mark.parametrize("precision", PRECS)
@pytest.mark.parametrize("mode,F", [("candidate", 32), ("candidate", 64), ("candidate", 384), ("heads", 32),
                                    ("heads", 64), ("heads", 384), ("trunk", 16)])
def test_layout_covers_every_product(mode, F, precision):
    plain, ops, route = routes(mode, precision, F)
    assert torch.equal(route[0], plain[0])
    assert (route[1] is None) == (plain[1] is None) and (plain[1] is None or torch.equal(route[1], plain[1]))
    for i, ((pw, pb), (rw, rb)) in enumerate(zip(plain[2], route[2])):
        assert rw.shape == pw.shape and rel(rw, pw) <= ROUTE_TOL, i
        assert float((rb - pb).abs().max()) <= ROUTE_TOL * bias_scale(ops, f"g_act{i}"), i
    biases = dict(th.heads_dw_biases(D, True, mode == "candidate"))
    assert set(route[3]) == set(plain[3])
    for k, p in plain[3].items():
        r = route[3][k]
        assert r.shape == p.reshape(r.shape).shape, k
        if k in biases:
            assert float((r - p.reshape(r.shape)).abs().max()) <= ROUTE_TOL * bias_scale(ops, biases[k]), k
        else:
            assert rel(r, p) <= ROUTE_TOL, k


@pytest.mark.parametrize("precision", PRECS)
@pytest.mark.parametrize("mode", ["candidate", "heads", "trunk"])
def test_slabs_of_three_rows_equal_one_slab(mode, precision):
    _, ops, one = routes(mode, precision, 16, seed=1)
    _, _, slabs = routes(mode, precision, 16, slab_rows=3, seed=1)
    assert rel(slabs[0], one[0]) <= ROUTE_TOL
    if one[1] is not None:
        assert rel(slabs[1], one[1]) <= ROUTE_TOL
    for i, ((aw, ab), (bw, bb)) in enumerate(zip(slabs[2], one[2])):
        assert rel(aw, bw) <= ROUTE_TOL and float((ab - bb).abs().max()) <= ROUTE_TOL * bias_scale(ops, f"g_act{i}")
    for k in one[3]:
        assert rel(slabs[3][k], one[3][k]) <= 1e-5, k


@pytest.mark.parametrize("precision", PRECS)
@pytest.mark.parametrize("mode", ["candidate", "heads", "trunk"])
def test_route_matches_pallas_vjp(monkeypatch, mode, precision):
    """The JAX kernels' VJP in the interpreter, at 64 rows."""
    monkeypatch.setattr(jph, "INTERPRET", True)
    monkeypatch.setattr(pallas_mlp, "INTERPRET", True)
    cand = mode == "candidate"
    trunk, heads, x0, ce, cots, g = world(16, cand, seed=2, n=64)
    jt = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in trunk)
    tt, th_, tx0, tce, tcots, tg = to_torch(trunk, heads, x0, ce, cots, g)
    if mode == "trunk":
        _, vjp = jax.vjp(lambda x_, p: pallas_mlp.fused_trunk(x_, p, SK, 32, precision), jnp.asarray(x0), jt)
        jdx, jdp = vjp(jnp.asarray(g))
        dx, dtrunk = mlp.fused_trunk_bwd_dw_plain(tx0, tt, SK, precision, tg, slab_rows=20)
        tol = 1e-5 if precision == "float32" else 1e-4
        assert rel(dx.numpy(), jdx) <= tol
        for i in range(D):
            assert rel(dtrunk[i][0].numpy(), jdp[i][0]) <= tol and rel(dtrunk[i][1].numpy(), jdp[i][1]) <= tol, i
        return
    keys = jph.HEAD_KEYS + (jph.CAND_KEYS if cand else ())
    jh = {k: jnp.asarray(heads[k]) for k in keys}
    jout, vjp = jax.vjp(lambda x, c, t, h: jph.fused_trunk_heads(x, c, t, h, SK, 32, precision), jnp.asarray(x0),
                        jnp.asarray(ce) if cand else None, jt, jh)
    jg = vjp(tuple(jnp.asarray(c) for c in cots[: len(jout)]))
    dx0, dce, dtr, dh = th.fused_trunk_heads_bwd_dw_plain(tx0, tce, tt, th_, SK, precision, tcots, slab_rows=20)
    bare_dot = precision == "bfloat16"  # pallas_heads.py:217 sums the trunk's input cotangent unrounded
    tol_trunk = 2e-2 if bare_dot else 1e-5
    tol_heads = 1e-4 if bare_dot else 1e-5
    assert rel(dx0.numpy(), jg[0]) <= tol_trunk
    if cand:
        assert rel(dce.numpy(), jg[1]) <= tol_heads
    for i in range(D):
        tol = tol_heads if i == D - 1 else tol_trunk
        assert rel(dtr[i][0].numpy(), jg[2][i][0]) <= tol and rel(dtr[i][1].numpy(), jg[2][i][1]) <= tol, i
    for k in keys:
        assert rel(dh[k].numpy(), jg[3][k]) <= tol_heads, k


@pytest.mark.parametrize("rows", [100, 1000])
def test_dw_gemm_plain_with_f32_sources(rows):
    """Strips of an f32 source against narrow and wide G strips, summed in f32,
    against the same products in float64 (1e-5 of each gradient's max), and
    the bias rows' column sums."""
    rng = np.random.RandomState(rows)
    src = torch.from_numpy(rng.randn(rows, 512).astype(np.float32))
    jobs = [dw_gemm.DwJob(0, 0, 128, 0, 128, 256, 0, 256, 100, 0, 256),
            dw_gemm.DwJob(0, 384, 64, 0, 448, 64, 1, 1, 64, 100 * 256, 1)]
    n_dw = 100 * 256 + 64
    bias = torch.from_numpy(rng.randn(7, 5).astype(np.float32))
    out = dw_gemm.dw_gemm_plain([src], jobs, torch.empty(n_dw + 5), n_dw, bias, False)
    s = src.double()
    want = [s[:, :100].t() @ s[:, 128:384], s[:, 384:448].t() @ s[:, 449:450]]
    assert rel(out[: 100 * 256], want[0]) <= 1e-5
    assert rel(out[100 * 256 : n_dw], want[1]) <= 1e-5
    assert rel(out[n_dw:], bias.double().sum(0)) <= 1e-6
    again = dw_gemm.dw_gemm_plain([src], jobs, out.clone(), n_dw, bias, True)
    assert torch.allclose(again, 2 * out, rtol=1e-6, atol=0)


@pytest.mark.parametrize("F", [32, 64, 384])
@pytest.mark.parametrize("mode", ["candidate", "heads", "trunk"])
def test_layout_at_the_kernel_widths(mode, F):
    Dk, Wk, skips, HCk, Ck = 8, 256, (4,), 128, 16
    heads = mode != "trunk"
    c = Ck if mode == "candidate" else 0
    for bf16 in (True, False):
        lay = th.heads_dw_layout(Dk, skips, Wk, feat_pad(F, bf16), HCk if c else 0, c, heads)
        assert lay.ops_w % dw_gemm.BLOCK == 0
        for name, col in lay.ops.items():
            assert col % (dw_gemm.BLOCK if name not in th.NARROW else 1) == 0, name
        for i in range(Dk):
            assert lay.ops[f"act{i}"] == lay.ops["act0"] + i * Wk
            assert lay.ops[f"g_act{i}"] == lay.ops["g_act0"] + i * Wk
            assert lay.bias[f"trunk{i}_b"][0] == lay.bias["trunk0_b"][0] + i * Wk
        written = np.zeros(lay.n_dw, np.int64)
        for j in lay.jobs:
            assert j.x_col + j.x_cols <= lay.ops_w and j.g_col + j.g_cols <= lay.ops_w
            assert j.x_cols % dw_gemm.BLOCK == 0 and j.g_cols % dw_gemm.BLOCK == 0
            for r in range(j.m_out):
                written[j.out_off + r * j.ldo : j.out_off + r * j.ldo + j.n_out] += 1
        assert (written == 1).all()
        slots = th.heads_layout_slots(lay)
        assert len(slots) == len(th.HEADS_LAYOUT) and slots[0] == lay.ops_w and slots[1] == lay.nb


@pytest.mark.parametrize("name", ["heads_bwd", "dw_gemm", "heads_fwd", "render_train_bwd", "render_train_bwd_wg",
                                  "mxu_probe"])
def test_c_entry_points_take_the_bindings_arguments(name):
    """Each C entry point's parameter count equals its ctypes binding's
    (ctypes passes whatever it is given: a count that differs goes unseen
    until the card); render_train_bwd_wg, the Hopper walk's stages, lives in
    render_train_bwd.cu, and the library binds it (_build.ENTRY_POINTS)."""
    import re
    from pathlib import Path

    from upnerf_torch.ops import _build

    source = {"render_train_bwd_wg": "render_train_bwd"}.get(name, name)
    assert f"upnerf_{name}" in _build.ENTRY_POINTS.get(source, (f"upnerf_{source}",))
    src = (Path(_build.CSRC_DIR) / f"{source}.cu").read_text()
    sig = re.search(rf"int upnerf_{name}\(([^)]*)\)", src).group(1)
    assert len(sig.split(",")) == len(_build._ARGTYPES[f"upnerf_{name}"])
