"""The bf16 saved-chain train backward as two kernels (the walk stores the
weight gradients' operands, csrc/dw_gemm.cu sums them), on the CPU through
its plain route upnerf_torch.ops.render_train.render_train_bwd_dw_plain:
per slab of rays the plain walk fills the operand buffers in dw_layout's
columns, then ops.dw_gemm.dw_gemm_plain adds the slab's products and bias
sums into the flat result.

At tests/test_torch_train_kernel.py's sizes (D=4, skip 2, W=32, F=16,
HH=HC=16, C=4, R=8, S=16, L=4), every mode of its COMBOS:
- against render_train_rays_bwd_plain, whose dW sums the same (rounded, in
  bf16) operands in another order: data cotangents equal, each weight
  gradient within 1e-6 of the leaf's max |g|, each bias within 1e-6 of the
  sum of |terms| of its largest column (a bias can cancel far below its
  terms, and a sum in another order moves by the terms' rounding);
- against jax.vjp of the Pallas kernel in interpret mode, at that file's
  tolerances (1e-4 of each leaf's max in f32, 1e-3 in bf16);
- in the x0 mode (PE rows of width 40), at F = 32 (the padded feature
  columns of the flat result exactly zero), and with slabs of 3 rays (R = 8
  is not a multiple);
- the layout at the kernels' widths: 64-column blocks, strips inside their
  sources, and every float of the result's weight part written by exactly
  one job.
"""

import numpy as np
import pytest
import torch

import test_torch_train_kernel as tk
from upnerf.ops import pallas_render_train as jrt
from upnerf_torch.ops import dw_gemm
from upnerf_torch.ops import render_train as rt

COMBOS, IDS = tk.COMBOS, tk.IDS
PRECS = ("float32", "bfloat16")
ROUTE_TOL = 1e-6
VJP_TOL = {"float32": 1e-4, "bfloat16": 1e-3}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rays_case(combo, precision, seed, feat=None):
    """(st, jst, numpy inputs, the rays backward's args, c_emb, residuals, cotangents) at the small
    sizes; feat: another feature width."""
    st, jst = tk.statics(*combo, precision=precision)
    inputs = tk.make_inputs(st, seed=seed)
    if feat is not None:
        inputs = with_feat(inputs, feat, seed)
    o, d, z, pe_w, cond, cemb, trunk, heads = tk.to_torch(inputs)
    _, res = rt.render_train_rays_plain(o, d, z, pe_w, cond, trunk, heads, st, c_emb=cemb, save_res=True)
    F = heads["feat_b"].shape[0]
    rng = np.random.RandomState(seed + 100)
    shapes = {"s_weights": (tk.R, tk.S), "s_depth": (tk.R,), "rgb_map": (tk.R, 3), "feat_map": (tk.R, F),
              "j_weights": (tk.R, tk.S), "c_depth": (tk.R,), "t_weight": (tk.R,)}
    cots = {k: torch.from_numpy(rng.randn(*shapes[k]).astype(np.float32)) for k in st.out_keys}
    return st, jst, inputs, (o, d, z, pe_w, cond, trunk, heads), cemb, res, cots


def with_feat(inputs, F, seed):
    """The inputs with feature width F: the feature weights redrawn."""
    o, d, z, pe_w, cond, cemb, trunk, heads = inputs
    rng = np.random.RandomState(seed + 50)
    W, HH, HC = tk.W, tk.HH, tk.HC
    heads = dict(heads, feat_w=(rng.randn(W, F) * W**-0.5).astype(np.float32),
                 feat_b=(rng.randn(F) * 0.1).astype(np.float32))
    if "rgb1_w" in heads:
        heads["rgb1_w"] = (rng.randn(F, HH) * F**-0.5).astype(np.float32)
    if "cfeat_w" in heads:
        heads["cfeat_w"] = (rng.randn(HC, F) * HC**-0.5).astype(np.float32)
        heads["cfeat_b"] = (rng.randn(F) * 0.1).astype(np.float32)
    return o, d, z, pe_w, cond, cemb, trunk, heads


def bias_scales(x0, z, cond, trunk, heads, st, cemb, res, cots):
    """Per bias leaf: the largest column's sum of |terms|, from the plain walk's cotangents."""
    _, _, _, ops = rt._bwd_walk_plain(x0, z, cond, trunk, heads, st, cemb, res, cots)
    return {name: float(ops[g].abs().sum(0).max()) for name, g in rt.dw_biases(st)}


def assert_route_close(got, want, st, scales):
    for i, name in enumerate(["d_x0", "ray_cond", "c_emb"] if len(got) == 5 else ["rays_o", "rays_d", "ray_cond",
                                                                                 "c_emb"]):
        if want[i] is None:
            assert got[i] is None, name
        else:
            assert torch.equal(got[i], want[i]), name  # the same walk
    dtrunk, dh = got[-2], got[-1]
    wtrunk, wh = want[-2], want[-1]
    for i, ((gw, gb), (ww, wb)) in enumerate(zip(dtrunk, wtrunk)):
        tk.assert_leaf_close(gw.numpy(), ww.numpy(), ROUTE_TOL, f"trunk{i}.w")
        scale = scales[f"trunk{i}_b"]
        np.testing.assert_allclose(gb.numpy() / scale, wb.numpy() / scale, rtol=0, atol=ROUTE_TOL,
                                   err_msg=f"trunk{i}.b")
    assert set(dh) == set(st.head_keys)
    for k in st.head_keys:
        g, w = dh[k].reshape(wh[k].shape).numpy(), wh[k].numpy()
        if k in scales:
            np.testing.assert_allclose(g / scales[k], w / scales[k], rtol=0, atol=ROUTE_TOL, err_msg=k)
        else:
            tk.assert_leaf_close(g, w, ROUTE_TOL, k)


@pytest.mark.parametrize("slab", [None, 3], ids=["one_slab", "slabs_of_3"])
@pytest.mark.parametrize("precision", PRECS)
@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_dw_route_matches_plain_backward(combo, precision, slab):
    st, _, _, args, cemb, res, cots = rays_case(combo, precision, seed=4)
    want = rt.render_train_rays_bwd_plain(*args, st, cemb, res, cots)
    got = rt.render_train_rays_bwd_dw_plain(*args, st, cemb, res, cots, slab_rays=slab)
    o, d, z, pe_w, cond, trunk, heads = args
    x0, _ = rt._pe(o, d, z, pe_w, st.xyz_L)
    assert_route_close(got, want, st, bias_scales(x0, z, cond, trunk, heads, st, cemb, res, cots))


@pytest.mark.parametrize("combo,precision", [(c, "float32") for c in COMBOS] + [(COMBOS[0], "bfloat16"),
                                                                                (COMBOS[2], "bfloat16")],
                         ids=[f"{i}-float32" for i in IDS] + ["phase1-bfloat16", "phase2-bfloat16"])
def test_dw_route_matches_pallas_vjp(combo, precision, monkeypatch):
    monkeypatch.setattr(jrt, "INTERPRET", True)
    st, jst, inputs, args, cemb, res, cots = rays_case(combo, precision, seed=6)
    got = rt.render_train_rays_bwd_dw_plain(*args, st, cemb, res, cots, slab_rays=5)
    tk.compare_grads(got, tk.jax_vjp(inputs, jst, {k: v.numpy() for k, v in cots.items()}), st, VJP_TOL[precision])


@pytest.mark.parametrize("precision", PRECS)
@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_dw_route_x0_mode(combo, precision):
    """From PE rows of width 40 (kernel 1b's x0 frontend), slabs of 3 rays."""
    st, _, _, args, cemb, _, cots = rays_case(combo, precision, seed=9)
    _, _, z, _, cond, trunk, heads = args
    rng = np.random.RandomState(19)
    in0 = 40
    x0 = torch.from_numpy((rng.randn(tk.R * tk.S, in0) * 0.5).astype(np.float32))
    fans = [in0] + [in0 + tk.W if i in tk.SKIPS else tk.W for i in range(1, tk.D)]
    trunk = [(torch.from_numpy((rng.randn(fan, tk.W) * 0.2).astype(np.float32)), b) for fan, (_, b) in zip(fans, trunk)]
    _, res = rt.render_train_plain(x0, z, cond, trunk, heads, st, c_emb=cemb, save_res=True)
    want = rt.render_train_bwd_plain(x0, z, cond, trunk, heads, st, cemb, res, cots)
    got = rt.render_train_bwd_dw_plain(x0, z, cond, trunk, heads, st, cemb, res, cots, slab_rays=3)
    assert got[0].shape == (tk.R * tk.S, in0) and tuple(got[3][0][0].shape) == (in0, tk.W)
    assert_route_close(got, want, st, bias_scales(x0, z, cond, trunk, heads, st, cemb, res, cots))


@pytest.mark.parametrize("precision", PRECS)
@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_dw_route_feat32_zero_padding(combo, precision):
    """F = 32 runs at the padded width FP (64 in bf16, 128 in f32): the padded
    columns and rows of the feature gradients come out exactly zero."""
    st, _, _, args, cemb, res, cots = rays_case(combo, precision, seed=11, feat=32)
    o, d, z, pe_w, cond, trunk, heads = args
    x0, xyz = rt._pe(o, d, z, pe_w, st.xyz_L)
    *got, flat, lay = rt.render_train_bwd_dw_plain(x0, z, cond, trunk, heads, st, cemb, res, cots, slab_rays=3,
                                                   flat_out=True)
    FP = rt.feat_pad(32, precision == "bfloat16")
    assert FP > 32
    pads = {"feat_w": (slice(None), slice(32, None)), "rgb1_w": (slice(32, None), slice(None)),
            "cfeat_w": (slice(None), slice(32, None))}
    for k, idx in pads.items():
        if k in lay.outs:
            off, (r, c) = lay.outs[k]
            assert flat[off : off + r * c].view(r, c)[idx].abs().max() == 0, k
    for k in ("feat_b", "cfeat_b"):
        if k in lay.bias:
            off, w = lay.bias[k]
            assert w == FP and flat[lay.n_dw + off + 32 : lay.n_dw + off + w].abs().max() == 0, k
    want = rt.render_train_bwd_plain(x0, z, cond, trunk, heads, st, cemb, res, cots)
    assert_route_close(tuple(got), want, st, bias_scales(x0, z, cond, trunk, heads, st, cemb, res, cots))


@pytest.mark.parametrize("F", rt.KERNEL_F)
@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_dw_layout_at_kernel_widths(combo, F):
    st = rt.RTStatic(D=8, skips=(4,), xyz_L=10, precision="bfloat16", use_cand=combo[0], use_rgb=combo[1],
                     out_feat=combo[2])
    W, HH, HC, C = 256, 128, 128, 16
    FP = rt.feat_pad(F, True)
    lay = rt.dw_layout(st, W, FP, HH, HC, C)
    chain_w = sum(w for _, w in st.chain_cols(W, HH, HC))
    widths = {rt.SRC_CHAIN: chain_w, rt.SRC_OPS: lay.ops_w, rt.SRC_RAY: lay.ray_w}
    assert lay.ops_w % 64 == 0 and lay.ray_w % 64 == 0 and chain_w % 64 == 0
    # the walk's 16-byte stores: every section but the narrow cotangents starts on a 64-column block
    assert all(c % 64 == 0 for k, c in lay.ops.items() if k not in rt.NARROW)
    cover = torch.zeros(lay.n_dw, dtype=torch.int32)
    for j in lay.jobs:
        assert j.x_cols % 64 == 0 and j.g_cols % 64 == 0 and j.x_col % 64 == 0 and j.g_col % 64 == 0
        assert j.x_col + j.x_cols <= widths[j.x_src] and j.g_col + j.g_cols <= widths[j.g_src]
        assert (j.x_src == rt.SRC_RAY) == (j.g_src == rt.SRC_RAY)  # X and G share their rows
        assert j.m_out <= j.x_cols and j.g0 + j.n_out <= j.g_cols and j.n_out <= j.ldo
        for r in range(j.m_out):
            cover[j.out_off + r * j.ldo : j.out_off + r * j.ldo + j.n_out] += 1
    assert bool((cover == 1).all())
    slots = rt.walk_layout(lay, st)
    assert len(slots) == len(rt.WALK_LAYOUT) + 2 * rt.MAX_D
    assert lay.nb == sum(w for _, w in lay.bias.values())
    # about 3,900 operand columns at F = 384 in phase 1; a slab's buffers within 1 GiB, a multiple of 132 rays
    if F == 384 and combo == COMBOS[0]:
        assert 3800 <= lay.ops_w <= 4000
    for S in (128, 256):
        n = rt.dw_slab_rays(lay, S, 132)
        assert n % 132 == 0 and n * (S * lay.ops_w * 2 + lay.ray_w * 2 + lay.nb * 4) <= rt.DW_BUFFER_BYTES


@pytest.mark.parametrize("accumulate", [False, True])
def test_dw_gemm_plain_matches_products(accumulate):
    """The plain dW against products written out, on bf16 sources of 150 rows
    (not a multiple of 64), a narrow G sub-block and kept rows / columns."""
    rng = np.random.RandomState(3)
    srcs = [torch.from_numpy(rng.randn(150, 192).astype(np.float32)).bfloat16(),
            torch.from_numpy(rng.randn(150, 128).astype(np.float32)).bfloat16(), None]
    jobs = [dw_gemm.DwJob(0, 64, 128, 1, 0, 128, 0, 128, 128, 0, 128),
            dw_gemm.DwJob(1, 0, 64, 0, 0, 64, 3, 2, 50, 128 * 128, 2)]
    n_dw, nb = 128 * 128 + 100, 5
    rows = torch.from_numpy(rng.randn(7, nb).astype(np.float32))
    out = torch.from_numpy(rng.randn(n_dw + nb).astype(np.float32))
    before = out.clone()
    dw_gemm.dw_gemm(srcs, jobs, out, n_dw, rows, accumulate)
    x, g = srcs[0].float(), srcs[1].float()
    want1 = x[:, 64:192].t() @ g
    want2 = g[:, :50].t() @ x[:, 3:5]
    base = before if accumulate else torch.zeros_like(before)
    torch.testing.assert_close(out[: 128 * 128].view(128, 128), base[: 128 * 128].view(128, 128) + want1)
    tail = slice(128 * 128, 128 * 128 + 100)
    torch.testing.assert_close(out[tail].view(50, 2), base[tail].view(50, 2) + want2)
    torch.testing.assert_close(out[n_dw:], base[n_dw:] + rows.sum(0))
