"""The Hopper walk of the bf16 backward (csrc/render_train_bwd.cu: pre_kernel,
walk_kernel, finish_kernel) as far as the CPU reaches it:

- its weight stream, upnerf_torch.ops.render_train._walk_wgmma_weights: every
  product's K-strips in the order the consumers read them, each strip
  unpacking to its block of the weight, within WALK_MAX_CHUNKS, for phases
  0 / 1 / 2 (the candidate branch on and off), F = 32 / 64 / 384, train and
  frozen, saved chain and recompute, and trunks with skip layers;
- the compositing step factored out of the plain walk (composite_bwd_plain,
  walk_coef_plain: the pre-pass's coefficient rows) against the plain walk's
  own operands;
- the per-tile partial sums (a tile never spans two rays, a ray's last tile
  ragged), summed in tile order, against the per-ray outputs at a ragged S;
- the bf16 route's plain version with a bias row a tile against the Pallas
  kernel's VJP in interpret mode (tests/test_torch_train_kernel.py's setup,
  seed 4).
Small shapes, one thread.
"""

import numpy as np
import pytest
import torch

import test_torch_train_kernel as ttk
from upnerf.ops import pallas_render_train as jrt
from upnerf_torch.ops import _build
from upnerf_torch.ops import render_train as rt

KW, KHH, KHC = 256, 128, 128  # the kernels' widths
PHASES = {0: (True, False, True), 1: (True, True, True), 2: (False, True, False)}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unpack_strip(flat: torch.Tensor, off: int, nbytes: int) -> torch.Tensor:
    """A K-strip of pack_wgmma's layout -> its (64, nb) block of the weight."""
    nb = nbytes // 128
    t = flat[off // 2 : (off + nbytes) // 2].reshape(nb, 8, 8)  # (n, chunk position, e)
    n = torch.arange(nb)[:, None]
    pos = torch.arange(8)[None, :] ^ (n % 8)  # chunk c sits at position c ^ (n % 8)
    out = torch.empty_like(t)
    out[n, torch.arange(8)[None, :]] = t[n, pos]
    return out.reshape(nb, 64).t()


def expected_order(D, skips, FP, rgb, cand, feat_op):
    """(matrix, block) of each K-strip in the consumers' order, as the walk's design states it."""
    NB = min(FP, 128)
    out = []

    def add(name, K, blocks):
        out.extend((name, b) for b in blocks for _ in range(K // 64))

    if feat_op:
        add("feat_w", KW, range(FP // NB))
    if rgb:
        add("rgb1_w^T", KHH, range(FP // NB))
    if cand:
        add("cfeat_w^T", FP, [0])
        add("c2_w^T", KHC, [0])
    for half in (0, 1):
        add("feat_w^T", FP, [half])
        if cand:
            add("c1x_w^T", KHC, [half])
    add("xyzf_w^T", KW, [0, 1])
    for i in reversed(range(D)):
        if i == 0 or i in skips:
            add(f"trunk{i}_x0^T", KW, [0])
        if i > 0:
            add(f"trunk{i}^T", KW, [0, 1])
    return out


def random_weights(D, skips, in0, F, rgb, cand, seed=0):
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    trunk = [(t(in0 if i == 0 else (in0 + KW if i in skips else KW), KW), t(KW)) for i in range(D)]
    heads = {"xyzf_w": t(KW, KW), "feat_w": t(KW, F), "feat_b": t(F)}
    if rgb:
        heads["rgb1_w"] = t(F, KHH)
    if cand:
        heads.update(c1x_w=t(KW, KHC), c2_w=t(KHC, KHC), cfeat_w=t(KHC, F))
    return trunk, heads


def expected_matrices(trunk, heads, D, skips, in0, FP):
    """Each product's B operand (K x N, the product g B), zero-padded as the walk reads it."""
    def cols(m, n):
        return torch.cat([m, m.new_zeros(m.shape[0], n - m.shape[1])], 1)

    mats = {"feat_w": cols(heads["feat_w"], FP), "feat_w^T": cols(heads["feat_w"], FP).t(),
            "xyzf_w^T": heads["xyzf_w"].t()}
    if "rgb1_w" in heads:
        mats["rgb1_w^T"] = cols(heads["rgb1_w"].t(), FP)
    if "c2_w" in heads:
        mats.update({"cfeat_w^T": cols(heads["cfeat_w"], FP).t(), "c2_w^T": heads["c2_w"].t(),
                     "c1x_w^T": heads["c1x_w"].t()})
    for i, (w, _) in enumerate(trunk):
        if i == 0 or i in skips:
            w = torch.cat([w[:in0], w.new_zeros(rt.X0_PAD - in0, KW), w[in0:]], 0)
            mats[f"trunk{i}_x0^T"] = w[: rt.X0_PAD].t()
            w = w[rt.X0_PAD :]
        if i > 0:
            mats[f"trunk{i}^T"] = w.t()
    return mats


@pytest.mark.parametrize("depth", [(8, (4,)), (3, (1, 2))], ids=["D8", "D3skips"])
@pytest.mark.parametrize("F", rt.KERNEL_F)
@pytest.mark.parametrize("phase", [0, 1, 2])
def test_walk_weight_stream_covers_every_product_in_order(phase, F, depth):
    """Every mode's stream: the K-strips in the consumers' order, each strip
    its weight block (bf16), within WALK_MAX_CHUNKS; whole KB strips of at
    most 16 KB at KB offsets (the kernel's ring stages)."""
    D, skips = depth
    cand, rgb, out_feat = PHASES[phase]
    in0 = 63
    FP = rt.feat_pad(F, True)
    trunk, heads = random_weights(D, skips, in0, F, rgb, cand)
    for save_chain in (True, False):
        for param_grads in (True, False):
            st = rt.RTStatic(D=D, skips=skips, xyz_L=10, precision="bfloat16", use_cand=cand, use_rgb=rgb,
                             out_feat=out_feat, save_chain=save_chain, param_grads=param_grads)
            flat, sched = rt._walk_wgmma_weights(trunk, heads, st, in0)
            feat_op = param_grads and rgb and save_chain
            _, _, labels = rt._walk_wgmma_plan(D, skips, in0, F, FP, rgb, cand, feat_op)
            assert flat.dtype == torch.bfloat16 and len(sched) == len(labels) <= rt.WALK_MAX_CHUNKS
            assert [(m, b) for m, b, _ in labels] == expected_order(D, skips, FP, rgb, cand, feat_op)
            mats = expected_matrices(trunk, heads, D, skips, in0, FP)
            for (off, nbytes), (name, b, ks) in zip(sched, labels):
                assert off % 1024 == 0 and nbytes % 1024 == 0 and 0 < nbytes <= 16384
                nb = nbytes // 128
                want = mats[name][64 * ks : 64 * ks + 64, nb * b : nb * b + nb].to(torch.bfloat16)
                assert torch.equal(unpack_strip(flat, off, nbytes), want), (name, b, ks)


def test_walk_weight_stream_fits_at_the_deepest_trunk():
    """The longest stream the kernels take (D = 16, every layer a skip layer,
    F = 384, the train mode with the candidate branch and rgb) fits the
    kernel's schedule."""
    D = rt.MAX_D
    _, sched, _ = rt._walk_wgmma_plan(D, tuple(range(1, D)), 63, 384, 384, True, True, True)
    assert len(sched) <= rt.WALK_MAX_CHUNKS


def small_case(phase, S, precision="float32", seed=0, R=3):
    """A small mode of ttk's widths at R rays x S samples: (args, c_emb, res, cots) on the CPU."""
    st = rt.RTStatic(D=ttk.D, skips=ttk.SKIPS, xyz_L=ttk.L, precision=precision, use_cand=PHASES[phase][0],
                     use_rgb=PHASES[phase][1], out_feat=PHASES[phase][2])
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    inputs = list(ttk.make_inputs(st, seed=seed))
    o, d, _, pe_w, cond, cemb, trunk, heads = ttk.to_torch(inputs)
    o, d = t(R, 3, scale=0.3), t(R, 3)
    d = d / d.norm(dim=-1, keepdim=True)
    z = torch.from_numpy(np.sort(rng.uniform(0.1, 2.0, (R, S)), -1).astype(np.float32))
    cond = t(R, ttk.HH, scale=0.3) if st.use_rgb else None
    cemb = t(R, ttk.C) if st.use_cand else None
    _, res = rt.render_train_rays_plain(o, d, z, pe_w, cond, trunk, heads, st, c_emb=cemb, save_res=True)
    shapes = {"s_weights": (R, S), "s_depth": (R,), "rgb_map": (R, 3), "feat_map": (R, ttk.F), "j_weights": (R, S),
              "c_depth": (R,), "t_weight": (R,)}
    cots = {k: t(*shapes[k]) for k in st.out_keys}
    return (o, d, z, pe_w, cond, trunk, heads, st), cemb, res, cots


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_coefficient_rows_equal_the_plain_walks_operands(phase):
    """walk_coef_plain (the pre-pass's rows: g_spre, g_cpre, cfw, cgw, g_u)
    against the operands _bwd_walk_plain keeps: g_spre, g_cpre and g_u
    exactly; cfw g_feat and cgw g_feat as feat's and c_feat's cotangents (feat's
    less its rgb term)."""
    args, cemb, res, cots = small_case(phase, 20)
    o, d, z, pe_w, cond, trunk, heads, st = args
    x0, _ = rt._pe(o, d, z, pe_w, st.xyz_L)
    coef = rt.walk_coef_plain(x0, z, cond, trunk, heads, st, cemb, res, cots)
    _, _, _, ops = rt._bwd_walk_plain(x0, z, cond, trunk, heads, st, cemb, res, cots)
    R, S = z.shape
    assert coef.shape == (R * S, rt.WALK_COEF_W) and not coef[:, 7].any()
    assert torch.equal(coef[:, 0:1], ops["g_spre"])
    if st.use_cand:
        assert torch.equal(coef[:, 1:2], ops["g_cpre"])
    else:
        assert not coef[:, 1].any() and not coef[:, 3].any()
    g_feat = cots["feat_map"] if st.out_feat else None
    if st.use_rgb:
        assert torch.equal(coef[:, 4:7], ops["g_u"])
        from_rgb = rt.matmul(ops["g_rgbh"], heads["rgb1_w"].t(), "float32")
    else:
        assert not coef[:, 4:7].any()
    if st.out_feat:
        gf = (coef[:, 2].reshape(R, S, 1) * g_feat[:, None, :]).reshape(R * S, -1)
        want = ops["g_feat"] - from_rgb if st.use_rgb else ops["g_feat"]
        torch.testing.assert_close(gf, want, rtol=0, atol=1e-6 * float(want.abs().max()))
        if st.use_cand:
            gc = (coef[:, 3].reshape(R, S, 1) * g_feat[:, None, :]).reshape(R * S, -1)
            assert torch.equal(gc, ops["g_cfeat"])
    else:
        assert not coef[:, 2].any()


@pytest.mark.parametrize("S", [100, 48, 130])
def test_tile_partials_in_tile_order_give_the_ray_sums(S):
    """At a ragged S: each sample lands in tile ray ceil(S / 64) + s // 64;
    the tiles' partial sums of g_rgbh, g_h1 and the PE backward's dxyz (and
    dxyz z), summed in tile order, give d_ray_cond, rayg1 and d_rays_o /
    d_rays_d; the per-tile bias rows of the train mode sum to the per-ray
    ones."""
    R = 3
    tpr = -(-S // rt.WALK_TILE)
    idx = torch.arange(R * S, dtype=torch.float64)[:, None]
    tiles = rt.tile_sums_plain(torch.ones_like(idx), S)
    assert tiles.shape == (R * tpr, 1)
    counts = [min(rt.WALK_TILE, S - rt.WALK_TILE * k) for k in range(tpr)] * R
    assert tiles[:, 0].tolist() == counts
    owner = rt.tile_sums_plain(idx, S)[:, 0]
    for tile in range(R * tpr):
        ray, k = divmod(tile, tpr)
        s = torch.arange(rt.WALK_TILE * k, min(S, rt.WALK_TILE * (k + 1)))
        assert owner[tile].item() == float((ray * S + s).sum())

    args, cemb, res, cots = small_case(1, S)
    o, d, z, pe_w, cond, trunk, heads, st = args
    x0, xyz = rt._pe(o, d, z, pe_w, st.xyz_L)
    dx0, d_cond, d_cemb, ops = rt._bwd_walk_plain(x0, z, cond, trunk, heads, st, cemb, res, cots)
    tol = dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rt.ray_sums_plain(rt.tile_sums_plain(ops["g_rgbh"], S), tpr), d_cond, **tol)
    torch.testing.assert_close(rt.ray_sums_plain(rt.tile_sums_plain(ops["g_h1"], S), tpr), ops["ray_g1"], **tol)
    # the PE backward per sample: the tiles' sums of dxyz and dxyz z
    d_o, d_d = rt._pe_bwd(dx0, xyz, z, pe_w, st.xyz_L)
    per = torch.cat([rt._pe_bwd(dx0[i : i + 1], xyz[i : i + 1], z.reshape(-1, 1)[i : i + 1], pe_w, st.xyz_L)[0]
                     for i in range(R * S)])
    torch.testing.assert_close(rt.ray_sums_plain(rt.tile_sums_plain(per, S), tpr), d_o, **tol)
    torch.testing.assert_close(rt.ray_sums_plain(rt.tile_sums_plain(per * z.reshape(-1, 1), S), tpr), d_d, **tol)
    # the bias rows of the dW operands, a row a tile against a row a ray
    lay = rt.dw_layout(st, ttk.W, ttk.F, ttk.HH, ttk.HC, ttk.C)
    _, _, per_ray = rt.dw_operands_plain(ops, lay, st, R, S, torch.float32)
    _, _, per_tile = rt.dw_operands_plain(ops, lay, st, R, S, torch.float32, rt.WALK_TILE)
    assert per_tile.shape == (R * tpr, lay.nb)
    torch.testing.assert_close(rt.ray_sums_plain(per_tile, tpr), per_ray, **tol)


@pytest.mark.parametrize("combo", [ttk.COMBOS[0], ttk.COMBOS[2]], ids=["phase1", "phase2"])
def test_bf16_route_with_tile_bias_rows_matches_pallas_vjp(combo, monkeypatch):
    """The bf16 route's plain version (slabs of 3 rays, a bias row a 64-sample
    tile, the plain dW) against the Pallas kernel's bf16 VJP in interpret
    mode, at test_torch_train_kernel.py's tolerance for bf16 (1e-3 of each
    leaf's max)."""
    monkeypatch.setattr(jrt, "INTERPRET", True)
    st, jst = ttk.statics(*combo, precision="bfloat16")
    inputs = ttk.make_inputs(st, seed=4)
    cots = ttk.cotangents(st)
    o, d, z, pe_w, cond, cemb, trunk, heads = ttk.to_torch(inputs)
    _, res = rt.render_train_rays_plain(o, d, z, pe_w, cond, trunk, heads, st, c_emb=cemb, save_res=True)
    got = rt.render_train_rays_bwd_dw_plain(o, d, z, pe_w, cond, trunk, heads, st, cemb, res,
                                            {k: torch.from_numpy(v) for k, v in cots.items()}, slab_rays=3)
    ttk.compare_grads(got, ttk.jax_vjp(inputs, jst, cots), st, 1e-3)


def test_the_mma_sync_walk_is_a_timing_variant():
    """The design the Hopper walk replaced is built beside it (one nvcc per
    source and variant) and binds both entry points; the route takes the
    Hopper walk."""
    assert _build.VARIANTS["render_train_bwd_mma_sync"] == ("render_train_bwd", ("-DUPNERF_BWD_MMA_SYNC",))
    assert rt.BWD_DESIGNS[0] == "wgmma" and rt.BWD_LIBS == {"wgmma": "render_train_bwd",
                                                            "mma_sync": "render_train_bwd_mma_sync"}
    assert _build.ENTRY_POINTS["render_train_bwd"] == ("upnerf_render_train_bwd", "upnerf_render_train_bwd_wg")


def test_mask_words_and_partial_rows_plain():
    """walk_mask_plain sets bit b of word w where chain[32 w + b] > 0 (not at
    +-0, negatives or NaN), as int32 words; walk_part_plain's rows, summed over
    each ray's tiles, give d_ray_cond, rayg1, d_rays_o and d_rays_d."""
    rng = np.random.RandomState(1)
    chain = torch.from_numpy(rng.randn(5, 96).astype(np.float32)).bfloat16()
    chain[0, 3] = -0.0
    chain[1, 31] = float("nan")
    chain[2, 0:32] = 1.0
    words = rt.walk_mask_plain(chain)
    assert words.dtype == torch.int32 and words.shape == (5, 3)
    for r in range(5):
        for c in range(96):
            bit = (int(words[r, c // 32]) >> (c % 32)) & 1
            assert bit == int(float(chain[r, c]) > 0), (r, c)
    assert int(words[2, 0]) == -1
    S = 70
    args, cemb, res, cots = small_case(1, S)
    o, d, z, pe_w, cond, trunk, heads, st = args
    x0, xyz = rt._pe(o, d, z, pe_w, st.xyz_L)
    dx0, d_cond, _, ops = rt._bwd_walk_plain(x0, z, cond, trunk, heads, st, cemb, res, cots)
    part = rt.walk_part_plain(ops, dx0, xyz, z, pe_w, st)
    tpr = -(-S // rt.WALK_TILE)
    ray = rt.ray_sums_plain(part, tpr)
    d_o, d_d = rt._pe_bwd(dx0, xyz, z, pe_w, st.xyz_L)
    tol = dict(rtol=1e-5, atol=1e-6)
    HH = 128
    torch.testing.assert_close(ray[:, : ttk.HH], d_cond, **tol)
    torch.testing.assert_close(ray[:, HH : HH + ttk.HC], ops["ray_g1"], **tol)
    torch.testing.assert_close(ray[:, 2 * HH : 2 * HH + 3], d_o, **tol)
    torch.testing.assert_close(ray[:, 2 * HH + 3 : 2 * HH + 6], d_d, **tol)
