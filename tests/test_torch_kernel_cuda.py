"""The CUDA kernels of the render path against their plain PyTorch versions,
on the card, at the brandenburg_gate width (D=8, W=256, skip 4, F=384, HH=128,
L=10) and at the validation configs' feature widths (F=32, 64): the fused
forward render, its backward in the train and frozen-model modes, the trunk
kernel of the fast render's probe and its backward (the feature-less field's),
the trunk + heads kernels (forward and backward; the bf16 forward in both
designs, heads.HEADS_FWD_DESIGNS, and its trunk bit for bit the backward's
rebuild), the static render from
PE rows (the x0 mode), the fused render from PE rows in every training mode
with its d_x0 backward (kernel 1b), and the matrix-unit probe's three chains in
both designs (mxu_probe.PROBE_DESIGNS).
Every test here needs an NVIDIA card: it carries the `cuda` marker and skips
without one.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest tests/test_torch_kernel_cuda.py -q --noconftest -p no:cacheprovider

Tolerances (as in chip_smoke.py): float32 1e-5 (f32 sums in another order),
bfloat16 1e-3 (an f32 sum that lands on the other side of a bf16 rounding
boundary moves one operand by one bf16 ulp), absolute on rgb_map and
s_weights, relative on s_depth.
"""

import numpy as np
import pytest
import torch

from upnerf_torch.ops import render_train as rt

TOL = {"float32": 1e-5, "bfloat16": 1e-3}
D, SKIPS, W, HH, L = 8, (4,), 256, 128, 10
WIDTHS = [384, 32, 64]  # the built feature widths (render_train.KERNEL_F)
# The forward kernel's tile plans: two rays a tile, ragged (48: the validation configs' coarse pass) and full;
# one ray a tile, ragged (96: their fine pass, 100) and full; two tiles.
SAMPLES = [48, 64, 96, 100, 128, 256]
# What a recompute backward call allocates besides one slab's buffers and its outputs: both kernels' packed
# weights (with the forward's gather index, kept per mode), the dW kernel's split sums (~16 MB at 132 rays x 256
# samples, phase 1), the forward's per-slab x0 and state scratch and its dropped outputs (~6 MB).
REC_EXTRA_BYTES = 96 << 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def make_inputs(R, S, device, seed=0, F=384, depth=D, skips=SKIPS):
    """Rays, sorted depths in [0.1, 5], band weights, ray_cond and a
    torch-default-initialised network in the (in, out) interface."""
    rng = np.random.RandomState(seed)
    in0 = 3 + 6 * L

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def lin(i, o):
        b = i**-0.5
        return t(rng.uniform(-b, b, (i, o))), t(rng.uniform(-b, b, o))

    d = rng.randn(R, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 5.0, (R, S)), -1)
    trunk = [lin(in0 if i == 0 else (in0 + W if i in skips else W), W) for i in range(depth)]
    heads = {}
    heads["xyzf_w"], heads["xyzf_b"] = lin(W, W)
    heads["sigma_w"], heads["sigma_b"] = lin(W, 1)
    heads["feat_w"], heads["feat_b"] = lin(W, F)
    heads["rgb1_w"] = lin(F, HH)[0]
    heads["rgb2_w"], heads["rgb2_b"] = lin(HH, 3)
    return (t(rng.randn(R, 3) * 0.3), t(d), t(z), t(rng.uniform(0.3, 1.0, L)), t(rng.randn(R, HH) * 0.3),
            trunk, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", SAMPLES)
def test_kernel_matches_plain(cuda_device, precision, S, F):
    inputs = make_inputs(300, S, cuda_device, F=F)
    st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=L, precision=precision)
    before = rt.launches
    with torch.no_grad():
        got = rt.render_train_rays_fwd(*inputs, st)
        want = rt.render_train_rays_plain(*inputs, st)
    torch.cuda.synchronize()
    assert rt.launches == before + 1
    tol = TOL[precision]
    for k in ("rgb_map", "s_weights"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=tol)
    torch.testing.assert_close(got["s_depth"], want["s_depth"], rtol=tol, atol=0)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    o, d, z, pe_w, cond, trunk, heads = make_inputs(8, 64, cuda_device)
    st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=L, precision="bfloat16")
    with pytest.raises(ValueError, match="dtype"):
        rt.render_train_rays_fwd(o, d, z, pe_w, cond, [(w.bfloat16(), b) for w, b in trunk], heads, st)
    with pytest.raises(ValueError, match="shape"):
        rt.render_train_rays_fwd(o, d, z, pe_w[:9], cond, trunk, heads, st)
    with pytest.raises(ValueError, match="W=256"):
        rt.render_train_rays_fwd(o, d, z, pe_w, cond[:, :64], trunk, heads, st)
    narrow = dict(heads, feat_w=heads["feat_w"][:, :48], feat_b=heads["feat_b"][:48], rgb1_w=heads["rgb1_w"][:48])
    with pytest.raises(ValueError, match="feature widths"):
        rt.render_train_rays_fwd(o, d, z, pe_w, cond, trunk, narrow, st)
    with pytest.raises(RuntimeError, match="forward-only"):
        rt.render_train_rays_fwd(o, d, z, pe_w, cond.requires_grad_(), trunk, heads, st)


def add_candidate(heads, device, seed=1, C=16, HC=128, F=384):
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def lin(i, o):
        b = i**-0.5
        return t(rng.uniform(-b, b, (i, o))), t(rng.uniform(-b, b, o))

    heads = dict(heads)
    heads["c1x_w"], heads["c1_b"] = lin(W, HC)
    heads["c1c_w"] = lin(C, HC)[0]
    heads["c2_w"], heads["c2_b"] = lin(HC, HC)
    heads["csig_w"], heads["csig_b"] = lin(HC, 1)
    heads["cfeat_w"], heads["cfeat_b"] = lin(HC, F)
    return heads


def train_inputs(R, S, device, phase, precision, seed=0, F=384, depth=D, skips=SKIPS):
    """Inputs of one training mode (phase 0: candidate + feature map; phase 1:
    also rgb) and its RTStatic."""
    o, d, z, pe_w, cond, trunk, heads = make_inputs(R, S, device, seed, F, depth, skips)
    heads = add_candidate(heads, device, seed + 1, F=F)
    c_emb = torch.from_numpy(np.random.RandomState(seed + 2).randn(R, 16).astype(np.float32)).to(device)
    st = rt.RTStatic(D=depth, skips=skips, xyz_L=L, precision=precision, use_cand=True, use_rgb=phase > 0,
                     out_feat=True)
    heads = {k: heads[k] for k in st.head_keys}
    return (o, d, z, pe_w, cond if st.use_rgb else None, trunk, heads, st), c_emb


@pytest.mark.cuda
@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("S", SAMPLES)
def test_train_forward_matches_plain(cuda_device, precision, phase, S, F):
    """Forward kernel with residuals in the phase-0/1 modes; residuals too (the
    bf16 chain is stored rounded: 1e-2 of its max for a rounding flip)."""
    args, c_emb = train_inputs(256, S, cuda_device, phase, precision, F=F)
    check_train_forward(args, c_emb, precision)


def check_train_forward(args, c_emb, precision):
    """The forward kernel with residuals (one launch) against its plain version:
    outputs at TOL, sig_s, sig_c and rgb at TOL, the chain at 1e-2 of its max in
    bf16 (a rounding flip), 1e-5 in f32."""
    before = rt.launches
    with torch.no_grad():
        got, got_res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
        want, want_res = rt.render_train_rays_plain(*args, c_emb=c_emb, save_res=True)
    torch.cuda.synchronize()
    assert rt.launches == before + 1
    tol = TOL[precision]
    for k in args[-1].out_keys:
        if "depth" in k:
            torch.testing.assert_close(got[k], want[k], rtol=tol, atol=0)
        else:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=tol)
    for k in ("sig_s", "sig_c", "rgb"):
        if k in want_res:
            torch.testing.assert_close(got_res[k], want_res[k], rtol=tol, atol=tol)
    chain_tol = 1e-2 if precision == "bfloat16" else 1e-5
    scale = want_res["chain"].float().abs().max()
    assert (got_res["chain"].float() - want_res["chain"].float()).abs().max() <= chain_tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("S", [48, 64])
@pytest.mark.parametrize("mode", ["serving", "phase1"])
def test_bf16_forward_at_an_odd_ray_count_matches_plain(cuda_device, mode, S):
    """R = 151, S <= 64: two rays a tile, and the last tile's second ray does
    not exist (computed on the last ray's inputs, written nowhere)."""
    if mode == "serving":
        inputs = make_inputs(151, S, cuda_device, seed=41)
        st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=L, precision="bfloat16")
        with torch.no_grad():
            got = rt.render_train_rays_fwd(*inputs, st)
            want = rt.render_train_rays_plain(*inputs, st)
        for k in ("rgb_map", "s_weights"):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=TOL["bfloat16"])
        torch.testing.assert_close(got["s_depth"], want["s_depth"], rtol=TOL["bfloat16"], atol=0)
    else:
        args, c_emb = train_inputs(151, S, cuda_device, 1, "bfloat16", seed=41)
        check_train_forward(args, c_emb, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_train_forward_at_the_deepest_trunk_matches_plain(cuda_device, precision):
    """D = MAX_D (16) with every layer past the first a skip layer, phase 1 at
    F = 384: the longest weight stream a tile of the bf16 kernel reads."""
    args, c_emb = train_inputs(64, 128, cuda_device, 1, precision, seed=43, depth=rt.MAX_D,
                               skips=tuple(range(1, rt.MAX_D)))
    check_train_forward(args, c_emb, precision)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["serving", "phase1"])
def test_bf16_forward_at_5600_samples_a_ray_matches_plain(cuda_device, mode):
    """S = 5600 (near the most the mma.sync design's shared memory took) at an
    odd R: the bf16 kernel keeps no per-sample state in shared memory."""
    if mode == "serving":
        inputs = make_inputs(3, 5600, cuda_device, seed=45)
        st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=L, precision="bfloat16")
        with torch.no_grad():
            got = rt.render_train_rays_fwd(*inputs, st)
            want = rt.render_train_rays_plain(*inputs, st)
        for k in ("rgb_map", "s_weights"):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=TOL["bfloat16"])
        torch.testing.assert_close(got["s_depth"], want["s_depth"], rtol=TOL["bfloat16"], atol=0)
    else:
        args, c_emb = train_inputs(3, 5600, cuda_device, 1, "bfloat16", seed=45)
        check_train_forward(args, c_emb, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase", [0, 1])
def test_backward_matches_plain(cuda_device, precision, phase, F):
    """Backward kernel against render_train_rays_bwd_plain on the same
    residuals; every cotangent within 1e-4 (f32) / 1e-2 (bf16) of its max."""
    args, c_emb = train_inputs(256, 128, cuda_device, phase, precision, seed=3, F=F)
    st = args[-1]
    with torch.no_grad():
        out, res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
        g = torch.Generator(device=cuda_device).manual_seed(0)
        cots = {k: torch.randn(v.shape, generator=g, device=cuda_device) for k, v in out.items()}
        before = rt.bwd_launches
        got = rt.render_train_rays_bwd(*args[:7], st, c_emb, res, cots)
        want = rt.render_train_rays_bwd_plain(*args[:7], st, c_emb, res, cots)
    torch.cuda.synchronize()
    assert rt.bwd_launches == before + 1
    tol = 1e-2 if precision == "bfloat16" else 1e-4

    def close(a, b):
        assert torch.isfinite(a).all()
        assert (a - b.reshape(a.shape)).abs().max() <= tol * b.abs().max()

    for a, b in zip(got[:4], want[:4]):
        if b is not None:
            close(a, b)
    for (aw, ab), (bw, bb) in zip(got[4], want[4]):
        close(aw, bw)
        close(ab, bb)
    for k in st.head_keys:
        close(got[5][k], want[5][k])


@pytest.mark.cuda
def test_render_train_rays_function_launches_both_kernels(cuda_device):
    args, c_emb = train_inputs(64, 128, cuda_device, 1, "bfloat16", seed=5)
    o, d, z, pe_w, cond, trunk, heads, st = args
    leaves = [o.requires_grad_(), cond.requires_grad_(), trunk[0][0].requires_grad_(), heads["c1c_w"].requires_grad_()]
    before = (rt.launches, rt.bwd_launches)
    out = rt.render_train_rays(o, d, z, pe_w, cond, trunk, heads, st, c_emb=c_emb)
    (out["feat_map"].sum() + out["rgb_map"].sum() + out["s_depth"].sum()).backward()
    torch.cuda.synchronize()
    assert (rt.launches, rt.bwd_launches) == (before[0] + 1, before[1] + 1)
    for t in leaves:
        assert t.grad is not None and torch.isfinite(t.grad).all() and t.grad.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase", [1, 2])
def test_frozen_backward_matches_train_mode_and_plain(cuda_device, precision, phase):
    """The backward's frozen-model mode (param_grads=False): no weight
    gradients, data cotangents bit for bit the train mode's (the same
    instructions in the same order, no atomics on them), and within 1e-4 (f32)
    / 1e-2 (bf16) of the plain frozen backward."""
    if phase == 2:
        o, d, z, pe_w, cond, trunk, heads = make_inputs(128, 128, cuda_device, seed=7)
        st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=L, precision=precision)
        args, c_emb = (o, d, z, pe_w, cond, trunk, heads, st), None
    else:
        args, c_emb = train_inputs(128, 128, cuda_device, phase, precision, seed=7)
        st = args[-1]
    frozen = st._replace(param_grads=False)
    with torch.no_grad():
        out, res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
        g = torch.Generator(device=cuda_device).manual_seed(1)
        cots = {k: torch.randn(v.shape, generator=g, device=cuda_device) for k, v in out.items()}
        before = (rt.bwd_launches, rt.frozen_bwd_launches)
        train = rt.render_train_rays_bwd(*args[:7], st, c_emb, res, cots)
        got = rt.render_train_rays_bwd(*args[:7], frozen, c_emb, res, cots)
        want = rt.render_train_rays_bwd_plain(*args[:7], frozen, c_emb, res, cots)
    torch.cuda.synchronize()
    assert (rt.bwd_launches, rt.frozen_bwd_launches) == (before[0] + 1, before[1] + 1)
    assert got[4] is None and got[5] is None
    tol = 1e-2 if precision == "bfloat16" else 1e-4
    for a, t, b in zip(got[:4], train[:4], want[:4]):
        if b is None:
            assert a is None
            continue
        assert torch.equal(a, t)
        assert torch.isfinite(a).all() and (a - b).abs().max() <= tol * b.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [4096, 1037])
def test_trunk_kernel_matches_plain(cuda_device, precision, N):
    """The trunk kernel against fused_trunk_plain, max |d| over max |value|:
    1e-5 (f32), 5e-3 (bf16: a bf16 rounding flip of an activation carries
    into the next layers); rows past N (ragged) are not written. Such flips
    are sparse, so the kernel's RMS distance to the plain version of its own
    precision is under a quarter of its distance to the other precision's (as
    in chip_smoke.py): the bf16 kernel rounds its operands."""
    from upnerf_torch.ops import mlp

    _, _, _, _, _, trunk, _ = make_inputs(8, 8, cuda_device, seed=11)
    x = torch.from_numpy(np.random.RandomState(12).randn(N, 3 + 6 * L).astype(np.float32)).to(cuda_device)
    other = "float32" if precision == "bfloat16" else "bfloat16"
    before = mlp.launches
    with torch.no_grad():
        got = mlp.fused_trunk(x, trunk, SKIPS, precision)
        want = mlp.fused_trunk_plain(x, trunk, SKIPS, precision)
        want_other = mlp.fused_trunk_plain(x, trunk, SKIPS, other)
    torch.cuda.synchronize()
    assert mlp.launches == before + 1 and got.shape == (N, W)
    tol = 5e-3 if precision == "bfloat16" else 1e-5
    assert torch.isfinite(got).all() and (got - want).abs().max() <= tol * want.abs().max()
    assert (got - want).pow(2).mean().sqrt() <= 0.25 * (got - want_other).pow(2).mean().sqrt()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [4096, 1037])
def test_trunk_backward_matches_plain(cuda_device, precision, N):
    """The trunk kernel's backward (the trunk-only mode of csrc/heads_bwd.cu)
    against fused_trunk_bwd_plain. Both recompute the chain in their own
    summation order, so a ReLU mask can flip in a row (as kernel 5's, in
    chip_smoke.py: HEADS_BWD_TOL): every output within 2e-2 of its RMS by RMS
    distance; dx closer to the plain version of the kernel's precision than a
    quarter of its distance to the other precision's; and on dx and all
    weight gradients together no further from the float64 plain backward than
    twice the plain version's own distance (chip_smoke.py: HEADS_F64_RATIO)."""
    from upnerf_torch.ops import mlp

    _, _, _, _, _, trunk, _ = make_inputs(8, 8, cuda_device, seed=13)
    rng = np.random.RandomState(14)
    x = torch.from_numpy(rng.randn(N, 3 + 6 * L).astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.randn(N, W).astype(np.float32)).to(cuda_device)
    other = "float32" if precision == "bfloat16" else "bfloat16"
    before = mlp.bwd_launches
    with torch.no_grad():
        got = mlp.fused_trunk_bwd(x, trunk, SKIPS, precision, g)
        want = mlp.fused_trunk_bwd_plain(x, trunk, SKIPS, precision, g)
        want_other = mlp.fused_trunk_bwd_plain(x, trunk, SKIPS, other, g)
        f64 = mlp.fused_trunk_bwd_plain(x.double(), [(w.double(), b.double()) for w, b in trunk], SKIPS, "float32", g)
    torch.cuda.synchronize()
    assert mlp.bwd_launches == before + 1
    rms = lambda t: t.double().pow(2).mean().sqrt()  # noqa: E731
    flat = lambda r: torch.cat([r[0].flatten()] + [t.flatten() for wb in r[1] for t in wb]).double()  # noqa: E731
    assert got[0].shape == (N, 3 + 6 * L) and rms(got[0] - want[0]) <= 0.25 * rms(got[0] - want_other[0])
    pairs = [(got[0], want[0])] + [(a, b) for (aw, ab), (bw, bb) in zip(got[1], want[1])
                                   for a, b in ((aw, bw), (ab, bb))]
    for a, b in pairs:
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert rms(a - b) <= 2e-2 * rms(b)
    assert rms(flat(got) - flat(f64)) <= 2.0 * rms(flat(want) - flat(f64))


@pytest.mark.cuda
def test_trunk_function_launches_both_kernels(cuda_device):
    """fused_trunk with a trainable input on CUDA tensors: the trunk kernel,
    then its backward from autograd, and gradients for x and every layer."""
    from upnerf_torch.ops import mlp

    _, _, _, _, _, trunk, _ = make_inputs(8, 8, cuda_device, seed=15)
    x = torch.from_numpy(np.random.RandomState(16).randn(512, 3 + 6 * L).astype(np.float32)).to(cuda_device)
    leaves = [x.requires_grad_()] + [t.requires_grad_() for wb in trunk for t in wb]
    before = (mlp.launches, mlp.bwd_launches)
    mlp.fused_trunk(x, trunk, SKIPS, "bfloat16").pow(2).sum().backward()
    torch.cuda.synchronize()
    assert (mlp.launches, mlp.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)


def heads_inputs(N, device, cand, seed=21, C=16, HC=128, F=384, depth=D, skips=SKIPS, in0=3 + 6 * L):
    """x0 rows (in0 columns), a per-row candidate embedding and the kernel-5 weights (c1 unsplit)."""
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def lin(i, o):
        b = i**-0.5
        return t(rng.uniform(-b, b, (i, o))), t(rng.uniform(-b, b, o))

    trunk = [lin(in0 if i == 0 else (in0 + W if i in skips else W), W) for i in range(depth)]
    shapes = {"sigma": (W, 1), "xyzf": (W, W), "feat": (W, F)}
    if cand:
        shapes.update(c1=(W + C, HC), c2=(HC, HC), csig=(HC, 1), cfeat=(HC, F))
    heads = {}
    for k, (i, o) in shapes.items():
        heads[k + "_w"], heads[k + "_b"] = lin(i, o)
    x0 = t(rng.randn(N, in0))
    return x0, (t(rng.randn(N, C)) if cand else None), trunk, heads


@pytest.mark.cuda
@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("cand", [True, False])
@pytest.mark.parametrize("N", [4096, 1037])
def test_heads_kernels_match_plain(cuda_device, precision, cand, N, F):
    """Kernel 5 (csrc/heads_fwd.cu, heads_bwd.cu) against its plain versions.
    Forward, max |d| over max |value|: 1e-5 (f32) / 5e-3 (bf16, as the trunk
    kernel). Backward: both sides recompute the chain in their own summation
    order, so a ReLU mask can flip in a row (chip_smoke.py: HEADS_BWD_TOL). At
    a few thousand rows one flip is a large share of a weight gradient's max
    (0.059 at 1037 rows, bf16) but not of its RMS, so every backward output is
    held by RMS: within 2e-2 of its RMS value; and the per-row dx0 and dc_emb
    are closer to the plain version of the kernel's precision than a quarter
    of their distance to the other precision's."""
    from upnerf_torch.ops import heads as hk

    x0, c_emb, trunk, heads = heads_inputs(N, cuda_device, cand, F=F)
    before = (hk.launches, hk.bwd_launches)
    with torch.no_grad():
        got = hk.fused_trunk_heads_fwd(x0, c_emb, trunk, heads, SKIPS, precision)
        want = hk.fused_trunk_heads_plain(x0, c_emb, trunk, heads, SKIPS, precision)
        g = torch.Generator(device=cuda_device).manual_seed(N)
        cots = [torch.randn(w.shape, generator=g, device=cuda_device) for w in want]
        kb = hk.fused_trunk_heads_bwd(x0, c_emb, trunk, heads, SKIPS, precision, cots)
        pb = hk.fused_trunk_heads_bwd_plain(x0, c_emb, trunk, heads, SKIPS, precision, cots)
    torch.cuda.synchronize()
    assert (hk.launches, hk.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert len(got) == (4 if cand else 2)
    ftol = 5e-3 if precision == "bfloat16" else 1e-5
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and (a - b).abs().max() <= ftol * b.abs().max()
    other = "float32" if precision == "bfloat16" else "bfloat16"
    with torch.no_grad():
        po = hk.fused_trunk_heads_bwd_plain(x0, c_emb, trunk, heads, SKIPS, other, cots)
    rms = lambda t: t.pow(2).mean().sqrt()  # noqa: E731
    for i in range(2 if cand else 1):
        assert rms(kb[i] - pb[i]) <= 0.25 * rms(kb[i] - po[i])
    pairs = [(kb[0], pb[0])] + ([(kb[1], pb[1])] if cand else [])
    pairs += [(a, b) for (aw, ab), (bw, bb) in zip(kb[2], pb[2]) for a, b in ((aw, bw), (ab, bb))]
    pairs += [(kb[3][k], pb[3][k]) for k in pb[3]]
    for a, b in pairs:
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert rms(a - b) <= 2e-2 * rms(b)


@pytest.mark.cuda
def test_heads_function_launches_both_kernels(cuda_device):
    """fused_trunk_heads on CUDA tensors: the forward kernel, then the backward
    kernel from autograd, and gradients for x0, c_emb and every weight."""
    from upnerf_torch.ops import heads as hk

    x0, c_emb, trunk, heads = heads_inputs(512, cuda_device, True)
    x0.requires_grad_(True)
    c_emb.requires_grad_(True)
    for t_ in [*heads.values()] + [t for wb in trunk for t in wb]:
        t_.requires_grad_(True)
    before = (hk.launches, hk.bwd_launches)
    outs = hk.fused_trunk_heads(x0, c_emb, trunk, heads, SKIPS, "bfloat16")
    sum(o.sum() for o in outs).backward()
    torch.cuda.synchronize()
    assert (hk.launches, hk.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in [x0, c_emb, *heads.values()])


@pytest.mark.cuda
@pytest.mark.parametrize("depth,skips", [(8, (4,)), (16, (4, 8, 12))], ids=["D8", "D16"])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["candidate", "heads", "trunk"])
@pytest.mark.parametrize("N", [1, 127, 4097])
def test_heads_backward_at_ragged_and_deep_shapes_matches_plain(cuda_device, N, mode, precision, depth, skips):
    """Kernels 5 and 6's backward (per slab: the walk storing the dW operands,
    then dw_gemm; bf16 the Hopper design) at one row, a ragged tile, a ragged
    last tile pair, and D = 16 with three skip layers: every output within
    2e-2 of its RMS by RMS distance (both sides rebuild the chain in their
    own summation order, so a ReLU mask can flip in a row); and in bf16, on
    all outputs together, no further from the float64 plain backward than
    twice the plain version's own distance (HEADS_F64_RATIO), which shows
    the kernel rounds where the plain version does. In f32 that witness
    would compare two f32 summation orders: the SIMT walk sums each
    product's terms one after another, as the parent design did, and lands
    up to ~3x further from float64 than cuBLAS's sums at these sizes (~1e-8
    of the RMS at one row, measured on one H100)."""
    from upnerf_torch.ops import heads as hk
    from upnerf_torch.ops import mlp

    x0, c_emb, trunk, heads = heads_inputs(N, cuda_device, mode == "candidate", seed=N + depth, depth=depth,
                                           skips=skips)
    g = torch.Generator(device=cuda_device).manual_seed(N)
    f64 = lambda t: None if t is None else t.double()  # noqa: E731
    with torch.no_grad():
        if mode == "trunk":
            cot = torch.randn((N, W), generator=g, device=cuda_device)
            before = mlp.bwd_launches
            kb = mlp.fused_trunk_bwd(x0, trunk, skips, precision, cot)
            pb = mlp.fused_trunk_bwd_plain(x0, trunk, skips, precision, cot)
            p64 = mlp.fused_trunk_bwd_plain(f64(x0), [(f64(w), f64(b)) for w, b in trunk], skips, "float32", cot)
            assert mlp.bwd_launches == before + 1
            flat = lambda r: [r[0]] + [t for wb in r[1] for t in wb]  # noqa: E731
        else:
            want = hk.fused_trunk_heads_plain(x0, c_emb, trunk, heads, skips, precision)
            cots = [torch.randn(w.shape, generator=g, device=cuda_device) for w in want]
            before = hk.bwd_launches
            kb = hk.fused_trunk_heads_bwd(x0, c_emb, trunk, heads, skips, precision, cots)
            pb = hk.fused_trunk_heads_bwd_plain(x0, c_emb, trunk, heads, skips, precision, cots)
            p64 = hk.fused_trunk_heads_bwd_plain(f64(x0), f64(c_emb), [(f64(w), f64(b)) for w, b in trunk],
                                                 {k: f64(v) for k, v in heads.items()}, skips, "float32",
                                                 [f64(c) for c in cots])
            assert hk.bwd_launches == before + 1
            flat = lambda r: [t for t in r[:2] if t is not None] + [t for wb in r[2] for t in wb] + [  # noqa: E731
                r[3][k] for k in sorted(r[3])]
    torch.cuda.synchronize()
    rms = lambda t: t.double().pow(2).mean().sqrt()  # noqa: E731
    for a, b in zip(flat(kb), flat(pb)):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert rms(a - b) <= 2e-2 * rms(b)
    cat = lambda r: torch.cat([t.double().flatten() for t in flat(r)])  # noqa: E731
    if precision == "bfloat16":
        assert rms(cat(kb) - cat(p64)) <= 2.0 * rms(cat(pb) - cat(p64))


# What a backward call of kernels 5 and 6 allocates besides one slab's operand buffer and bias rows
# (render_train.DW_BUFFER_BYTES) and its outputs: the packed weights, the dW kernel's split sums and its flat result.
HEADS_EXTRA_BYTES = 64 << 20


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["candidate", "trunk"])
def test_heads_backward_slab_buffer_peak_memory_and_bits(cuda_device, monkeypatch, mode, precision):
    """At 20,000 rows with the slab budget cut to force three slabs (the last
    ragged): the call allocates, above its inputs, at most the budget plus
    its outputs and HEADS_EXTRA_BYTES; its per-row outputs equal the one-slab
    call's bit for bit (rows are independent), its weight gradients within
    1e-5 of their max (the slabs add in another order); and two calls give
    the same bits."""
    from upnerf_torch.ops import heads as hk
    from upnerf_torch.ops import mlp

    N = 20000
    x0, c_emb, trunk, heads = heads_inputs(N, cuda_device, mode == "candidate", seed=61)
    g = torch.Generator(device=cuda_device).manual_seed(62)
    with torch.no_grad():
        if mode == "trunk":
            cot = torch.randn((N, W), generator=g, device=cuda_device)
            call = lambda: mlp.fused_trunk_bwd(x0, trunk, SKIPS, precision, cot)  # noqa: E731
        else:
            cots = [torch.randn(w.shape, generator=g, device=cuda_device)
                    for w in hk.fused_trunk_heads_plain(x0[:1], c_emb[:1], trunk, heads, SKIPS, precision)]
            cots = [torch.randn((N, c.shape[1]), generator=g, device=cuda_device) for c in cots]
            call = lambda: hk.fused_trunk_heads_bwd(x0, c_emb, trunk, heads, SKIPS, precision, cots)  # noqa: E731
        one = _outputs(call())
        esize = 2 if precision == "bfloat16" else 4
        C = 0 if mode == "trunk" else c_emb.shape[1]
        lay = hk.heads_dw_layout(D, SKIPS, W, 384, 128 if C else 0, C, mode != "trunk")
        per_row = lay.ops_w * esize + lay.nb * 4 / 32
        monkeypatch.setattr(rt, "DW_BUFFER_BYTES", int(7000 * per_row))
        assert hk.heads_slab_rows(lay, N, esize) == 6912
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda_device)
        torch.cuda.reset_peak_memory_stats(cuda_device)
        a = _outputs(call())
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(cuda_device) - base
        b = _outputs(call())
    torch.cuda.synchronize()
    outs = sum(t.numel() * t.element_size() for t in a)
    print(f"{mode} {precision}: peak {peak / 2**20:.1f} MiB above the inputs (budget {rt.DW_BUFFER_BYTES / 2**20:.1f}"
          f" MiB, outputs {outs / 2**20:.1f} MiB)")
    assert peak <= rt.DW_BUFFER_BYTES + outs + HEADS_EXTRA_BYTES
    n_rows = 2 if mode == "candidate" else 1
    for x, y in zip(a[:n_rows], one[:n_rows]):
        assert torch.equal(x, y)
    for x, y in zip(a[n_rows:], one[n_rows:]):
        assert torch.isfinite(x).all() and (x - y).abs().max() <= 1e-5 * y.abs().max()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("S", SAMPLES)
@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_static_render_kernel_matches_plain_and_serving_mode(cuda_device, precision, F, S):
    """Kernel 4 (the x0 mode of csrc/render_train_fwd.cu) against its plain
    version (cumprod transmittance) and against the serving mode on the same
    rays (PE built in the kernel), with the serving tolerances above."""
    from upnerf_torch.ops import render as srk

    o, d, z, pe_w, cond, trunk, heads = make_inputs(296, S, cuda_device, seed=5, F=F)
    st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=L, precision=precision)
    x0, _ = rt._pe(o, d, z, pe_w, L)
    before = (srk.launches, rt.launches)
    with torch.no_grad():
        rgb, dep, w = srk.fused_static_render_fwd(x0, z, cond, trunk, heads, SKIPS, precision)
        prgb, pdep, pw = srk.fused_static_render_plain(x0, z, cond, trunk, heads, SKIPS, precision)
        serve = rt.render_train_rays_fwd(o, d, z, pe_w, cond, trunk, heads, st)
    torch.cuda.synchronize()
    assert (srk.launches, rt.launches) == (before[0] + 1, before[1] + 1)
    tol = TOL[precision]
    for a, b in ((rgb, prgb), (w, pw), (rgb, serve["rgb_map"]), (w, serve["s_weights"])):
        torch.testing.assert_close(a, b, rtol=0, atol=tol)
    torch.testing.assert_close(dep, pdep, rtol=tol, atol=0)
    torch.testing.assert_close(dep[:, 0], serve["s_depth"], rtol=tol, atol=0)


def recompute_inputs(R, S, device, phase, precision, seed, F=384, store_f32=True):
    """A mode's inputs (phase 0/1 via train_inputs, phase 2 the rgb mode) with
    RTStatic in the recompute mode (save_chain=False)."""
    if phase == 2:
        o, d, z, pe_w, cond, trunk, heads = make_inputs(R, S, device, seed, F)
        st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=L, precision=precision)
        args, c_emb = (o, d, z, pe_w, cond, trunk, heads, st), None
    else:
        args, c_emb = train_inputs(R, S, device, phase, precision, seed, F)
    st = args[-1]._replace(save_chain=False, store_f32=store_f32)
    return (*args[:-1], st), c_emb


@pytest.mark.cuda
@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("precision,store_f32", [("float32", True), ("bfloat16", True), ("bfloat16", False)])
@pytest.mark.parametrize("phase", [0, 1, 2])
@pytest.mark.parametrize("S", SAMPLES)
def test_recompute_forward_matches_plain(cuda_device, precision, store_f32, phase, F, S):
    """The forward's residuals without a chain (sig_s, sig_c, feat, c_feat,
    rgb) and its outputs against the plain version: outputs as
    test_train_forward_matches_plain; feat / c_feat within 1e-5 (f32), 5e-3
    (bf16 products, f32 store: the trunk's bf16 rounding flips reach a single
    sample unaveraged) or 1e-2 (bf16 store: also one bf16 ulp of the value)
    of their max (and rgb, which bf16 store also rounds)."""
    args, c_emb = recompute_inputs(200, S, cuda_device, phase, precision, seed=11, F=F, store_f32=store_f32)
    st = args[-1]
    before = (rt.launches, rt.recompute_launches)
    with torch.no_grad():
        got, got_res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
        want, want_res = rt.render_train_rays_plain(*args, c_emb=c_emb, save_res=True)
    torch.cuda.synchronize()
    assert (rt.launches, rt.recompute_launches) == (before[0], before[1] + 1)
    assert tuple(got_res) == st.res_keys and "chain" not in got_res
    tol = TOL[precision]
    for k in st.out_keys:
        torch.testing.assert_close(got[k], want[k], rtol=tol if "depth" in k else 0, atol=0 if "depth" in k else tol)
    ftol = 1e-5 if precision == "float32" else (5e-3 if store_f32 else 1e-2)
    for k in st.res_keys:
        assert got_res[k].dtype == want_res[k].dtype and got_res[k].shape == want_res[k].shape, k
        a, b = got_res[k].float(), want_res[k].float()
        assert torch.isfinite(a).all(), k
        if k in ("feat", "cfeat") or (k == "rgb" and not store_f32):  # rgb is rounded with feat
            assert (a - b).abs().max() <= ftol * b.abs().max(), k
        else:
            torch.testing.assert_close(a, b, rtol=tol, atol=tol)


def _rms(t):
    return t.double().pow(2).mean().sqrt().item()


@pytest.mark.cuda
@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase", [0, 1, 2])
def test_recompute_backward_matches_plain(cuda_device, precision, phase, F):
    """The recompute backward (train mode) against the plain recompute
    backward, and its frozen mode against the train mode. It rebuilds the
    chain in its own summation order, so a ReLU pre-activation within
    rounding of zero can flip against the plain version's, and one sample's
    cotangent through that unit switches on or off (at 256 rays one flip moves
    a trunk dW by ~1e-4 of its max in f32): weight gradients within 1e-3
    (f32) / 1e-2 (bf16) of their max; the per-ray data cotangents by RMS
    (within 2e-2 of their RMS); both no further from the float64 plain
    backward than 2x the plain version's own distance. The frozen mode's data
    cotangents equal the train mode's bit for bit."""
    args, c_emb = recompute_inputs(256, 128, cuda_device, phase, precision, seed=13, F=F)
    st = args[-1]
    with torch.no_grad():
        out, res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
        g = torch.Generator(device=cuda_device).manual_seed(2)
        cots = {k: torch.randn(v.shape, generator=g, device=cuda_device) for k, v in out.items()}
        counts = lambda: (rt.bwd_launches, rt.frozen_bwd_launches, rt.recompute_bwd_launches,  # noqa: E731
                          rt.recompute_frozen_bwd_launches)
        before = counts()
        got = rt.render_train_rays_bwd(*args[:7], st, c_emb, res, cots)
        frozen = rt.render_train_rays_bwd(*args[:7], st._replace(param_grads=False), c_emb, res, cots)
        want = rt.render_train_rays_bwd_plain(*args[:7], st, c_emb, res, cots)
        f64 = lambda t: None if t is None else t.double()  # noqa: E731
        o, d, z, pe_w, cond, trunk, heads = args[:7]
        p64 = rt.render_train_rays_bwd_plain(
            f64(o), f64(d), f64(z), f64(pe_w), f64(cond), [(f64(w), f64(b)) for w, b in trunk],
            {k: f64(v) for k, v in heads.items()}, st._replace(precision="float32"), f64(c_emb),
            {k: f64(v) for k, v in res.items()}, {k: f64(v) for k, v in cots.items()})
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1], before[2] + 1, before[3] + 1)
    tol = 1e-2 if precision == "bfloat16" else 1e-3
    for (aw, ab), (bw, bb) in zip(got[4], want[4]):
        for a, b in ((aw, bw), (ab, bb)):
            assert torch.isfinite(a).all() and (a - b).abs().max() <= tol * b.abs().max()
    for k in st.head_keys:
        a, b = got[5][k], want[5][k].reshape(got[5][k].shape)
        assert torch.isfinite(a).all() and (a - b).abs().max() <= tol * b.abs().max(), k
    flat = lambda r: torch.cat([t.double().flatten() for wb in r[4] for t in wb]  # noqa: E731
                               + [r[5][k].double().flatten() for k in st.head_keys])
    assert _rms(flat(got) - flat(p64)) <= 2.0 * _rms(flat(want) - flat(p64))
    assert frozen[4] is None and frozen[5] is None
    for a, fz, b, b64 in zip(got[:4], frozen[:4], want[:4], p64[:4]):
        if b is None:
            assert a is None and fz is None
            continue
        assert torch.isfinite(a).all() and torch.equal(a, fz)
        assert _rms(a - b) <= 2e-2 * _rms(b)
        assert _rms(a - b64) <= 2.0 * max(_rms(b - b64), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase", [1, 2])
def test_recompute_backward_matches_saved_chain_kernel(cuda_device, precision, phase):
    """The recompute backward against the saved-chain backward on the same
    inputs and cotangents (each on its own forward's residuals): the kernel
    rebuilds the forward kernel's chain bit for bit, so every output is within
    1e-4 (f32) / 1e-2 (bf16) of its max, as the saved-chain backward against
    its plain version; and the recompute path through RenderTrainRays launches
    one forward and one backward, each counted as the recompute mode's."""
    args, c_emb = recompute_inputs(128, 128, cuda_device, phase, precision, seed=17)
    st = args[-1]
    saved_st = st._replace(save_chain=True)
    with torch.no_grad():
        out, res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
        out_s, res_s = rt.render_train_rays_fwd(*args[:7], saved_st, c_emb=c_emb, save_res=True)
        for k in st.out_keys:  # one forward, two residual sets (f32 mode's feature map sums by atomics)
            torch.testing.assert_close(out[k], out_s[k], rtol=1e-5, atol=1e-6)
        g = torch.Generator(device=cuda_device).manual_seed(4)
        cots = {k: torch.randn(v.shape, generator=g, device=cuda_device) for k, v in out.items()}
        got = rt.render_train_rays_bwd(*args[:7], st, c_emb, res, cots)
        ref = rt.render_train_rays_bwd(*args[:7], saved_st, c_emb, res_s, cots)
    torch.cuda.synchronize()
    tol = 1e-2 if precision == "bfloat16" else 1e-4
    for a, b in zip(got[:4], ref[:4]):
        if b is not None:
            assert (a - b).abs().max() <= tol * b.abs().max()
    for (aw, ab), (bw, bb) in zip(got[4], ref[4]):
        assert (aw - bw).abs().max() <= tol * bw.abs().max() and (ab - bb).abs().max() <= tol * bb.abs().max()
    o, d, z, pe_w, cond, trunk, heads = args[:7]
    o = o.clone().requires_grad_()
    before = (rt.recompute_launches, rt.recompute_bwd_launches)
    outs = rt.render_train_rays(o, d, z, pe_w, cond, trunk, heads, st, c_emb=c_emb)
    sum(v.sum() for v in outs.values()).backward()
    torch.cuda.synchronize()
    assert (rt.recompute_launches, rt.recompute_bwd_launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(o.grad).all() and o.grad.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("S", [48, 64, 128])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_train_forward_at_one_and_three_rays_matches_plain(cuda_device, precision, S, R):
    """The forward with the chain at the ray counts of the recompute route's
    smallest slabs: one ray (fewer than the grid's blocks; at S <= 64 a tile
    whose second ray does not exist) and three (an odd count)."""
    args, c_emb = train_inputs(R, S, cuda_device, 1, precision, seed=47)
    check_train_forward(args, c_emb, precision)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_recompute_route_in_slabs_equals_one_slab(cuda_device, precision, S):
    """The recompute backward (phase 1) at 256 rays as its route runs it with
    slabs of 1, 3 and 100 rays (the last ragged): each slab's chain rebuilt by
    the forward, walked, and its dW summed by the dW kernel (both
    precisions). The data cotangents equal the default call's (one slab; two
    in f32 at S = 128) bit for bit (every ray is walked alone, on the same
    chain rows), and the frozen mode's equal the train mode's; the weight
    gradients, the same products summed in another order, are within 1e-4
    of each one's max of the default call's (BWD_TOL's f32 bound), and two
    calls at a slab size give the same bits. The
    plain recompute backward holds the one-slab call
    (test_recompute_backward_matches_plain)."""
    from upnerf_torch.ops import dw_gemm as dg

    args, c_emb = recompute_inputs(256, S, cuda_device, 1, precision, seed=49)
    st = args[-1]
    o, d, z, pe_w, cond, trunk, heads = args[:7]
    with torch.no_grad():
        out, res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
        g = torch.Generator(device=cuda_device).manual_seed(50)
        cots = {k: torch.randn(v.shape, generator=g, device=cuda_device) for k, v in out.items()}
        one = rt.render_train_rays_bwd(o, d, z, pe_w, cond, trunk, heads, st, c_emb, res, cots)

        def route(s, slab):
            call = rt.render_train_rays_bwd_launch(o, d, z, pe_w, cond, trunk, heads, s, c_emb, res, cots)
            # the buffers hold the default slab: all 256 rays, or in the f32 train mode at S = 128 (operands of
            # 4 bytes) 132
            wide = precision == "float32" and S == 128 and s.param_grads
            assert call.slab == (132 if wide else 256) and slab <= call.slab
            call.slab = slab
            (d_o, d_d), *rest = call.run()
            return d_o, d_d, *rest

        got = {}
        for slab in (1, 3, 100):
            before = (rt.rebuild_launches, dg.dw_launches)
            got[slab] = [route(st, slab), route(st._replace(param_grads=False), slab)]
            n = -(-256 // slab)
            assert (rt.rebuild_launches - before[0], dg.dw_launches - before[1]) == (2 * n, n)
            got[slab].append(route(st, slab))
    torch.cuda.synchronize()
    for slab, (train, frozen, *again) in got.items():
        for a, b, fz in zip(train[:4], one[:4], frozen[:4]):
            if b is None:
                assert a is None and fz is None
            else:
                assert torch.equal(a, b) and torch.equal(a, fz), slab
        flat = [t for wb in train[4] for t in wb] + [train[5][k] for k in st.head_keys]
        ref = [t for wb in one[4] for t in wb] + [one[5][k] for k in st.head_keys]
        for a, b in zip(flat, ref):
            assert torch.isfinite(a).all() and (a - b).abs().max() <= 1e-4 * b.abs().max(), slab
        if again:
            assert all(torch.equal(x, y) for x, y in zip(_outputs(train), _outputs(again[0]))), slab


@pytest.mark.cuda
@pytest.mark.parametrize("phase", [1, 2])
def test_recompute_backward_peak_memory_within_its_budget(cuda_device, phase):
    """At 1024 rays x 256 samples (several slabs), bf16: a recompute backward
    call allocates, above its inputs, at most REC_BUFFER_BYTES (one slab's
    rebuilt chain and operand buffers) plus its outputs and REC_EXTRA_BYTES
    (both kernels' packed weights, the dW kernel's split sums, the forward's
    per-slab scratch and dropped outputs)."""
    args, c_emb = recompute_inputs(1024, 256, cuda_device, phase, "bfloat16", seed=51)
    st = args[-1]
    with torch.no_grad():
        out, res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
        g = torch.Generator(device=cuda_device).manual_seed(52)
        cots = {k: torch.randn(v.shape, generator=g, device=cuda_device) for k, v in out.items()}
        for s in (st, st._replace(param_grads=False)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(cuda_device)
            torch.cuda.reset_peak_memory_stats(cuda_device)
            got = rt.render_train_rays_bwd(*args[:7], s, c_emb, res, cots)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(cuda_device) - base
            outs = sum(t.numel() * t.element_size() for t in _outputs(got))
            print(f"phase {phase} {'train' if s.param_grads else 'frozen'}: peak {peak / 2**20:.1f} MiB above the"
                  f" inputs, outputs {outs / 2**20:.1f} MiB")
            assert peak <= rt.REC_BUFFER_BYTES + outs + REC_EXTRA_BYTES
            del got


def x0_args(args, in0=None, seed=0):
    """The x0 frontend's arguments (x0, z, ray_cond, trunk, heads, st) from a
    rays mode's: the PE rows of the rays (in0 = 3 + 6L), or seeded rows of
    width in0 with the trunk's x0 rows cut to it (layer 0 and the skips)."""
    o, d, z, pe_w, cond, trunk, heads, st = args
    x0 = rt._pe(o, d, z, pe_w, L)[0].contiguous()
    if in0 is not None:
        g = torch.Generator(device=x0.device).manual_seed(seed)
        x0 = torch.randn((x0.shape[0], in0), generator=g, device=x0.device) * 0.5
        full = 3 + 6 * L
        trunk = [(w[:in0].contiguous() if i == 0 else torch.cat([w[:in0], w[full:]]) if i in SKIPS else w, b)
                 for i, (w, b) in enumerate(trunk)]
    return x0, z, cond, trunk, heads, st._replace(xyz_L=0)


@pytest.mark.cuda
@pytest.mark.parametrize("in0", [None, 40], ids=["pe", "in0_40"])
@pytest.mark.parametrize("save_chain", [True, False], ids=["chain", "recompute"])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase", [0, 1, 2])
@pytest.mark.parametrize("S", SAMPLES)
def test_x0_forward_and_backward_match_plain(cuda_device, phase, precision, save_chain, in0, S):
    """Kernel 1b: the forward with residuals and the d_x0 backward (train and
    frozen modes) from PE rows, against render_train_plain /
    render_train_bwd_plain, at the PE width 63 and at in0 = 40 (not 3 + 6L).
    Forward and residuals as the rays modes; the backward on the saved chain
    within 1e-4 (f32) / 1e-2 (bf16) of each output's max; the recompute
    backward against the plain recompute by the float64 witness (weight
    gradients together; per-row d_x0 and the per-ray cotangents each, with
    their RMS within 2e-2): ReLU masks flip between the two summation orders,
    and at 256 x 128 samples one flip moves a bf16 weight gradient by up to
    ~1.8e-2 of its max, while the witness reads 0.98-1.02 (measured on the
    card); its weight gradients against the saved-chain kernel's by the max
    at the saved chain's tolerance (the kernel rebuilds the forward kernel's
    chain bit for bit: 1e-6 to 3e-4 there). The frozen mode's data cotangents
    equal the train mode's bit for bit. The forward runs at every S of
    SAMPLES (S = 100: a ragged last tile); the backward at S = 100 on the saved
    chain (a ragged last tile of the d_x0 store) and 128 in the recompute mode,
    where these checks were made: the float64 witness compares the kernel's
    f32 chain and PyTorch's, and where a ReLU mask flips between the two (at S
    = 100 in f32, in the candidate branch) the kernel reads 7-9x the plain
    version's distance from float64 while it equals the saved-chain kernel
    within run-to-run noise (test_f32_recompute_backward_at_a_ragged_s_is_the_
    saved_chain_kernels). With the PE rows, the outputs also meet the rays
    mode's kernel."""
    with_bwd = S == (100 if save_chain else 128)
    if phase == 2:
        args, c_emb = (*make_inputs(256, S, cuda_device, seed=21), rt.RTStatic(D=D, skips=SKIPS, xyz_L=L,
                                                                                  precision=precision)), None
    else:
        args, c_emb = train_inputs(256, S, cuda_device, phase, precision, seed=21)
    args = (*args[:-1], args[-1]._replace(save_chain=save_chain))
    x0, z, cond, trunk, heads, st = x0_args(args, in0, seed=22)
    before = (rt.x0_launches, rt.x0_bwd_launches, rt.launches, rt.bwd_launches)
    with torch.no_grad():
        got, got_res = rt.render_train_fwd(x0, z, cond, trunk, heads, st, c_emb=c_emb, save_res=True)
        want, want_res = rt.render_train_plain(x0, z, cond, trunk, heads, st, c_emb=c_emb, save_res=True)
        rays = rt.render_train_rays_fwd(*args, c_emb=c_emb) if in0 is None else None
    torch.cuda.synchronize()
    tol = TOL[precision]
    for k in st.out_keys:
        assert torch.isfinite(got[k]).all(), k
        if "depth" in k:
            torch.testing.assert_close(got[k], want[k], rtol=tol, atol=0)
        else:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=tol)
        if rays is not None:
            torch.testing.assert_close(got[k], rays[k], rtol=tol, atol=tol)
    store_tol = 1e-2 if precision == "bfloat16" else 1e-5  # the chain, feat, c_feat: stored rounded in bf16
    for k in st.res_keys:
        rtol = store_tol if k in ("chain", "feat", "cfeat") else tol
        assert (got_res[k].float() - want_res[k].float()).abs().max() <= rtol * want_res[k].float().abs().max(), k
    if not with_bwd:
        assert (rt.x0_launches, rt.x0_bwd_launches) == (before[0] + 1, before[1])
        return
    with torch.no_grad():
        g = torch.Generator(device=cuda_device).manual_seed(23)
        cots = {k: torch.randn(v.shape, generator=g, device=cuda_device) for k, v in want.items()}
        kb = rt.render_train_bwd(x0, z, cond, trunk, heads, st, c_emb, got_res, cots)
        kz = rt.render_train_bwd(x0, z, cond, trunk, heads, st._replace(param_grads=False), c_emb, got_res, cots)
        pb = rt.render_train_bwd_plain(x0, z, cond, trunk, heads, st, c_emb, got_res, cots)
        f64 = lambda t: None if t is None else t.double()  # noqa: E731
        p64 = rt.render_train_bwd_plain(f64(x0), f64(z), f64(cond), [(f64(w), f64(b)) for w, b in trunk],
                                        {k: f64(v) for k, v in heads.items()}, st._replace(precision="float32"),
                                        f64(c_emb), {k: f64(v) for k, v in got_res.items()},
                                        {k: f64(v) for k, v in cots.items()})
    torch.cuda.synchronize()
    assert (rt.x0_launches, rt.x0_bwd_launches, rt.launches, rt.bwd_launches) == (
        before[0] + 1, before[1] + 2, before[2] + (in0 is None), before[3])  # the plain versions launch nothing
    assert kb[0].shape == x0.shape and kz[3] is None and kz[4] is None
    for a, fz in zip(kb[:3], kz[:3]):
        assert (a is None and fz is None) or torch.equal(a, fz)
    btol = 1e-2 if precision == "bfloat16" else 1e-4
    if not save_chain:  # the weight gradients against the saved-chain kernel's
        with torch.no_grad():
            sst = st._replace(save_chain=True)
            _, sres = rt.render_train_fwd(x0, z, cond, trunk, heads, sst, c_emb=c_emb, save_res=True)
            ref = rt.render_train_bwd(x0, z, cond, trunk, heads, sst, c_emb, sres, cots)
    else:
        ref = pb
    for (aw, ab), (bw, bb) in zip(kb[3], ref[3]):
        for a, b in ((aw, bw), (ab, bb)):
            assert torch.isfinite(a).all() and (a - b).abs().max() <= btol * b.abs().max()
    for k in st.head_keys:
        a, b = kb[4][k], ref[4][k].reshape(kb[4][k].shape)
        assert torch.isfinite(a).all() and (a - b).abs().max() <= btol * b.abs().max(), k
    if not save_chain:
        flat = lambda r: torch.cat([t.double().flatten() for wb in r[3] for t in wb]  # noqa: E731
                                   + [r[4][k].double().flatten() for k in st.head_keys])
        assert _rms(flat(kb) - flat(p64)) <= 2.0 * _rms(flat(pb) - flat(p64))
    for a, b, b64 in zip(kb[:3], pb[:3], p64[:3]):
        if b is None:
            assert a is None
            continue
        assert torch.isfinite(a).all()
        if save_chain:
            assert (a - b).abs().max() <= btol * b.abs().max()
        else:
            assert _rms(a - b) <= 2e-2 * _rms(b)
            assert _rms(a - b64) <= 2.0 * max(_rms(b - b64), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", [0, 1])
def test_f32_recompute_backward_at_a_ragged_s_is_the_saved_chain_kernels(cuda_device, phase):
    """At S = 100 (a ragged last tile) the f32 recompute backward's gradients
    equal the saved-chain backward's to within the run-to-run noise of their
    atomic adds (1e-6 of the gradients' RMS; measured ~3e-7), so its larger
    distance from the float64 witness there is the witness's (a ReLU mask
    that flips between the kernel's f32 chain and PyTorch's), not a masking
    fault of the ragged tile. Prints the distances."""
    args, c_emb = train_inputs(256, 100, cuda_device, phase, "float32", seed=21)
    grads, flats = {}, {}
    for chain in (False, True):
        x0, z, cond, trunk, heads, st = x0_args((*args[:-1], args[-1]._replace(save_chain=chain)), 40, seed=22)
        with torch.no_grad():
            _, res = rt.render_train_fwd(x0, z, cond, trunk, heads, st, c_emb=c_emb, save_res=True)
            want, _ = rt.render_train_plain(x0, z, cond, trunk, heads, st, c_emb=c_emb, save_res=True)
            g = torch.Generator(device=cuda_device).manual_seed(23)
            cots = {k: torch.randn(v.shape, generator=g, device=cuda_device) for k, v in want.items()}
            grads[chain] = [rt.render_train_bwd(x0, z, cond, trunk, heads, st, c_emb, res, cots) for _ in range(2)]
            grads[chain].append(rt.render_train_bwd_plain(x0, z, cond, trunk, heads, st, c_emb, res, cots))
            f64 = lambda t: None if t is None else t.double()  # noqa: E731
            grads[chain].append(rt.render_train_bwd_plain(
                f64(x0), f64(z), f64(cond), [(f64(w), f64(b)) for w, b in trunk], {k: f64(v) for k, v in heads.items()},
                st, f64(c_emb), {k: f64(v) for k, v in res.items()}, {k: f64(v) for k, v in cots.items()}))
        flats[chain] = [torch.cat([t.double().flatten() for wb in r[3] for t in wb]
                                  + [r[4][k].double().flatten() for k in st.head_keys]) for r in grads[chain]]
    torch.cuda.synchronize()
    for chain in (False, True):
        k1, k2, p, p64 = flats[chain]
        print(f"f32 phase {phase} S=100 {'saved chain' if chain else 'recompute'}: kernel - f64 {_rms(k1 - p64):.3e},"
              f" plain - f64 {_rms(p - p64):.3e}, run to run {_rms(k1 - k2):.3e}")
    gap = _rms(flats[False][0] - flats[True][0])
    print(f"f32 phase {phase} S=100: recompute - saved chain {gap:.3e} of RMS {_rms(flats[True][3]):.3e}")
    assert gap <= 1e-6 * _rms(flats[True][3])


@pytest.mark.cuda
def test_render_train_function_launches_both_x0_kernels(cuda_device):
    args, c_emb = train_inputs(64, 128, cuda_device, 1, "bfloat16", seed=25)
    x0, z, cond, trunk, heads, st = x0_args(args)
    x0 = x0.requires_grad_()
    leaves = [x0, cond.requires_grad_(), trunk[0][0].requires_grad_(), heads["c1c_w"].requires_grad_()]
    before = (rt.x0_launches, rt.x0_bwd_launches)
    out = rt.render_train(x0, z, cond, trunk, heads, st, c_emb=c_emb)
    (out["feat_map"].sum() + out["rgb_map"].sum() + out["s_depth"].sum()).backward()
    torch.cuda.synchronize()
    assert (rt.x0_launches, rt.x0_bwd_launches) == (before[0] + 1, before[1] + 1)
    for t in leaves:
        assert t.grad is not None and torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
    with pytest.raises(ValueError, match="x0 width"):
        rt.render_train_fwd(torch.zeros((x0.shape[0], 65), device=cuda_device), z, cond, trunk, heads, st,
                            c_emb=c_emb)


@pytest.mark.cuda
@pytest.mark.parametrize("S", SAMPLES)
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_static_render_kernel_takes_any_x0_width(cuda_device, precision, S):
    """Kernel 4 at in0 = 8 (not 3 + 6L) against its plain version."""
    from upnerf_torch.ops import render as srk

    args = (*make_inputs(96, S, cuda_device, seed=27), rt.RTStatic(D=D, skips=SKIPS, xyz_L=L, precision=precision))
    x0, z, cond, trunk, heads, _ = x0_args(args, in0=8, seed=28)
    before = srk.launches
    with torch.no_grad():
        got = srk.fused_static_render_fwd(x0, z, cond, trunk, heads, SKIPS, precision)
        want = srk.fused_static_render_plain(x0, z, cond, trunk, heads, SKIPS, precision)
    torch.cuda.synchronize()
    assert srk.launches == before + 1
    tol = TOL[precision]
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=tol)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=tol)
    torch.testing.assert_close(got[1], want[1], rtol=tol, atol=0)


def _probe(mp, x, w, b, chain, copies, design):
    """The route (mxu_probe, which counts its launch) for the Hopper design, the
    launch function for the mma.sync variant."""
    if design == "wgmma":
        before = mp.launches[chain]
        got = mp.mxu_probe(x, w, b, chain, copies)
        assert mp.launches[chain] == before + 1
        return got
    return mp.mxu_probe_launch(x, w, b, chain, copies, design=design)


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("chain", ["pure", "epi", "int8"])
def test_mxu_probe_kernel_matches_plain(cuda_device, chain, design):
    """The probe's chains at a ragged M (300 rows, 5 tiles), L = 6, 3 copies,
    in both designs (mxu_probe.PROBE_DESIGNS): int8 bit for bit (exact int32
    sums, the same requantisation); bf16 by RMS within 1e-3 of the plain
    chain's RMS (another summation order flips a rare bf16 rounding, which the
    next layers carry)."""
    from upnerf_torch.ops import mxu_probe as mp

    x, ws, b, ws_i8 = (torch.from_numpy(a).to(cuda_device) for a in mp.probe_inputs(300, 256, 6, seed=1))
    w = ws_i8 if chain == "int8" else ws
    with torch.no_grad():
        got = _probe(mp, x, w, b, chain, 3, design)
        want = mp.mxu_probe_plain(x, w, b, chain)
    torch.cuda.synchronize()
    assert got.shape == (300, 256) and torch.isfinite(got).all()
    if chain == "int8":
        assert torch.equal(got, want)
    else:
        assert _rms(got - want) <= 1e-3 * _rms(want)


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("chain", ["pure", "epi", "int8"])
@pytest.mark.parametrize("M, copies", [(1, 1), (63, 3), (64 * 265, 1)], ids=["M1", "M63x3", "M16960"])
def test_mxu_probe_ragged_rows_and_idle_consumers(cuda_device, chain, design, M, copies):
    """Rows below one tile (M = 1, 63), tile counts that leave the last item's
    second consumer without a tile (1 and 3 tiles), and 265 tiles, 133 items
    on 132 SMs: one block takes two items, the others one, and the last
    item's second consumer has none. L = 2; tolerances as above."""
    from upnerf_torch.ops import mxu_probe as mp

    x, ws, b, ws_i8 = (torch.from_numpy(a).to(cuda_device) for a in mp.probe_inputs(M, 256, 2, seed=2))
    w = ws_i8 if chain == "int8" else ws
    with torch.no_grad():
        got = _probe(mp, x, w, b, chain, copies, design)
        want = mp.mxu_probe_plain(x, w, b, chain)
    torch.cuda.synchronize()
    assert got.shape == (M, 256) and torch.isfinite(got).all()
    if chain == "int8":
        assert torch.equal(got, want)
    else:
        assert _rms(got - want) <= 1e-3 * _rms(want)


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("chain", ["pure", "epi", "int8"])
def test_mxu_probe_two_calls_equal_bits(cuda_device, chain, design):
    """Two calls on the same inputs (2048 rows, L = 16, 4 copies) give the same
    bits: every sum runs in a fixed order."""
    from upnerf_torch.ops import mxu_probe as mp

    x, ws, b, ws_i8 = (torch.from_numpy(a).to(cuda_device) for a in mp.probe_inputs(2048, 256, 16, seed=3))
    w = ws_i8 if chain == "int8" else ws
    packed = mp.kernel_weights(w, chain, design)
    with torch.no_grad():
        a, c = (mp.mxu_probe_launch(x, w, b, chain, 4, packed, design) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, c)


# The weight-gradient kernel (csrc/dw_gemm.cu) and the two-kernel bf16 train backward.
DW_TOL = 1e-5  # f32 sums of the same bf16 products in another order, over up to 70,001 rows: of the max |dW|


def _dw_sources(rows, widths, device, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(rows, w).astype(np.float32)).to(device).bfloat16() for w in widths]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [100, 1000, 70001])
@pytest.mark.parametrize("k_in", [64, 128, 256, 384])
def test_dw_gemm_matches_plain_and_repeats_bit_for_bit(cuda_device, k_in, rows):
    """Every (K_in, N) the backward gives the kernel: X strips of 64-384
    columns against G strips of 128, 256 and 384 columns and the narrow
    cotangents (3 or 1 columns of a 64-column block), with a source of 1,280
    columns as the saved chain (strips at offsets), sample counts that are not
    multiples of 64 or 128 (rows past the end load as zeros), bias rows, and a
    second call that adds to the first; against the plain version, and two
    calls bit for bit."""
    from upnerf_torch.ops import dw_gemm as dg

    chain, ops = _dw_sources(rows, (1280, 1024), cuda_device, seed=k_in + rows)
    jobs, off = [], 0
    for g_col, g_cols, g0, n_out in ((0, 128, 0, 128), (128, 256, 0, 256), (384, 384, 0, 384), (768, 64, 0, 3),
                                     (768, 64, 3, 1), (768, 64, 4, 1)):
        jobs.append(dg.DwJob(0, 256, k_in, 1, g_col, g_cols, g0, n_out, k_in, off, n_out))
        off += k_in * n_out
    jobs.append(dg.DwJob(1, 832, 64, 0, 0, 256, 0, 256, 40, off, 256))  # x from the operand source, 40 rows kept
    n_dw = off + 40 * 256
    nb = 777
    bias = torch.from_numpy(np.random.RandomState(rows).randn(300, nb).astype(np.float32)).to(cuda_device)
    outs = []
    before = dg.dw_launches
    for _ in range(2):
        out = torch.empty(n_dw + nb, device=cuda_device)
        dg.dw_gemm([chain, ops, None], jobs, out, n_dw, bias, False)
        dg.dw_gemm([chain, ops, None], jobs, out, n_dw, bias, True)
        outs.append(out)
    want = dg.dw_gemm_plain([chain, ops, None], jobs, torch.empty(n_dw + nb, device=cuda_device), n_dw, bias, False)
    torch.cuda.synchronize()
    assert dg.dw_launches == before + 4
    assert torch.equal(outs[0], outs[1])
    got = outs[0] / 2
    assert torch.isfinite(got).all()
    for j in jobs:
        a = got[j.out_off : j.out_off + j.m_out * j.ldo]
        b = want[j.out_off : j.out_off + j.m_out * j.ldo]
        assert (a - b).abs().max() <= DW_TOL * b.abs().max(), j
    assert (got[n_dw:] - want[n_dw:]).abs().max() <= DW_TOL * want[n_dw:].abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [100, 1000, 70001])
def test_dw_gemm_f32_instance_matches_float64_and_repeats_bit_for_bit(cuda_device, rows):
    """The float32 instance (f32 sources: the walks' float32 modes) on the
    bf16 test's jobs: within 1e-5 of each gradient's max of the float64
    products (a TF32 product would miss by ~1e-3), bias sums likewise, and
    two calls bit for bit."""
    from upnerf_torch.ops import dw_gemm as dg

    rng = np.random.RandomState(rows)
    chain, ops = (torch.from_numpy(rng.randn(rows, w).astype(np.float32)).to(cuda_device) for w in (1280, 1024))
    jobs, off = [], 0
    for g_col, g_cols, g0, n_out in ((0, 128, 0, 128), (128, 256, 0, 256), (384, 384, 0, 384), (768, 64, 3, 1)):
        jobs.append(dg.DwJob(0, 256, 128, 1, g_col, g_cols, g0, n_out, 128, off, n_out))
        off += 128 * n_out
    bias = torch.from_numpy(rng.randn(300, 77).astype(np.float32)).to(cuda_device)
    before = dg.dw_launches
    outs = [dg.dw_gemm([chain, ops, None], jobs, torch.empty(off + 77, device=cuda_device), off, bias, False)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert dg.dw_launches == before + 2 and torch.equal(outs[0], outs[1])
    c, o = chain.double(), ops.double()
    for j in jobs:
        want = c[:, j.x_col : j.x_col + j.m_out].t() @ o[:, j.g_col + j.g0 : j.g_col + j.g0 + j.n_out]
        got = outs[0][j.out_off : j.out_off + j.m_out * j.ldo].view(j.m_out, j.ldo)[:, : j.n_out].double()
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), j
    assert (outs[0][off:].double() - bias.double().sum(0)).abs().max() <= 1e-5 * bias.abs().sum(0).max()


@pytest.mark.cuda
@pytest.mark.parametrize("x0_mode", [False, True], ids=["rays", "x0"])
@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("phase", [0, 1, 2])
def test_bf16_train_backward_in_slabs_repeats_bit_for_bit(cuda_device, phase, F, x0_mode, monkeypatch):
    """The bf16 saved-chain train backward at 256 rays in slabs of 100 (the
    operand budget cut to force three, the last ragged): two calls give the
    same bits in every output, dW included; the walk's data cotangents equal
    the one-slab call's and the frozen mode's bit for bit; and every output
    meets the plain backward within 1e-2 of its max, as
    test_backward_matches_plain holds the one-slab call."""
    if phase == 2:
        o, d, z, pe_w, cond, trunk, heads = make_inputs(256, 128, cuda_device, seed=13, F=F)
        args, c_emb = (o, d, z, pe_w, cond, trunk, heads, rt.RTStatic(D=D, skips=SKIPS, xyz_L=L,
                                                                      precision="bfloat16")), None
    else:
        args, c_emb = train_inputs(256, 128, cuda_device, phase, "bfloat16", seed=13, F=F)
    o, d, z, pe_w, cond, trunk, heads, st = args
    x0 = rt._pe(o, d, z, pe_w, L)[0].contiguous()
    with torch.no_grad():
        out, res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
        g = torch.Generator(device=cuda_device).manual_seed(2)
        cots = {k: torch.randn(v.shape, generator=g, device=cuda_device) for k, v in out.items()}

        def call(s):
            if x0_mode:
                return rt.render_train_bwd(x0, z, cond, trunk, heads, s, c_emb, res, cots)
            return rt.render_train_rays_bwd(o, d, z, pe_w, cond, trunk, heads, s, c_emb, res, cots)

        one = call(st)
        lay = rt.dw_layout(st, W, rt.feat_pad(F, True), HH, 128, 16)
        monkeypatch.setattr(rt, "DW_BUFFER_BYTES", 100 * (128 * lay.ops_w * 2 + lay.ray_w * 2 + lay.nb * 4))
        assert rt.dw_slab_rays(lay, 128, 132) == 100
        from upnerf_torch.ops import dw_gemm as dg

        before = dg.dw_launches
        a, b = call(st), call(st)
        frozen = call(st._replace(param_grads=False))
        if x0_mode:
            want = rt.render_train_bwd_plain(x0, z, cond, trunk, heads, st, c_emb, res, cots)
        else:
            want = rt.render_train_rays_bwd_plain(o, d, z, pe_w, cond, trunk, heads, st, c_emb, res, cots)
    torch.cuda.synchronize()
    assert dg.dw_launches == before + 6

    def flat(r):
        return [t for t in r[:-2] if t is not None] + [t for wb in r[-2] for t in wb] + [r[-1][k] for k in st.head_keys]

    for x, y in zip(flat(a), flat(b)):
        assert torch.equal(x, y)
    n_data = len([t for t in a[:-2] if t is not None])
    for x, y, f in zip(flat(a)[:n_data], flat(one)[:n_data], [t for t in frozen[:-2] if t is not None]):
        assert torch.equal(x, y) and torch.equal(x, f)
    for x, w in zip(flat(a), flat(want)):
        assert torch.isfinite(x).all() and (x - w.reshape(x.shape)).abs().max() <= 1e-2 * w.abs().max()


def _outputs(x):
    """The tensors of a nested result (tuples, lists, dicts; None skipped), in order."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _outputs(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _outputs(v)]
    return []


def _run_twice(fn):
    """(outputs that differ, outputs, worst max |d| over an output's max) of two calls."""
    a, b = _outputs(fn()), _outputs(fn())
    torch.cuda.synchronize()
    n_diff = sum(int((x != y).sum()) for x, y in zip(a, b))
    worst = max([(x.float() - y.float()).abs().max().item() / max(x.float().abs().max().item(), 1e-30)
                 for x, y in zip(a, b)] + [0.0])
    return n_diff, sum(x.numel() for x in a), worst


@pytest.mark.cuda
@pytest.mark.parametrize("S", SAMPLES)
@pytest.mark.parametrize("mode", ["serving", "phase0", "phase1", "recompute", "x0"])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_forward_repeats_bit_for_bit(cuda_device, precision, mode, S):
    """Two calls of the forward kernel on the same inputs give the same bits in
    every output and residual: the feature map's column sums run in a fixed
    order in both precisions (no atomics). R = 151 is odd: at S <= 64 the last
    tile holds one ray."""
    if mode in ("serving", "x0"):
        o, d, z, pe_w, cond, trunk, heads = make_inputs(151, S, cuda_device, seed=31)
        args, c_emb = (o, d, z, pe_w, cond, trunk, heads, rt.RTStatic(D=D, skips=SKIPS, xyz_L=L,
                                                                      precision=precision)), None
    else:
        args, c_emb = train_inputs(151, S, cuda_device, 0 if mode == "phase0" else 1, precision, seed=31)
        if mode == "recompute":
            args = (*args[:-1], args[-1]._replace(save_chain=False))
    save = mode != "serving" and mode != "x0"
    with torch.no_grad():
        if mode == "x0":
            x0, z, cond, trunk, heads, st = x0_args(args)
            n_diff, n, _ = _run_twice(lambda: rt.render_train_fwd(x0, z, cond, trunk, heads, st))
        else:
            n_diff, n, _ = _run_twice(lambda: rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=save))
    assert n > 0 and n_diff == 0


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_run_to_run_bits_of_every_mode(cuda_device, precision):
    """Each mode twice on the same inputs: the forward (saved chain and
    recompute), kernel 2's train, recompute train and frozen modes, kernels 5
    and 6's backward. Prints how many outputs differ and by how much, and
    asserts same bits in every mode: no backward adds a weight gradient with
    atomics (the walks store their operands, dw_gemm sums them in a fixed
    order)."""
    from upnerf_torch.ops import heads as hk
    from upnerf_torch.ops import mlp

    found = {}
    with torch.no_grad():
        for chain in (True, False):
            args, c_emb = train_inputs(128, 128, cuda_device, 1, precision, seed=33)
            st = args[-1]._replace(save_chain=chain)
            args = (*args[:-1], st)
            tag = "saved chain" if chain else "recompute"
            found[f"forward {tag}"] = _run_twice(lambda: rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True))
            out, res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
            g = torch.Generator(device=cuda_device).manual_seed(34)
            cots = {k: torch.randn(v.shape, generator=g, device=cuda_device) for k, v in out.items()}
            found[f"backward train, {tag}"] = _run_twice(lambda: rt.render_train_rays_bwd(*args[:7], st, c_emb, res,
                                                                                           cots))
            frozen = st._replace(param_grads=False)
            found[f"backward frozen, {tag}"] = _run_twice(lambda: rt.render_train_rays_bwd(*args[:7], frozen, c_emb,
                                                                                            res, cots))
        x0, c_rows, trunk, heads = heads_inputs(4096, cuda_device, True)
        g = torch.Generator(device=cuda_device).manual_seed(35)
        hcots = [torch.randn(t.shape, generator=g, device=cuda_device)
                 for t in hk.fused_trunk_heads_fwd(x0, c_rows, trunk, heads, SKIPS, precision)]
        found["kernel 5 backward"] = _run_twice(lambda: hk.fused_trunk_heads_bwd(x0, c_rows, trunk, heads, SKIPS,
                                                                                 precision, hcots))
        tcot = torch.randn((x0.shape[0], W), generator=g, device=cuda_device)
        found["kernel 6 backward"] = _run_twice(lambda: mlp.fused_trunk_bwd(x0, trunk, SKIPS, precision, tcot))
    for name, (n_diff, n, worst) in found.items():
        print(f"{precision} {name}: {n_diff} of {n} outputs differ, worst {worst:.3e} of an output's max")
    for name, (n_diff, n, _) in found.items():
        assert n > 0 and n_diff == 0, name


def _bwd_outputs(r, st):
    """The backward's data cotangents, then (train mode) every dW and db, in order."""
    out = [t for t in (r[:-2] if isinstance(r[0], torch.Tensor) else [*r[0], *r[1:-2]]) if t is not None]
    if st.param_grads:
        out += [t for wb in r[-2] for t in wb] + [r[-1][k] for k in st.head_keys]
    return out


def _design_call(args, c_emb, res, cots, st, x0, design):
    """One bf16 backward call in `design` (render_train.BWD_DESIGNS), rays or x0 frontend (x0 not None), run
    through BwdLaunch as the route runs it."""
    o, d, z, pe_w, cond, trunk, heads = args[:7]
    if x0 is None:
        r = rt.render_train_rays_bwd_launch(o, d, z, pe_w, cond, trunk, heads, st, c_emb, res, cots, design).run()
        return (*r[0], *r[1:])
    return rt.BwdLaunch([None, None, z, None, cond, c_emb, x0], x0.shape[1], 0, z, cond, trunk, heads, st, c_emb,
                        res, cots, True, design).run()


@pytest.mark.cuda
@pytest.mark.parametrize("x0_mode", [False, True], ids=["rays", "x0"])
@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("phase", [0, 1, 2])
def test_bf16_walk_designs_agree_in_every_mode(cuda_device, phase, F, x0_mode):
    """The Hopper walk (the route's) against the mma.sync walk it replaced
    (the timing variant, render_train_bwd_mma_sync) on the same residuals, in
    the saved-chain and recompute modes, train and frozen: every output within
    1e-2 of its max (the two designs sum their products in other orders; both
    walk the same rebuilt chain in the recompute mode); the frozen mode's data
    cotangents equal the train mode's bit for bit; each Hopper stage counted
    once a slab."""
    for save_chain in (True, False):
        args, c_emb = recompute_inputs(48, 100, cuda_device, phase, "bfloat16", seed=17, F=F)
        st = args[-1]._replace(save_chain=save_chain)
        o, d, z, pe_w, cond, trunk, heads = args[:7]
        x0 = rt._pe(o, d, z, pe_w, L)[0].contiguous() if x0_mode else None
        with torch.no_grad():
            if x0_mode:
                out, res = rt.render_train_fwd(x0, z, cond, trunk, heads, st, c_emb=c_emb, save_res=True)
            else:
                out, res = rt.render_train_rays_fwd(*args[:7], st, c_emb=c_emb, save_res=True)
            g = torch.Generator(device=cuda_device).manual_seed(4)
            cots = {k: torch.randn(v.shape, generator=g, device=cuda_device) for k, v in out.items()}
            for s in (st, st._replace(param_grads=False)):
                before = (rt.walk_pre_launches, rt.walk_launches, rt.walk_finish_launches)
                got = _design_call(args, c_emb, res, cots, s, x0, "wgmma")
                n = rt.walk_launches - before[1]
                assert n >= 1 and (rt.walk_pre_launches, rt.walk_finish_launches) == (before[0] + n, before[2] + n)
                want = _design_call(args, c_emb, res, cots, s, x0, "mma_sync")
                torch.cuda.synchronize()
                for a, b in zip(_bwd_outputs(got, s), _bwd_outputs(want, s)):
                    assert torch.isfinite(a).all()
                    assert (a - b.reshape(a.shape)).abs().max() <= 1e-2 * b.abs().max(), (save_chain, s.param_grads)
                if s.param_grads:
                    train = _bwd_outputs(got, s)
                else:
                    assert all(torch.equal(a, b) for a, b in zip(_bwd_outputs(got, s), train))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [48, 100, 130])
@pytest.mark.parametrize("phase", [0, 1, 2])
def test_bf16_walk_at_a_ragged_s_matches_plain_and_repeats(cuda_device, phase, S):
    """Ragged tiles (a ray's last 64-sample tile part empty; S = 48 one
    tile, 100 two, 130 three) at an odd ray count (an odd tile count leaves a
    work item's second tile empty): the Hopper walk's backward within 1e-2 of
    each output's max of the plain backward, train and frozen; two calls and
    the frozen mode's data cotangents bit for bit."""
    o, d, z, pe_w, cond, trunk, heads = make_inputs(37, S, cuda_device, seed=19)
    if phase < 2:
        args, c_emb = train_inputs(37, S, cuda_device, phase, "bfloat16", seed=19)
    else:
        args, c_emb = (o, d, z, pe_w, cond, trunk, heads, rt.RTStatic(D=D, skips=SKIPS, xyz_L=L,
                                                                      precision="bfloat16")), None
    st = args[-1]
    with torch.no_grad():
        out, res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
        g = torch.Generator(device=cuda_device).manual_seed(5)
        cots = {k: torch.randn(v.shape, generator=g, device=cuda_device) for k, v in out.items()}
        for s in (st, st._replace(param_grads=False)):
            a = rt.render_train_rays_bwd(*args[:7], s, c_emb, res, cots)
            b = rt.render_train_rays_bwd(*args[:7], s, c_emb, res, cots)
            want = rt.render_train_rays_bwd_plain(*args[:7], s, c_emb, res, cots)
            torch.cuda.synchronize()
            got = _bwd_outputs(a, s)
            assert all(torch.equal(x, y) for x, y in zip(got, _bwd_outputs(b, s)))
            for x, w in zip(got, _bwd_outputs(want, s)):
                assert torch.isfinite(x).all() and (x - w.reshape(x.shape)).abs().max() <= 1e-2 * w.abs().max()
            if s.param_grads:
                train = got
            else:
                assert all(torch.equal(x, y) for x, y in zip(got, train))


# Kernels 5 and 6's forward in bf16: the route's Hopper design (heads_fwd.cu:wg_fwd_kernel) and the
# mma.sync design it replaced (the timing variant heads_fwd_mma_sync, heads.HEADS_FWD_DESIGNS).
HEADS_FWD_TOL = 5e-3  # of each output's max (chip_smoke.py: TRUNK_TOL): a bf16 rounding flip carries on
HEADS_FWD_ROWS = [1, 63, 64, 65, 127, 128, 129, 1037, 524288]  # around a tile (64) and a tile pair (128)
HEADS_FWD_CASES = [(n, F, mode) for n in HEADS_FWD_ROWS for mode in ("candidate", "heads", "trunk")
                   for F in (WIDTHS if mode != "trunk" else [384])]


def heads_fwd_outputs(x0, c_emb, trunk, heads, skips, mode, design):
    """One bf16 forward launch in a design: kernel 5's outputs, or (h,) in the trunk-only mode."""
    from upnerf_torch.ops import heads as hk

    return hk.fused_trunk_heads_fwd_launch(x0, c_emb, trunk, None if mode == "trunk" else heads, skips, "bfloat16",
                                           design)


def heads_fwd_plain(x0, c_emb, trunk, heads, skips, mode, precision="bfloat16"):
    from upnerf_torch.ops import heads as hk
    from upnerf_torch.ops import mlp

    if mode == "trunk":
        return (mlp.fused_trunk_plain(x0, trunk, skips, precision),)
    return hk.fused_trunk_heads_plain(x0, c_emb, trunk, heads, skips, precision)


def check_heads_fwd_designs(x0, c_emb, trunk, heads, skips, mode):
    """Both designs against the plain version and each other (HEADS_FWD_TOL),
    the Hopper design's RMS distance to the bf16 plain version under a
    quarter of its distance to the f32 one, and two of its calls bit for bit."""
    from upnerf_torch.ops import heads as hk

    with torch.no_grad():
        want = heads_fwd_plain(x0, c_emb, trunk, heads, skips, mode)
        want32 = heads_fwd_plain(x0, c_emb, trunk, heads, skips, mode, "float32")
        got = {des: heads_fwd_outputs(x0, c_emb, trunk, heads, skips, mode, des) for des in hk.HEADS_FWD_DESIGNS}
        again = heads_fwd_outputs(x0, c_emb, trunk, heads, skips, mode, "wgmma")
    torch.cuda.synchronize()
    rms = lambda t: t.double().pow(2).mean().sqrt()  # noqa: E731
    assert len(got["wgmma"]) == len(want) == {"candidate": 4, "heads": 2, "trunk": 1}[mode]
    for i, b in enumerate(want):
        k, m = got["wgmma"][i], got["mma_sync"][i]
        assert k.shape == b.shape == m.shape and torch.isfinite(k).all() and torch.isfinite(m).all()
        lim = HEADS_FWD_TOL * b.abs().max()
        assert (k - b).abs().max() <= lim and (m - b).abs().max() <= lim and (k - m).abs().max() <= lim
        assert torch.equal(k, again[i])
        if x0.shape[0] >= 64:
            assert rms(k - b) <= 0.25 * rms(k - want32[i])


@pytest.mark.cuda
@pytest.mark.parametrize("N,F,mode", HEADS_FWD_CASES)
def test_heads_forward_designs_match_plain_and_each_other(cuda_device, N, F, mode):
    """The bf16 forward in both designs at N around the tiles' edges and at
    524,288 rows (a train step's fine pass), F = 32 / 64 / 384, with the
    candidate branch, without it and trunk-only: rows past N are never
    written (the outputs hold exactly N rows, each within the tolerance)."""
    x0, c_emb, trunk, heads = heads_inputs(N, cuda_device, mode == "candidate", seed=N + F, F=F)
    check_heads_fwd_designs(x0, c_emb, trunk, heads, SKIPS, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("in0", [39, 63])
@pytest.mark.parametrize("depth,skips", [(4, (2,)), (16, (4, 8, 12))], ids=["D4", "D16"])
@pytest.mark.parametrize("mode", ["candidate", "heads", "trunk"])
def test_heads_forward_designs_at_other_widths_and_depths(cuda_device, mode, depth, skips, in0):
    """The same at x0 widths 39 (L = 6) and 63, D = 4 and 16 with skip layers, 1037 rows."""
    x0, c_emb, trunk, heads = heads_inputs(1037, cuda_device, mode == "candidate", seed=depth + in0, depth=depth,
                                           skips=skips, in0=in0)
    check_heads_fwd_designs(x0, c_emb, trunk, heads, skips, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("depth,skips", [(8, (4,)), (16, (4, 8, 12))], ids=["D8", "D16"])
@pytest.mark.parametrize("mode", ["trunk", "candidate"])
@pytest.mark.parametrize("N", [1, 129, 4097])
def test_trunk_forward_is_the_backwards_rebuilt_activation(cuda_device, N, mode, depth, skips):
    """The forward's chain and the backward's rebuild are one code
    (wg_chain.cuh:trunk_chain): the trunk-only forward's output, rounded to
    bf16, equals bit for bit the last activation that heads.BwdCall stores as
    its dW operand for the same rows, in the backward's trunk-only mode and
    in its candidate mode (the same trunk)."""
    from upnerf_torch.ops import heads as hk

    x0, c_emb, trunk, heads = heads_inputs(N, cuda_device, mode == "candidate", seed=N + depth, depth=depth,
                                           skips=skips)
    with torch.no_grad():
        (h,) = hk.fused_trunk_heads_fwd_launch(x0, None, trunk, None, skips, "bfloat16")
        if mode == "trunk":
            call = hk.BwdCall(x0, None, trunk, None, skips, "bfloat16", [torch.zeros((N, W), device=cuda_device)])
        else:
            names = hk.HEAD_KEYS + hk.CAND_KEYS
            cots = [torch.zeros(t.shape, device=cuda_device) for t in hk.fused_trunk_heads_plain(
                x0, c_emb, trunk, heads, skips, "bfloat16")]
            call = hk.BwdCall(x0, c_emb, trunk, {k: heads[k] for k in names}, skips, "bfloat16", cots)
        assert call.slab >= N
        call.walk(0, N)
    torch.cuda.synchronize()
    col = call.lay.ops[f"act{depth - 1}"]
    assert torch.equal(call.ops[:N, col : col + W], h.bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("fused_train", [True, False], ids=["kernel1", "kernel5"])
def test_pose_scorer_kernel_route_matches_plain_route(cuda_device, fused_train):
    """train.warp's candidate scorer at the brandenburg_gate width, f32, 6
    candidates x 64 rays of one image in one render call: through kernel 1's
    forward (tpu.fused_train on) or kernel 5's (off), against the same scorer
    with the kernel replaced by its plain version on the card. A score is
    mean((f - t)^2), and the kernel meets its plain version within e =
    TOL * max |f| (f32), so each score within 2 sqrt(s) e + e^2; the base pose,
    whose own render is the target, ranks first in both."""
    import os

    from upnerf_torch.config import get_from_path
    from upnerf_torch.geometry import rays as ray_utils
    from upnerf_torch.render.render_rays import render_rays
    from upnerf_torch.train import StepConfig, init_params, make_scene_constants, warp

    hp = get_from_path(os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs", "brandenburg_gate.yaml"))
    hp["tpu.matmul_precision"] = "float32"
    cfg = StepConfig.from_hparams(hp)
    cfg = cfg._replace(render=cfg.render._replace(fused_train=fused_train))
    model = init_params(cfg.nerf, cfg.transient, 2, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    model.requires_grad_(False)
    w, h, rng = 32, 24, np.random.RandomState(3)
    K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]], np.float32)
    poses = np.stack([np.eye(3, 4), np.eye(3, 4)]).astype(np.float32)
    poses[:, 2, 3] = 3.0
    maps = rng.randn(2, h, w, cfg.nerf.feat_dim).astype(np.float32)
    scene = make_scene_constants(np.stack([K, K]), poses, np.tile([[0.1, 5.0]], (2, 1)), np.tile([[w, h]], (2, 1)),
                                 maps, cuda_device, feat_dtype=torch.float32)
    jj, ii = torch.meshgrid(torch.arange(h, device=cuda_device), torch.arange(w, device=cuda_device), indexing="ij")
    rays_o, rays_d = ray_utils.get_rays(ray_utils.pixel_directions(ii.reshape(-1), jj.reshape(-1), scene.Ks[0]),
                                        scene.poses[0])
    rays = torch.cat([rays_o, rays_d, scene.near_far[0].expand(w * h, 2)], -1)
    with torch.no_grad():
        out = render_rays(model.render_params(), cfg.render._replace(perturb=0.0, fused_train=True), rays,
                          torch.zeros(w * h, dtype=torch.long, device=cuda_device), phase=0, sched_mult=0.0,
                          progress=0.5, det=True)
    scene.feat_maps[0] = out["feat_fine"].reshape(h, w, -1)
    px = rng.randint(0, w, 64).astype(np.float32)
    py = rng.randint(0, h, 64).astype(np.float32)
    cands = warp.propose_candidates(np.array([0.05, -0.04, 0.03, 0.1, -0.05, 0.08], np.float32),
                                    warp.WarpConfig(kicks=4), rng)
    from upnerf_torch.ops import heads as hk

    score = warp.make_pose_scorer(cfg, 64, 0.5)
    feat_max, render = [0.0], warp.render_rays

    def spied(*args, **kw):  # max |f| of the rendered candidates' features
        res = render(*args, **kw)
        feat_max[0] = max(feat_max[0], float(res["feat_fine"].abs().max()))
        return res

    kernel, fields, before = rt.render_train_rays_fwd, [model.nerf_coarse, model.nerf_fine], (rt.launches, hk.launches)
    cfgs = [f.cfg for f in fields]
    warp.render_rays = spied
    try:
        got = score(model, scene, 0, px, py, cands)
        assert (rt.launches - before[0], hk.launches - before[1]) == ((2, 0) if fused_train else (0, 2))
        # the plain route: kernel 1's plain version, or the fields' plain trunk + heads
        rt.render_train_rays_fwd = rt.render_train_rays_plain
        for f in fields:
            f.cfg = f.cfg._replace(fused_trunk=False)
        want = score(model, scene, 0, px, py, cands)
    finally:
        warp.render_rays, rt.render_train_rays_fwd = render, kernel
        for f, c in zip(fields, cfgs):
            f.cfg = c
    e = TOL["float32"] * feat_max[0]
    tol = 2 * want.clamp_min(0).sqrt() * e + e * e
    assert ((got - want).abs() <= tol).all(), (got, want, tol)
    assert int(got.argmin()) == int(want.argmin()) == 1
