"""The CUDA kernels of the render path against their plain PyTorch versions,
on the card, at the brandenburg_gate width (D=8, W=256, skip 4, F=384, HH=128,
L=10) and at the validation configs' feature widths (F=32, 64): the fused
forward render, its backward in the train and frozen-model modes, the trunk
kernel of the fast render's probe and its backward (the feature-less field's),
the trunk + heads kernels (forward and backward), the static render from
PE rows (the x0 mode), the fused render from PE rows in every training mode
with its d_x0 backward (kernel 1b), and the matrix-unit probe's three chains.
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def make_inputs(R, S, device, seed=0, F=384):
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
    trunk = [lin(in0 if i == 0 else (in0 + W if i in SKIPS else W), W) for i in range(D)]
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
@pytest.mark.parametrize("S", [128, 256, 100])
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


def train_inputs(R, S, device, phase, precision, seed=0, F=384):
    """Inputs of one training mode (phase 0: candidate + feature map; phase 1:
    also rgb) and its RTStatic."""
    o, d, z, pe_w, cond, trunk, heads = make_inputs(R, S, device, seed, F)
    heads = add_candidate(heads, device, seed + 1, F=F)
    c_emb = torch.from_numpy(np.random.RandomState(seed + 2).randn(R, 16).astype(np.float32)).to(device)
    st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=L, precision=precision, use_cand=True, use_rgb=phase > 0, out_feat=True)
    heads = {k: heads[k] for k in st.head_keys}
    return (o, d, z, pe_w, cond if st.use_rgb else None, trunk, heads, st), c_emb


@pytest.mark.cuda
@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("S", [128, 100])
def test_train_forward_matches_plain(cuda_device, precision, phase, S, F):
    """Forward kernel with residuals in the phase-0/1 modes; residuals too (the
    bf16 chain is stored rounded: 1e-2 of its max for a rounding flip)."""
    args, c_emb = train_inputs(256, S, cuda_device, phase, precision, F=F)
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


def heads_inputs(N, device, cand, seed=21, C=16, HC=128, F=384):
    """x0 rows, a per-row candidate embedding and the kernel-5 weights (c1 unsplit)."""
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def lin(i, o):
        b = i**-0.5
        return t(rng.uniform(-b, b, (i, o))), t(rng.uniform(-b, b, o))

    in0 = 3 + 6 * L
    trunk = [lin(in0 if i == 0 else (in0 + W if i in SKIPS else W), W) for i in range(D)]
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
@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_static_render_kernel_matches_plain_and_serving_mode(cuda_device, precision, F):
    """Kernel 4 (the x0 mode of csrc/render_train_fwd.cu) against its plain
    version (cumprod transmittance) and against the serving mode on the same
    rays (PE built in the kernel), with the serving tolerances above."""
    from upnerf_torch.ops import render as srk

    o, d, z, pe_w, cond, trunk, heads = make_inputs(296, 128, cuda_device, seed=5, F=F)
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
def test_recompute_forward_matches_plain(cuda_device, precision, store_f32, phase, F):
    """The forward's residuals without a chain (sig_s, sig_c, feat, c_feat,
    rgb) and its outputs against the plain version: outputs as
    test_train_forward_matches_plain; feat / c_feat within 1e-5 (f32), 5e-3
    (bf16 products, f32 store: the trunk's bf16 rounding flips reach a single
    sample unaveraged) or 1e-2 (bf16 store: also one bf16 ulp of the value)
    of their max (and rgb, which bf16 store also rounds)."""
    args, c_emb = recompute_inputs(200, 100, cuda_device, phase, precision, seed=11, F=F, store_f32=store_f32)
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
def test_x0_forward_and_backward_match_plain(cuda_device, phase, precision, save_chain, in0):
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
    equal the train mode's bit for bit. The saved chain runs at S = 100, a ragged last tile of the
    d_x0 store. With the PE rows, the outputs also meet the rays mode's
    kernel."""
    S = 100 if save_chain else 128
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
        rays = rt.render_train_rays_fwd(*args, c_emb=c_emb) if in0 is None else None
    torch.cuda.synchronize()
    assert (rt.x0_launches, rt.x0_bwd_launches, rt.launches, rt.bwd_launches) == (
        before[0] + 1, before[1] + 2, before[2] + (in0 is None), before[3])  # the plain versions launch nothing
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
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_static_render_kernel_takes_any_x0_width(cuda_device, precision):
    """Kernel 4 at in0 = 8 (not 3 + 6L) against its plain version."""
    from upnerf_torch.ops import render as srk

    args = (*make_inputs(96, 128, cuda_device, seed=27), rt.RTStatic(D=D, skips=SKIPS, xyz_L=L, precision=precision))
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


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["pure", "epi", "int8"])
def test_mxu_probe_kernel_matches_plain(cuda_device, chain):
    """The probe's chains at a ragged M (300 rows, 5 tiles), L = 6, 3 copies:
    int8 bit for bit (exact int32 sums, the same requantisation); bf16 by RMS
    within 1e-3 of the plain chain's RMS (another summation order flips a
    rare bf16 rounding, which the next layers carry)."""
    from upnerf_torch.ops import mxu_probe as mp

    x, ws, b, ws_i8 = (torch.from_numpy(a).to(cuda_device) for a in mp.probe_inputs(300, 256, 6, seed=1))
    w = ws_i8 if chain == "int8" else ws
    before = mp.launches[chain]
    with torch.no_grad():
        got = mp.mxu_probe(x, w, b, chain, copies=3)
        want = mp.mxu_probe_plain(x, w, b, chain)
    torch.cuda.synchronize()
    assert mp.launches[chain] == before + 1 and got.shape == (300, 256) and torch.isfinite(got).all()
    if chain == "int8":
        assert torch.equal(got, want)
    else:
        assert _rms(got - want) <= 1e-3 * _rms(want)


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
