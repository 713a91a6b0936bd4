"""The CUDA kernels of the render path against their plain PyTorch versions,
on the card, at the brandenburg_gate width (D=8, W=256, skip 4, F=384, HH=128,
L=10) and at the validation configs' feature widths (F=32, 64): the fused
forward render, its backward in the train and frozen-model modes, the trunk
kernel of the fast render's probe and its backward (the feature-less field's),
the trunk + heads kernels (forward and backward) and the static render from
PE rows (the x0 mode). Every test here needs an NVIDIA card: it carries the
`cuda` marker and skips without one.

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
