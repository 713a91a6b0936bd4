"""The x0 frontend of upnerf_torch.ops.render_train (kernel 1b: the fused
render from pre-built PE rows, every training mode, and its d_x0 backward)
against upnerf.ops.pallas_render_train.fused_render_train, and kernel 4's x0
width.

At D=2, skip 1, W=16, in0=9, F=8, HH=HC=8, C=4, R=16, S=12 (the shapes of
tests/test_render_train_kernel.py), in every mode of its COMBOS x save_chain:
- `render_train_plain` against the Pallas kernel in the interpreter (the
  primal of its VJP) and against the XLA twin `xla_render_train`: 1e-5
  absolute in f32 (2e-5 relative on depths); in bf16 1e-3 of each output's
  max (an f32 sum on the other side of a bf16 rounding boundary moves one
  operand by one bf16 ulp);
- `render_train_bwd_plain` (d_x0, d_ray_cond, d_c_emb and, in the train mode,
  every weight gradient) against `jax.vjp` of the Pallas kernel in the
  interpreter, train (param_grads) and frozen modes in f32, the train mode in
  bf16: 1e-4 of each leaf's max |g| (f32), 1e-3 (bf16, as
  tests/test_torch_train_kernel.py holds the rays frontend);
- `RenderTrain` on the CPU against torch autograd through the plain forward
  (1e-4 of each leaf's max, f32);
- the x0 route fed the PE rows of rays equals the rays route bit for bit
  (forward, and d_x0 through the PE backward);
- `scripts.bench_render_train_kernel` on the CPU at a tiny size;
- kernel 4's plain version at in0 = 8 (not 3 + 6L) against the Pallas kernel
  in the interpreter, forward and VJP: 1e-5 of each output's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.ops import pallas_render as jpr
from upnerf.ops import pallas_render_train as jrt
from upnerf_torch.ops import render as trd
from upnerf_torch.ops import render_train as rt
from upnerf_torch.scripts import bench_render_train_kernel as bench

D, SKIPS, W, IN0, F, HH, HC, C, R, S = 2, (1,), 16, 9, 8, 8, 8, 4, 16, 12
COMBOS = [(True, True, True), (True, False, True), (False, True, False), (False, True, True)]
IDS = ["phase1", "phase0", "phase2", "nocand"]
# (precision, param_grads): f32 in the train and frozen modes, bf16 in the train mode
MODES = [("float32", True), ("float32", False), ("bfloat16", True)]
MODE_IDS = ["f32", "f32-frozen", "bf16"]
FWD_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-3}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def statics(combo, precision="float32", save_chain=True, param_grads=True):
    use_cand, use_rgb, out_feat = combo
    st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=0, precision=precision, use_cand=use_cand, use_rgb=use_rgb,
                     out_feat=out_feat, save_chain=save_chain, param_grads=param_grads)
    jst = jrt.RTStatic(D=D, skips=SKIPS, use_cand=use_cand, use_rgb=use_rgb, out_feat=out_feat, precision=precision,
                       ray_tile=8, save_chain=save_chain, param_grads=param_grads)
    return st, jst


def make_inputs(st, seed=0, in0=IN0):
    """Numpy inputs in the JAX kernel's interface (x0, z, ray_cond, c_emb,
    trunk, heads); fan-in scaled weights, sigma biases that keep bin masses
    away from zero."""
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    x0 = arr(R * S, in0)
    z = np.sort(rng.uniform(0.1, 2.0, (R, S)), -1).astype(np.float32)
    cond = arr(R, HH, scale=0.3) if st.use_rgb else None
    cemb = arr(R, C) if st.use_cand else None
    trunk = []
    for i in range(D):
        fan = in0 if i == 0 else (W + in0 if i in SKIPS else W)
        trunk.append((arr(fan, W, scale=fan**-0.5), arr(W, scale=0.1)))
    heads = {"xyzf_w": arr(W, W, scale=W**-0.5), "xyzf_b": arr(W, scale=0.1),
             "sigma_w": arr(W, 1, scale=W**-0.5), "sigma_b": arr(1, scale=0.1),
             "feat_w": arr(W, F, scale=W**-0.5), "feat_b": arr(F, scale=0.1)}
    if st.use_rgb:
        heads.update(rgb1_w=arr(F, HH, scale=F**-0.5), rgb2_w=arr(HH, 3, scale=HH**-0.5), rgb2_b=arr(3, scale=0.1))
    if st.use_cand:
        heads.update(c1x_w=arr(W, HC, scale=W**-0.5), c1c_w=arr(C, HC, scale=C**-0.5), c1_b=arr(HC, scale=0.1),
                     c2_w=arr(HC, HC, scale=HC**-0.5), c2_b=arr(HC, scale=0.1), csig_w=arr(HC, 1, scale=HC**-0.5),
                     csig_b=arr(1, scale=0.1), cfeat_w=arr(HC, F, scale=HC**-0.5), cfeat_b=arr(F, scale=0.1))
    return x0, z, cond, cemb, trunk, heads


def to_torch(inputs, grad=False):
    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)

    x0, z, cond, cemb, trunk, heads = inputs
    return (t(x0), torch.from_numpy(z), t(cond), t(cemb), [(t(w), t(b)) for w, b in trunk],
            {k: t(v) for k, v in heads.items()})


def to_jax(inputs):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    x0, z, cond, cemb, trunk, heads = inputs
    return j(x0), j(z), j(cond), j(cemb), tuple((j(w), j(b)) for w, b in trunk), {k: j(v) for k, v in heads.items()}


def cotangents(st, seed=7):
    rng = np.random.RandomState(seed)
    shapes = {"s_weights": (R, S), "s_depth": (R,), "rgb_map": (R, 3), "feat_map": (R, F), "j_weights": (R, S),
              "c_depth": (R,), "t_weight": (R,)}
    return {k: rng.randn(*shapes[k]).astype(np.float32) for k in st.out_keys}


def assert_leaf_close(got, want, rel, name):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32).reshape(want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rel, err_msg=name)


def assert_fwd_close(got, want, precision):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].detach().numpy(), np.asarray(want[k])
        if precision == "bfloat16":
            assert_leaf_close(g, w, FWD_TOL[precision], k)
        elif "depth" in k:
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("precision,param_grads", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("save_chain", [True, False], ids=["chain", "recompute"])
@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_plain_matches_pallas_kernel(combo, save_chain, precision, param_grads, monkeypatch):
    """Forward (with residuals) and backward of the plain x0 frontend against
    fused_render_train in the interpreter: its primal outputs and its VJP."""
    monkeypatch.setattr(jrt, "INTERPRET", True)
    st, jst = statics(combo, precision, save_chain, param_grads)
    inputs = make_inputs(st, seed=3)
    x0, z, cond, cemb, trunk, heads = to_jax(inputs)

    def f(x0_, cond_, cemb_, trunk_, heads_):
        return jrt.fused_render_train(x0_, z, cond_, cemb_, trunk_, heads_, jst)

    jout, vjp = jax.vjp(f, x0, cond, cemb, trunk, heads)
    cots = cotangents(st)
    jg = vjp({k: jnp.asarray(v) for k, v in cots.items()})

    tx0, tz, tcond, tcemb, ttrunk, theads = to_torch(inputs)
    out, res = rt.render_train_plain(tx0, tz, tcond, ttrunk, theads, st, c_emb=tcemb, save_res=True)
    assert tuple(res) == st.res_keys
    assert_fwd_close(out, jout, precision)
    assert_fwd_close(out, jrt.xla_render_train(x0, z, cond, cemb, trunk, heads, jst), precision)

    d_x0, d_cond, d_cemb, dtrunk, dh = rt.render_train_bwd_plain(
        tx0, tz, tcond, ttrunk, theads, st, tcemb, res, {k: torch.from_numpy(v) for k, v in cots.items()})
    tol = BWD_TOL[precision]
    assert d_x0.shape == (R * S, IN0)
    assert_leaf_close(d_x0, jg[0], tol, "x0")
    if st.use_rgb:
        assert_leaf_close(d_cond, jg[1], tol, "ray_cond")
    if st.use_cand:
        assert_leaf_close(d_cemb, jg[2], tol, "c_emb")
    if not param_grads:
        assert dtrunk is None and dh is None
        return
    for i, ((gw, gb), (ww, wb)) in enumerate(zip(dtrunk, jg[3])):
        assert_leaf_close(gw, ww, tol, f"trunk{i}.w")
        assert_leaf_close(gb, wb, tol, f"trunk{i}.b")
    assert set(dh) == set(st.head_keys)
    for k in st.head_keys:
        assert_leaf_close(dh[k], jg[4][k], tol, k)


@pytest.mark.parametrize("save_chain", [True, False], ids=["chain", "recompute"])
def test_render_train_function_on_cpu(save_chain):
    """RenderTrain: forward = the plain forward, backward = the plain backward,
    which meets torch autograd through the plain forward; z gets no gradient,
    no kernel is launched; the frozen mode refuses weights that require grad."""
    st, _ = statics(COMBOS[0], save_chain=save_chain)
    inputs = make_inputs(st, seed=5)
    cots = cotangents(st, seed=9)
    x0, z, cond, cemb, trunk, heads = to_torch(inputs, grad=True)
    z.requires_grad_(True)
    before = (rt.x0_launches, rt.x0_bwd_launches)
    out = rt.render_train(x0, z, cond, trunk, heads, st, c_emb=cemb)
    want = rt.render_train_plain(*to_torch(inputs)[:3], to_torch(inputs)[4], to_torch(inputs)[5], st,
                                 c_emb=to_torch(inputs)[3])
    for k in st.out_keys:
        assert torch.equal(out[k].detach(), want[k]), k
    loss = sum((out[k] * torch.from_numpy(v)).sum() for k, v in cots.items())
    leaves = [x0, cond, cemb] + [t for wb in trunk for t in wb] + [heads[k] for k in st.head_keys]
    got = torch.autograd.grad(loss, leaves + [z], allow_unused=True)
    assert got[-1] is None and (rt.x0_launches, rt.x0_bwd_launches) == before
    ref_leaves = [t.detach().requires_grad_(True) for t in leaves]
    n = 2 * D
    rtrunk = [(ref_leaves[3 + 2 * i], ref_leaves[4 + 2 * i]) for i in range(D)]
    rheads = dict(zip(st.head_keys, ref_leaves[3 + n:]))
    rout = rt.render_train_plain(ref_leaves[0], z.detach(), ref_leaves[1], rtrunk, rheads, st, c_emb=ref_leaves[2])
    ref = torch.autograd.grad(sum((rout[k] * torch.from_numpy(v)).sum() for k, v in cots.items()), ref_leaves)
    names = ["x0", "ray_cond", "c_emb"] + [f"trunk{i}.{p}" for i in range(D) for p in "wb"] + list(st.head_keys)
    for name, g, w in zip(names, got, ref):
        assert_leaf_close(g.numpy(), w.numpy(), 1e-4, name)

    frozen = st._replace(param_grads=False)
    with pytest.raises(RuntimeError, match="param_grads=False"):
        rt.render_train(x0, z, cond, trunk, heads, frozen, c_emb=cemb)
    fx0 = x0.detach().requires_grad_(True)
    fout = rt.render_train(fx0, z.detach(), cond.detach(), [(w.detach(), b.detach()) for w, b in trunk],
                           {k: v.detach() for k, v in heads.items()}, frozen, c_emb=cemb.detach())
    (g_frozen,) = torch.autograd.grad(sum((fout[k] * torch.from_numpy(v)).sum() for k, v in cots.items()), [fx0])
    assert torch.equal(g_frozen, got[0])


def test_x0_route_equals_rays_route():
    """The x0 frontend fed the PE rows of rays: the rays route's outputs and,
    through the PE backward, its d_rays_o / d_rays_d and weight gradients,
    bit for bit (the rays route is this route behind the PE)."""
    L = 1  # in0 = 9
    st, _ = statics(COMBOS[0])
    st_rays = st._replace(xyz_L=L)
    x0_np, z, cond, cemb, trunk, heads = make_inputs(st, seed=11)
    rng = np.random.RandomState(12)
    o = torch.from_numpy(rng.randn(R, 3).astype(np.float32) * 0.3)
    d = torch.from_numpy(rng.randn(R, 3).astype(np.float32))
    pe_w = torch.from_numpy(rng.uniform(0.3, 1.0, L).astype(np.float32))
    _, tz, tcond, tcemb, ttrunk, theads = to_torch((x0_np, z, cond, cemb, trunk, heads))
    x0, xyz = rt._pe(o, d, tz, pe_w, L)
    out, res = rt.render_train_plain(x0, tz, tcond, ttrunk, theads, st, c_emb=tcemb, save_res=True)
    rout, rres = rt.render_train_rays_plain(o, d, tz, pe_w, tcond, ttrunk, theads, st_rays, c_emb=tcemb, save_res=True)
    for k in st.out_keys:
        assert torch.equal(out[k], rout[k]), k
    for k in st.res_keys:
        assert torch.equal(res[k], rres[k]), k
    cots = {k: torch.from_numpy(v) for k, v in cotangents(st, seed=13).items()}
    d_x0, d_cond, d_cemb, dtrunk, dh = rt.render_train_bwd_plain(x0, tz, tcond, ttrunk, theads, st, tcemb, res, cots)
    d_o, d_d, r_cond, r_cemb, rtrunk, rdh = rt.render_train_rays_bwd_plain(o, d, tz, pe_w, tcond, ttrunk, theads,
                                                                           st_rays, tcemb, rres, cots)
    pe_o, pe_d = rt._pe_bwd(d_x0, xyz, tz, pe_w, L)
    assert torch.equal(pe_o, d_o) and torch.equal(pe_d, d_d)
    assert torch.equal(d_cond, r_cond) and torch.equal(d_cemb, r_cemb)
    assert all(torch.equal(a, b) for (a, b), (c, e) in zip(dtrunk, rtrunk) for a, b in ((a, c), (b, e)))
    assert all(torch.equal(dh[k], rdh[k]) for k in st.head_keys)


def test_wrappers_refuse_other_devices():
    st, _ = statics(COMBOS[0])
    x0, z, cond, cemb, trunk, heads = to_torch(make_inputs(st))
    with pytest.raises(ValueError, match="no render kernel"):
        rt.render_train_fwd(x0.to("meta"), z, cond, trunk, heads, st, c_emb=cemb)
    with pytest.raises(ValueError, match="no render kernel"):
        rt.render_train_bwd(x0.to("meta"), z, cond, trunk, heads, st, cemb, {}, {})


@pytest.mark.parametrize("fwd_only", [False, True], ids=["grad", "fwd_only"])
def test_bench_script_on_cpu(fwd_only):
    """The benchmark on the CPU (both routes are plain code there): the two
    routes' losses agree (the same forward), and so do their x0 gradients
    (the hand backward rounds each product's cotangent operand to bf16,
    autograd rounds its result: 1e-2 of the max)."""
    argv = ["--device", "cpu", "--rays", "8", "--samples", "8", "--steps", "1"] + (["--fwd_only"] if fwd_only else [])
    got = bench.main(argv)
    assert got["device"] == "cpu, host clock" and got["fused_ms"] > 0 and got["plain_ms"] > 0
    assert got["loss"] != 0 and got["loss_rel"] <= 1e-6
    assert (got["dx0_rel"] is None) == fwd_only
    if not fwd_only:
        assert got["dx0_rel"] <= 1e-2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(["--steps", "1"])


def test_bench_inputs_follow_the_jax_script():
    """The script's draws: the JAX script's order and scales (:43-68), so both
    scripts compute the same function on the same arrays."""
    x0, z, cond, cemb, trunk, heads = bench.make_inputs(2, 4)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(x0, rng.randn(8, 63).astype(np.float32) * 0.3)
    np.testing.assert_array_equal(z, np.sort(rng.rand(2, 4).astype(np.float32) * 4 + 0.1, -1))
    np.testing.assert_array_equal(cond, rng.randn(2, 128).astype(np.float32) * 0.3)
    np.testing.assert_array_equal(cemb, rng.randn(2, 16).astype(np.float32) * 0.3)
    assert [w.shape for w, _ in trunk] == [(63, 256)] + [(256, 256)] * 3 + [(319, 256)] + [(256, 256)] * 3
    assert list(heads)[:4] == ["xyzf_w", "xyzf_b", "sigma_w", "sigma_b"] and heads["cfeat_b"].shape == (384,)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_static_render_takes_any_x0_width(precision, monkeypatch):
    """Kernel 4 at in0 = 8, which is not 3 + 6L (pallas_render.py:200 takes
    x0.shape[1]): the plain version against the Pallas kernel in the
    interpreter, forward and VJP."""
    monkeypatch.setattr(jpr, "INTERPRET", True)
    in0, sk = 8, (1,)
    rng = np.random.RandomState(4)

    def lin(i, o):
        b = i**-0.5
        return rng.uniform(-b, b, (i, o)).astype(np.float32), rng.uniform(-b, b, o).astype(np.float32)

    trunk = [lin(in0 if i == 0 else (in0 + W if i in sk else W), W) for i in range(D)]
    hd = {}
    for k, (i, o) in dict(sigma=(W, 1), xyzf=(W, W), feat=(W, F), rgb2=(HH, 3)).items():
        hd[k + "_w"], hd[k + "_b"] = lin(i, o)
    hd["rgb1_w"] = lin(F, HH)[0]
    Rs, Ss = 8, 16
    x0 = rng.randn(Rs * Ss, in0).astype(np.float32)
    z = np.sort(rng.uniform(0.1, 5, (Rs, Ss)), -1).astype(np.float32)
    cond = (rng.randn(Rs, HH) * 0.3).astype(np.float32)
    jt = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in trunk)
    jh = {k: jnp.asarray(v) for k, v in hd.items()}
    jout, vjp = jax.vjp(lambda x, c, t, h: jpr.fused_static_render(x, jnp.asarray(z), c, t, h, sk, 8, precision),
                        jnp.asarray(x0), jnp.asarray(cond), jt, jh)
    gs = [rng.randn(*o.shape).astype(np.float32) for o in jout]
    jg = vjp(tuple(jnp.asarray(g) for g in gs))
    T = torch.from_numpy
    x = T(x0).requires_grad_()
    c = T(cond).requires_grad_()
    tt = [(T(w).requires_grad_(), T(b).requires_grad_()) for w, b in trunk]
    thd = {k: T(v).requires_grad_() for k, v in hd.items()}
    tout = trd.fused_static_render(x, T(z), c, tt, thd, sk, precision)
    for a, b, name in zip(tout, jout, ("rgb_map", "depth", "weights")):
        assert a.shape == b.shape
        assert_leaf_close(a.detach().numpy(), b, 1e-5, name)
    torch.autograd.backward(tout, [T(g) for g in gs])
    assert_leaf_close(x.grad.numpy(), jg[0], 1e-5, "x0")
    assert_leaf_close(c.grad.numpy(), jg[1], 1e-5, "ray_cond")
    for i in range(D):
        assert_leaf_close(tt[i][0].grad.numpy(), jg[2][i][0], 1e-5, f"trunk{i}.w")
    for k in hd:
        assert_leaf_close(thd[k].grad.numpy(), jg[3][k], 1e-5, k)
