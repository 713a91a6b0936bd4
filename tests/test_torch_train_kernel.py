"""The training modes of upnerf_torch.ops.render_train against
upnerf.ops.pallas_render_train: every forward mode, and the backward.

At D=4, skip 2, W=32, F=16, HH=HC=16, C=4, R=8, S=16, L=4, float32:
- the plain forward in each mode of tests/test_render_train_kernel.py COMBOS
  against the XLA twin `xla_render_train_rays` and against the Pallas kernel
  `fused_render_train_rays` in the Pallas interpreter: 1e-5 absolute (2e-5
  relative on depths);
- `render_train_rays_bwd_plain` against `jax.vjp` of the Pallas kernel in the
  interpreter with save_chain=True, and against torch autograd through the
  plain forward, for every cotangent: 1e-4 of each leaf's max |g|;
- the autograd.Function RenderTrainRays, which on the CPU runs those two
  plain versions.
In bf16 mode the plain backward rounds every product's operands, the
cotangent included, as the kernel does; it is held against the Pallas
kernel's bf16 VJP at 1e-3 of each leaf's max |g| (an f32 sum on the other
side of a bf16 rounding boundary moves one operand by one bf16 ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.ops import pallas_render_train as jrt
from upnerf_torch.ops import render_train as rt

D, SKIPS, W, F, HH, HC, C, R, S, L = 4, (2,), 32, 16, 16, 16, 4, 8, 16, 4
IN0 = 3 + 6 * L
COMBOS = [(True, True, True), (True, False, True), (False, True, False), (False, True, True)]
IDS = ["phase1", "phase0", "phase2", "nocand"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def statics(use_cand, use_rgb, out_feat, precision="float32"):
    st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=L, precision=precision, use_cand=use_cand, use_rgb=use_rgb,
                     out_feat=out_feat)
    jst = jrt.RTStatic(D=D, skips=SKIPS, use_cand=use_cand, use_rgb=use_rgb, out_feat=out_feat, precision=precision,
                       ray_tile=8, xyz_L=L, save_chain=True)
    return st, jst


def make_inputs(st, seed=0):
    """Numpy inputs in the JAX kernel's interface (rays, z, pe_w, ray_cond,
    c_emb, trunk, heads); sigma biases keep bin masses away from zero."""
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    o = arr(R, 3, scale=0.3)
    d = arr(R, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 2.0, (R, S)), -1).astype(np.float32)
    pe_w = rng.uniform(0.3, 1.0, L).astype(np.float32)
    cond = arr(R, HH, scale=0.3) if st.use_rgb else None
    cemb = arr(R, C) if st.use_cand else None
    trunk = []
    for i in range(D):
        fan = IN0 if i == 0 else (W + IN0 if i in SKIPS else W)
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
    return o, d, z, pe_w, cond, cemb, trunk, heads


def to_torch(inputs, grad=False):
    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)

    o, d, z, pe_w, cond, cemb, trunk, heads = inputs
    return (t(o), t(d), torch.from_numpy(z), torch.from_numpy(pe_w), t(cond), t(cemb),
            [(t(w), t(b)) for w, b in trunk], {k: t(v) for k, v in heads.items()})


def to_jax(inputs):
    o, d, z, pe_w, cond, cemb, trunk, heads = inputs
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return (j(o), j(d), j(z), j(pe_w), j(cond), j(cemb), tuple((j(w), j(b)) for w, b in trunk),
            {k: j(v) for k, v in heads.items()})


def plain_fwd(inputs, st, save_res=False):
    o, d, z, pe_w, cond, cemb, trunk, heads = to_torch(inputs)
    return rt.render_train_rays_plain(o, d, z, pe_w, cond, trunk, heads, st, c_emb=cemb, save_res=save_res)


def assert_fwd_close(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].detach().numpy(), np.asarray(want[k])
        if "depth" in k:
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=k)


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


def plain_bwd(inputs, st, cots):
    o, d, z, pe_w, cond, cemb, trunk, heads = to_torch(inputs)
    _, res = rt.render_train_rays_plain(o, d, z, pe_w, cond, trunk, heads, st, c_emb=cemb, save_res=True)
    return rt.render_train_rays_bwd_plain(o, d, z, pe_w, cond, trunk, heads, st, cemb, res,
                                          {k: torch.from_numpy(v) for k, v in cots.items()})


def jax_vjp(inputs, jst, cots):
    o, d, z, pe_w, cond, cemb, trunk, heads = to_jax(inputs)

    def f(o_, d_, cond_, cemb_, trunk_, heads_):
        return jrt.fused_render_train_rays(o_, d_, z, pe_w, cond_, cemb_, trunk_, heads_, jst)

    _, vjp = jax.vjp(f, o, d, cond, cemb, trunk, heads)
    return vjp({k: jnp.asarray(v) for k, v in cots.items()})


def compare_grads(got, want, st, rel):
    d_o, d_d, d_cond, d_cemb, dtrunk, dh = got
    w_o, w_d, w_cond, w_cemb, w_trunk, w_heads = want
    assert_leaf_close(d_o, w_o, rel, "rays_o")
    assert_leaf_close(d_d, w_d, rel, "rays_d")
    if st.use_rgb:
        assert_leaf_close(d_cond, w_cond, rel, "ray_cond")
    if st.use_cand:
        assert_leaf_close(d_cemb, w_cemb, rel, "c_emb")
    for i, ((gw, gb), (ww, wb)) in enumerate(zip(dtrunk, w_trunk)):
        assert_leaf_close(gw, ww, rel, f"trunk{i}.w")
        assert_leaf_close(gb, wb, rel, f"trunk{i}.b")
    assert set(dh) == set(st.head_keys)
    for k in st.head_keys:
        assert_leaf_close(dh[k], w_heads[k], rel, k)


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_plain_forward_matches_xla_twin(combo):
    st, jst = statics(*combo)
    inputs = make_inputs(st, seed=1)
    want = jrt.xla_render_train_rays(*to_jax(inputs), jst)
    assert_fwd_close(plain_fwd(inputs, st), want)


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_plain_forward_matches_pallas_kernel_interpret(combo, monkeypatch):
    monkeypatch.setattr(jrt, "INTERPRET", True)
    st, jst = statics(*combo)
    inputs = make_inputs(st, seed=2)
    want = jrt.fused_render_train_rays(*to_jax(inputs), jst)
    out, res = plain_fwd(inputs, st, save_res=True)
    assert_fwd_close(out, want)
    # the residuals: the walk chain in the JAX kernel's column layout
    chain_w = sum(w for _, w in st.chain_cols(W, HH, HC))
    assert tuple(res["chain"].shape) == (R * S, chain_w) and set(res) == set(st.res_keys)


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_plain_backward_matches_pallas_vjp(combo, monkeypatch):
    monkeypatch.setattr(jrt, "INTERPRET", True)
    # seed 3 would put one ray where the Pallas kernel's VJP itself moves by
    # 1e-3 from the XLA twin's (a ReLU pre-activation within f32 rounding of
    # zero: the kernel builds cos x as sin(x + pi/2)); the port matches the
    # twin there to 2e-7.
    st, jst = statics(*combo)
    inputs = make_inputs(st, seed=4)
    cots = cotangents(st)
    compare_grads(plain_bwd(inputs, st, cots), jax_vjp(inputs, jst, cots), st, 1e-4)


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_plain_backward_matches_autograd(combo):
    """The division-free formulas against autograd through the cumprod
    forward, f32."""
    st, _ = statics(*combo)
    inputs = make_inputs(st, seed=4)
    cots = cotangents(st, seed=8)
    o, d, z, pe_w, cond, cemb, trunk, heads = to_torch(inputs, grad=True)
    out = rt.render_train_rays_plain(o, d, z, pe_w, cond, trunk, heads, st, c_emb=cemb)
    loss = sum((out[k] * torch.from_numpy(v)).sum() for k, v in cots.items())
    leaves = [o, d] + ([cond] if st.use_rgb else []) + ([cemb] if st.use_cand else [])
    leaves += [t for wb in trunk for t in wb] + [heads[k] for k in st.head_keys]
    g = torch.autograd.grad(loss, leaves)
    it = iter(g)
    want = (next(it), next(it), next(it) if st.use_rgb else None, next(it) if st.use_cand else None,
            [(next(it), next(it)) for _ in range(D)], {k: next(it) for k in st.head_keys})
    want = (want[0].numpy(), want[1].numpy(), None if want[2] is None else want[2].numpy(),
            None if want[3] is None else want[3].numpy(), [(a.numpy(), b.numpy()) for a, b in want[4]],
            {k: v.numpy() for k, v in want[5].items()})
    compare_grads(plain_bwd(inputs, st, cots), want, st, 1e-4)


def test_render_train_rays_function_on_cpu():
    """RenderTrainRays: forward = plain forward, backward = plain backward;
    z and pe_w get no gradient."""
    st, _ = statics(True, True, True)
    inputs = make_inputs(st, seed=5)
    cots = cotangents(st, seed=9)
    o, d, z, pe_w, cond, cemb, trunk, heads = to_torch(inputs, grad=True)
    z.requires_grad_(True)
    before = (rt.launches, rt.bwd_launches)
    out = rt.render_train_rays(o, d, z, pe_w, cond, trunk, heads, st, c_emb=cemb)
    want_out = plain_fwd(inputs, st)
    for k in st.out_keys:
        assert torch.equal(out[k].detach(), want_out[k]), k
    loss = sum((out[k] * torch.from_numpy(v)).sum() for k, v in cots.items())
    loss.backward()
    assert (rt.launches, rt.bwd_launches) == before
    assert z.grad is None
    want = plain_bwd(inputs, st, cots)
    assert torch.equal(o.grad, want[0]) and torch.equal(d.grad, want[1])
    assert torch.equal(cond.grad, want[2]) and torch.equal(cemb.grad, want[3])
    for (w, b), (gw, gb) in zip(trunk, want[4]):
        assert torch.equal(w.grad, gw) and torch.equal(b.grad, gb)
    for k in st.head_keys:
        assert torch.equal(heads[k].grad, want[5][k].reshape(heads[k].shape)), k


@pytest.mark.parametrize("combo", [COMBOS[0], COMBOS[2]], ids=["phase1", "phase2"])
def test_plain_bf16_backward_matches_pallas_vjp(combo, monkeypatch):
    monkeypatch.setattr(jrt, "INTERPRET", True)
    st, jst = statics(*combo, precision="bfloat16")
    inputs = make_inputs(st, seed=6)
    cots = cotangents(st, seed=10)
    got = plain_bwd(inputs, st, cots)
    compare_grads(got, jax_vjp(inputs, jst, cots), st, 1e-3)
    # and bf16 is another computation than f32 at this size
    f32 = plain_bwd(inputs, st._replace(precision="float32"), cots)
    assert np.abs(got[4][0][0].numpy() - f32[4][0][0].numpy()).max() > 1e-6


def test_wrapper_refuses_other_devices():
    st, _ = statics(True, True, True)
    o, d, z, pe_w, cond, cemb, trunk, heads = to_torch(make_inputs(st))
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="no render kernel"):
        rt.render_train_rays_bwd(meta(o), d, z, pe_w, cond, trunk, heads, st, cemb, {}, {})
