"""The feature widths of the validation configs (nerf.feat_dim 32 and 64,
configs/validation/) through the plain versions of the CUDA kernels, against
the JAX package's Pallas kernels at F=32, and the zero padding the CUDA
kernels run at.

The CUDA kernels take F in render_train.KERNEL_F and run their feature
products at FP = feat_pad(F) columns (64 in bf16, 128 in f32) over weights
the wrappers zero-pad (render_train.pad_feat); the padded columns must carry
exact zeros. At D=4, skip 2, W=32, HH=HC=16, C=4, L=4, R=8, S=16, float32:
- kernels 1 and 2 (ops.render_train, phase-1 mode: candidate, rgb, feature
  map): the plain forward against `fused_render_train_rays` in the Pallas
  interpreter, 1e-5 absolute (2e-5 relative on depths); the plain backward
  against its VJP, 1e-4 of each leaf's max |g|;
- kernel 5 (ops.heads): the plain forward and backward against
  `fused_trunk_heads` and its VJP in the interpreter, 1e-5 of each max;
- kernel 4 (ops.render): the static render and its gradients against
  `fused_static_render` in the interpreter, 1e-5 of each max;
- F = 32 and 64, each padded to both FP: every plain version on the padded
  weights gives the unpadded outputs (the feature map's first F columns)
  within 1e-6 absolute, and gradients whose first F feature columns are the
  unpadded ones within 1e-6 of each max and whose padded columns are zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.ops import pallas_heads as jph
from upnerf.ops import pallas_render as jpr
from upnerf.ops import pallas_render_train as jrt
from upnerf_torch.ops import heads as th
from upnerf_torch.ops import render as trd
from upnerf_torch.ops import render_train as rt

D, SKIPS, W, HH, HC, C, R, S, L = 4, (2,), 32, 16, 16, 4, 8, 16, 4
IN0 = 3 + 6 * L
PADS = {32: (64, 128), 64: (64, 128)}  # feat_pad(F, bf16), feat_pad(F, f32)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    for mod in (jph, jpr, jrt):
        monkeypatch.setattr(mod, "INTERPRET", True)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rel(a, b):
    b = np.asarray(b, np.float32)
    return float(np.abs(np.asarray(a, np.float32).reshape(b.shape) - b).max() / max(np.abs(b).max(), 1e-30))


def world(F, seed=0):
    """Rays, depths, band weights, ray_cond, c_emb, the trunk and every head
    (the render's interface, c1 split) in numpy."""
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    d = arr(R, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    trunk = []
    for i in range(D):
        fan = IN0 if i == 0 else (W + IN0 if i in SKIPS else W)
        trunk.append((arr(fan, W, scale=fan**-0.5), arr(W, scale=0.1)))
    heads = {"xyzf_w": arr(W, W, scale=W**-0.5), "xyzf_b": arr(W, scale=0.1), "sigma_w": arr(W, 1, scale=W**-0.5),
             "sigma_b": arr(1, scale=0.1), "feat_w": arr(W, F, scale=W**-0.5), "feat_b": arr(F, scale=0.1),
             "rgb1_w": arr(F, HH, scale=F**-0.5), "rgb2_w": arr(HH, 3, scale=HH**-0.5), "rgb2_b": arr(3, scale=0.1),
             "c1x_w": arr(W, HC, scale=W**-0.5), "c1c_w": arr(C, HC, scale=C**-0.5), "c1_b": arr(HC, scale=0.1),
             "c2_w": arr(HC, HC, scale=HC**-0.5), "c2_b": arr(HC, scale=0.1), "csig_w": arr(HC, 1, scale=HC**-0.5),
             "csig_b": arr(1, scale=0.1), "cfeat_w": arr(HC, F, scale=HC**-0.5), "cfeat_b": arr(F, scale=0.1)}
    z = np.sort(rng.uniform(0.1, 2.0, (R, S)), -1).astype(np.float32)
    return (arr(R, 3, scale=0.3), d, z, rng.uniform(0.3, 1.0, L).astype(np.float32), arr(R, HH, scale=0.3),
            arr(R, C), trunk, heads)


def phase1():
    st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=L, precision="float32", use_cand=True, use_rgb=True, out_feat=True)
    jst = jrt.RTStatic(D=D, skips=SKIPS, use_cand=True, use_rgb=True, out_feat=True, precision="float32",
                       ray_tile=8, xyz_L=L, save_chain=True)
    return st, jst


def render_plain(w, st, heads=None, cots=None):
    o, d, z, pe_w, cond, ce, trunk, hd = w
    hd = {k: T(v) for k, v in (heads or hd).items() if k in st.head_keys}
    args = (T(o), T(d), T(z), T(pe_w), T(cond), [(T(a), T(b)) for a, b in trunk], hd, st)
    out, res = rt.render_train_rays_plain(*args, c_emb=T(ce), save_res=True)
    if cots is None:
        return out
    return out, rt.render_train_rays_bwd_plain(*args[:7], st, T(ce), res, {k: T(v) for k, v in cots.items()})


def render_cots(F, seed=7, width=None):
    rng = np.random.RandomState(seed)
    cots = {"s_weights": rng.randn(R, S), "s_depth": rng.randn(R), "rgb_map": rng.randn(R, 3),
            "feat_map": rng.randn(R, F), "j_weights": rng.randn(R, S), "c_depth": rng.randn(R),
            "t_weight": rng.randn(R)}
    if width:
        cots["feat_map"] = np.concatenate([cots["feat_map"], np.zeros((R, width - F))], 1)
    return {k: v.astype(np.float32) for k, v in cots.items()}


def test_render_train_plain_matches_pallas_at_f32(interpret):
    F = 32
    w = world(F)
    st, jst = phase1()
    cots = render_cots(F)
    got, (d_o, d_d, d_cond, d_cemb, dtrunk, dh) = render_plain(w, st, cots=cots)
    o, d, z, pe_w, cond, ce, trunk, hd = w
    j = jnp.asarray
    jhd = {k: j(v) for k, v in hd.items() if k in st.head_keys}
    jt = tuple((j(a), j(b)) for a, b in trunk)

    def f(o_, d_, cond_, cemb_, trunk_, heads_):
        return jrt.fused_render_train_rays(o_, d_, j(z), j(pe_w), cond_, cemb_, trunk_, heads_, jst)

    want, vjp = jax.vjp(f, j(o), j(d), j(cond), j(ce), jt, jhd)
    assert set(got) == set(want) and got["feat_map"].shape == (R, F)
    for k in want:
        tol = dict(rtol=2e-5, atol=1e-6) if "depth" in k else dict(rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **tol)
    wo, wd, wcond, wcemb, wtrunk, wheads = vjp({k: j(v) for k, v in cots.items() if k in want})
    pairs = [(d_o, wo), (d_d, wd), (d_cond, wcond), (d_cemb, wcemb)]
    pairs += [(a, b) for (ga, gb), (wa, wb) in zip(dtrunk, wtrunk) for a, b in ((ga, wa), (gb, wb))]
    pairs += [(dh[k], wheads[k]) for k in st.head_keys]
    for i, (a, b) in enumerate(pairs):
        assert rel(a.numpy(), b) <= 1e-4, i


@pytest.mark.parametrize("F", [32, 64])
def test_render_train_padded_widths_are_exact(F):
    w = world(F, seed=1)
    st, _ = phase1()
    want, want_g = render_plain(w, st, cots=render_cots(F))
    for FP in PADS[F]:
        padded = {k: v.numpy() for k, v in rt.pad_feat({k: T(v) for k, v in w[-1].items()}, FP).items()}
        got, got_g = render_plain(w, st, heads=padded, cots=render_cots(F, width=FP))
        assert got["feat_map"].shape == (R, FP) and not got["feat_map"][:, F:].any()
        for k in want:
            np.testing.assert_allclose(got[k].numpy()[..., :want[k].shape[-1]] if k == "feat_map" else got[k].numpy(),
                                       want[k].numpy(), rtol=0, atol=1e-6, err_msg=f"{k} FP={FP}")
        for a, b in zip(got_g[:4], want_g[:4]):
            assert rel(a.numpy(), b.numpy()) <= 1e-6
        for (ga, gb), (wa, wb) in zip(got_g[4], want_g[4]):
            assert rel(ga.numpy(), wa.numpy()) <= 1e-6 and rel(gb.numpy(), wb.numpy()) <= 1e-6
        for k, v in rt.unpad_feat(got_g[5], F).items():
            assert rel(v.numpy(), want_g[5][k].numpy()) <= 1e-6, k
            full = got_g[5][k].numpy()
            if k in rt.FEAT_DIMS:
                assert not np.take(full, np.arange(F, FP), axis=rt.FEAT_DIMS[k]).any(), k


def heads_world(F, seed=2, n=64):
    rng = np.random.RandomState(seed)

    def lin(i, o):
        b = i**-0.5
        return rng.uniform(-b, b, (i, o)).astype(np.float32), rng.uniform(-b, b, o).astype(np.float32)

    trunk = [lin(IN0 if i == 0 else (IN0 + W if i in SKIPS else W), W) for i in range(D)]
    heads = {}
    for k, (i, o) in dict(sigma=(W, 1), xyzf=(W, W), feat=(W, F), c1=(W + C, HC), c2=(HC, HC), csig=(HC, 1),
                          cfeat=(HC, F)).items():
        heads[k + "_w"], heads[k + "_b"] = lin(i, o)
    cots = [rng.randn(n, 1), rng.randn(n, F), rng.randn(n, 1), rng.randn(n, F)]
    return trunk, heads, rng.randn(n, IN0).astype(np.float32), rng.randn(n, C).astype(np.float32), \
        [c.astype(np.float32) for c in cots]


def test_heads_plain_matches_pallas_at_f32(interpret):
    trunk, heads, x0, ce, cots = heads_world(32)
    jt = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in trunk)
    jh = {k: jnp.asarray(v) for k, v in heads.items()}
    jout, vjp = jax.vjp(lambda x, c, t, h: jph.fused_trunk_heads(x, c, t, h, SKIPS, 32, "float32"), jnp.asarray(x0),
                        jnp.asarray(ce), jt, jh)
    jg = vjp(tuple(jnp.asarray(c) for c in cots))
    tt = [(T(w), T(b)) for w, b in trunk]
    th_ = {k: T(v) for k, v in heads.items()}
    tout = th.fused_trunk_heads_plain(T(x0), T(ce), tt, th_, SKIPS, "float32")
    assert tout[1].shape == (64, 32)
    for a, b in zip(tout, jout):
        assert rel(a.numpy(), b) <= 1e-5
    dx0, dce, dtr, dh = th.fused_trunk_heads_bwd_plain(T(x0), T(ce), tt, th_, SKIPS, "float32", [T(c) for c in cots])
    assert rel(dx0.numpy(), jg[0]) <= 1e-5 and rel(dce.numpy(), jg[1]) <= 1e-5
    for i in range(D):
        assert rel(dtr[i][0].numpy(), jg[2][i][0]) <= 1e-5 and rel(dtr[i][1].numpy(), jg[2][i][1]) <= 1e-5
    for k in heads:
        assert rel(dh[k].numpy(), jg[3][k]) <= 1e-5, k


@pytest.mark.parametrize("F", [32, 64])
def test_heads_padded_widths_are_exact(F):
    trunk, heads, x0, ce, cots = heads_world(F, seed=3)
    tt = [(T(w), T(b)) for w, b in trunk]
    want = th.fused_trunk_heads_plain(T(x0), T(ce), tt, {k: T(v) for k, v in heads.items()}, SKIPS, "float32")
    wb = th.fused_trunk_heads_bwd_plain(T(x0), T(ce), tt, {k: T(v) for k, v in heads.items()}, SKIPS, "float32",
                                        [T(c) for c in cots])
    for FP in PADS[F]:
        hp = rt.pad_feat({k: T(v) for k, v in heads.items()}, FP)
        got = th.fused_trunk_heads_plain(T(x0), T(ce), tt, hp, SKIPS, "float32")
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy()[:, : b.shape[1]], b.numpy(), rtol=0, atol=1e-6)
            assert not a.numpy()[:, b.shape[1]:].any()
        pc = [T(c) if c.shape[1] == 1 else T(np.concatenate([c, np.zeros((len(c), FP - F), np.float32)], 1))
              for c in cots]
        gb = th.fused_trunk_heads_bwd_plain(T(x0), T(ce), tt, hp, SKIPS, "float32", pc)
        assert rel(gb[0].numpy(), wb[0].numpy()) <= 1e-6 and rel(gb[1].numpy(), wb[1].numpy()) <= 1e-6
        for k, v in rt.unpad_feat({k: v for k, v in gb[3].items() if k in rt.FEAT_DIMS}, F).items():
            assert rel(v.numpy(), wb[3][k].numpy()) <= 1e-6, k
            assert not np.take(gb[3][k].numpy(), np.arange(F, FP), axis=rt.FEAT_DIMS[k]).any(), k


@pytest.mark.parametrize("F", [32, 64])
def test_static_render_plain_at_f32_and_padded(interpret, F):
    o, d, z, pe_w, cond, _, trunk, hd = world(F, seed=4)
    head = {k: hd[k] for k in trd.HEAD_KEYS}
    x0, _ = rt._pe(T(o), T(d), T(z), T(pe_w), L)
    x0 = x0.numpy()
    tt = [(T(w), T(b)) for w, b in trunk]
    want = trd.fused_static_render_plain(T(x0), T(z), T(cond), tt, {k: T(v) for k, v in head.items()}, SKIPS, "float32")
    for FP in PADS[F]:
        padded = rt.pad_feat({k: T(v) for k, v in head.items()}, FP)
        got = trd.fused_static_render_plain(T(x0), T(z), T(cond), tt, padded, SKIPS, "float32")
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    if F != 32:
        return
    jt = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in trunk)
    jh = {k: jnp.asarray(v) for k, v in head.items()}
    jout, vjp = jax.vjp(lambda x, c, t, h: jpr.fused_static_render(x, jnp.asarray(z), c, t, h, SKIPS, 8, "float32"),
                        jnp.asarray(x0), jnp.asarray(cond), jt, jh)
    gs = [np.random.RandomState(5).randn(*o_.shape).astype(np.float32) for o_ in jout]
    jg = vjp(tuple(jnp.asarray(g) for g in gs))
    x = T(x0).requires_grad_()
    c = T(cond).requires_grad_()
    tg = [(T(w).requires_grad_(), T(b).requires_grad_()) for w, b in trunk]
    thd = {k: T(v).requires_grad_() for k, v in head.items()}
    tout = trd.fused_static_render(x, T(z), c, tg, thd, SKIPS, "float32")
    for a, b in zip(tout, jout):
        assert rel(a.detach().numpy(), b) <= 1e-5
    torch.autograd.backward(tout, [T(g) for g in gs])
    assert rel(x.grad.numpy(), jg[0]) <= 1e-5 and rel(c.grad.numpy(), jg[1]) <= 1e-5
    for k in head:
        assert rel(thd[k].grad.numpy(), jg[3][k]) <= 1e-5, k
