"""upnerf_torch.ops.render_train against upnerf.ops.pallas_render_train.

The plain PyTorch version is held against the JAX package's XLA twin
(`xla_render_train_rays`) and against the Pallas kernel itself
(`fused_render_train_rays`, run in the Pallas interpreter as
tests/test_render_train_kernel.py runs it), in the forward-only phase-2
mode, at D=4, skip 2, W=32, F=16, R=8, S=16, L=4. Tolerances: 1e-5 absolute
on rgb_map and s_weights, 1e-4 relative on s_depth. The fused kernel
composites by exp(-cumsum) and builds cos as sin(x + pi/2); the twin and the
port composite by cumprod and call cos; all in f32.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernel_cuda.py, which imports no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.ops import pallas_render_train as jrt
from upnerf_torch.ops import linear
from upnerf_torch.ops import render_train as rt

D, SKIPS, W, F, HH, R, S, L = 4, (2,), 32, 16, 16, 8, 16, 4
IN0 = 3 + 6 * L


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_inputs(seed=0, R=R, S=S, W=W, F=F, HH=HH, L=L, D=D, skips=SKIPS):
    """Numpy inputs in the JAX kernel's interface: rays, depths, band
    weights, ray_cond, trunk ((in, out), (out,)) pairs and head dict."""
    rng = np.random.RandomState(seed)
    in0 = 3 + 6 * L

    def arr(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    o = arr(R, 3, scale=0.3)
    d = arr(R, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 2.0, (R, S)), -1).astype(np.float32)
    pe_w = rng.uniform(0.3, 1.0, L).astype(np.float32)
    cond = arr(R, HH, scale=0.3)
    trunk = []
    for i in range(D):
        fan = in0 if i == 0 else (W + in0 if i in skips else W)
        trunk.append((arr(fan, W, scale=fan**-0.5), arr(W, scale=0.1)))
    heads = {
        "xyzf_w": arr(W, W, scale=W**-0.5), "xyzf_b": arr(W, scale=0.1),
        "sigma_w": arr(W, 1, scale=W**-0.5), "sigma_b": arr(1, scale=0.1),
        "feat_w": arr(W, F, scale=W**-0.5), "feat_b": arr(F, scale=0.1),
        "rgb1_w": arr(F, HH, scale=F**-0.5),
        "rgb2_w": arr(HH, 3, scale=HH**-0.5), "rgb2_b": arr(3, scale=0.1),
    }
    return o, d, z, pe_w, cond, trunk, heads


def to_torch(inputs, device="cpu"):
    o, d, z, pe_w, cond, trunk, heads = inputs
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return t(o), t(d), t(z), t(pe_w), t(cond), [(t(w), t(b)) for w, b in trunk], {k: t(v) for k, v in heads.items()}


def to_jax(inputs):
    o, d, z, pe_w, cond, trunk, heads = inputs
    j = jnp.asarray
    return j(o), j(d), j(z), j(pe_w), j(cond), None, tuple((j(w), j(b)) for w, b in trunk), {
        k: j(v) for k, v in heads.items()
    }


def jax_static(precision="float32"):
    return jrt.RTStatic(
        D=D, skips=SKIPS, use_cand=False, use_rgb=True, out_feat=False, precision=precision, ray_tile=8, xyz_L=L
    )


def assert_outputs_close(got, want, atol=1e-5, rtol_depth=1e-4):
    assert set(got) == {"s_weights", "s_depth", "rgb_map"}
    np.testing.assert_allclose(got["rgb_map"], np.asarray(want["rgb_map"]), rtol=0, atol=atol, err_msg="rgb_map")
    np.testing.assert_allclose(got["s_weights"], np.asarray(want["s_weights"]), rtol=0, atol=atol, err_msg="s_weights")
    np.testing.assert_allclose(got["s_depth"], np.asarray(want["s_depth"]), rtol=rtol_depth, err_msg="s_depth")


def plain(inputs, precision="float32"):
    st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=L, precision=precision)
    out = rt.render_train_rays_plain(*to_torch(inputs), st)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_xla_twin(seed):
    inputs = make_inputs(seed)
    assert_outputs_close(plain(inputs), jrt.xla_render_train_rays(*to_jax(inputs), jax_static()))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_kernel_interpret(seed, monkeypatch):
    monkeypatch.setattr(jrt, "INTERPRET", True)
    inputs = make_inputs(seed)
    assert_outputs_close(plain(inputs), jrt.fused_render_train_rays(*to_jax(inputs), jax_static()))


def test_plain_bf16_matches_xla_twin():
    """bf16 operands, f32 accumulation on both sides. 1e-3: a sum that lands
    on the other side of a bf16 rounding boundary moves one operand by one
    bf16 ulp."""
    inputs = make_inputs(2)
    got = plain(inputs, "bfloat16")
    want = jrt.xla_render_train_rays(*to_jax(inputs), jax_static("bfloat16"))
    assert_outputs_close(got, want, atol=1e-3, rtol_depth=1e-3)
    # and bf16 is a different computation from f32 at this size
    assert np.abs(got["rgb_map"] - plain(inputs)["rgb_map"]).max() > 1e-6


def test_wrapper_takes_plain_version_on_cpu():
    inputs = make_inputs(3)
    st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=L)
    before = rt.launches
    got = rt.render_train_rays_fwd(*to_torch(inputs), st)
    want = rt.render_train_rays_plain(*to_torch(inputs), st)
    assert rt.launches == before
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_wrapper_refuses_other_devices():
    o, d, z, pe_w, cond, trunk, heads = to_torch(make_inputs(4), device="meta")
    with pytest.raises(ValueError, match="no render kernel"):
        rt.render_train_rays_fwd(o, d, z, pe_w, cond, trunk, heads, rt.RTStatic(D=D, skips=SKIPS, xyz_L=L))


def test_bf16_matmul_accumulates_in_f32():
    """The plain version's bf16 product is bf16(a) @ bf16(b) summed in f32,
    as JAX's preferred_element_type=f32; not a bf16 matmul, whose result is
    rounded to bf16."""
    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.randn(16, 64).astype(np.float32))
    b = torch.from_numpy(rng.randn(64, 8).astype(np.float32))
    got = linear.matmul(a, b, "bfloat16")
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, a.bfloat16().double() @ b.bfloat16().double(), rtol=1e-6, atol=1e-5, check_dtype=False)
    want = jnp.dot(jnp.asarray(a.numpy(), jnp.bfloat16), jnp.asarray(b.numpy(), jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    rounded = (a.bfloat16() @ b.bfloat16()).float()
    assert not torch.equal(got, rounded)
    assert not torch.equal(got.bfloat16().float(), got)


def test_tf32_off_after_import():
    import upnerf_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_pack_fragments_is_the_mma_b_fragment_order():
    """Lane g*4 + t of 8-column tile nt and k-step ks holds
    W[16ks + 8h + 2t + e, 8nt + g] for h, e in {0, 1}: the B operand of
    mma.sync m16n8k16 (registers b0 = h 0, b1 = h 1)."""
    K, N = 64, 24
    w = torch.from_numpy(np.random.RandomState(7).randn(K, N).astype(np.float32))
    packed = rt._pack_fragments(w)
    assert packed.dtype == torch.bfloat16 and packed.shape == (N // 8, K // 16, 8, 4, 2, 2)
    wb = w.bfloat16()
    flat = packed.reshape(N // 8, K // 16, 32, 4)
    for nt in range(N // 8):
        for ks in range(K // 16):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                want = [wb[16 * ks + 8 * h + 2 * t + e, 8 * nt + g] for h in (0, 1) for e in (0, 1)]
                assert torch.equal(flat[nt, ks, lane], torch.stack(want))


def test_kernel_weights_bf16_pads_x0_rows():
    """The bf16 kernel reads x0 as 64 columns: layer 0 and the skip layer get
    zero rows after the 3 + 6L real ones; f32 weights pass through."""
    inputs = make_inputs(8)
    trunk, heads = to_torch(inputs)[5:]
    st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=L, precision="bfloat16")
    ktrunk, kheads = rt._kernel_weights(trunk, heads, st)
    for i, (w, b) in enumerate(trunk):
        want = w
        if i == 0 or i in SKIPS:
            want = torch.cat([w[:IN0], torch.zeros(rt.X0_PAD - IN0, W), w[IN0:]], 0)
        assert torch.equal(ktrunk[i][0], rt._pack_fragments(want)), i
        assert torch.equal(ktrunk[i][1], b)
    assert torch.equal(kheads["feat_w"], rt._pack_fragments(heads["feat_w"]))
    assert kheads["sigma_w"].dtype == torch.bfloat16 and kheads["sigma_w"].shape == (W, 1)
    f32_trunk, _ = rt._kernel_weights(trunk, heads, st._replace(precision="float32"))
    assert all(torch.equal(a[0], b[0]) for a, b in zip(f32_trunk, trunk))
