"""The CUDA fused forward render kernel against its plain PyTorch version, on
the card, at the brandenburg_gate width (D=8, W=256, skip 4, F=384, HH=128,
L=10). Every test here needs an NVIDIA card: it carries the `cuda` marker
and skips without one.

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
D, SKIPS, W, F, HH, L = 8, (4,), 256, 384, 128, 10


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def make_inputs(R, S, device, seed=0):
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
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [128, 256, 100])
def test_kernel_matches_plain(cuda_device, precision, S):
    inputs = make_inputs(300, S, cuda_device)
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
    with pytest.raises(RuntimeError, match="forward-only"):
        rt.render_train_rays_fwd(o, d, z, pe_w, cond.requires_grad_(), trunk, heads, st)
