"""upnerf_torch.render.{sampling,volume} against upnerf.render (JAX), same
numpy inputs and the same pre-drawn uniforms, float32. Tolerance 1e-5
absolute: depths up to 5 carry f32 rounding of a few 1e-7 each step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.render import sampling as jsamp
from upnerf.render import volume as jvol
from upnerf_torch.render import sampling as tsamp
from upnerf_torch.render import volume as tvol

ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(t: torch.Tensor, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def near_far(R=6, seed=0):
    rng = np.random.RandomState(seed)
    near = rng.uniform(0.1, 0.5, (R, 1)).astype(np.float32)
    far = near + rng.uniform(2.0, 4.5, (R, 1)).astype(np.float32)
    return near, far


@pytest.mark.parametrize("use_disp", [False, True])
def test_stratified_z_vals_det(use_disp):
    near, far = near_far()
    got = tsamp.stratified_z_vals(torch.from_numpy(near), torch.from_numpy(far), 17, use_disp=use_disp)
    want = jsamp.stratified_z_vals(None, jnp.asarray(near), jnp.asarray(far), 17, use_disp=use_disp)
    assert got.shape == (6, 17)
    close(got, want)


@pytest.mark.parametrize("perturb", [1.0, 0.5])
def test_stratified_z_vals_with_u(perturb):
    near, far = near_far(seed=1)
    u = np.random.RandomState(2).rand(6, 17).astype(np.float32)
    got = tsamp.stratified_z_vals(
        torch.from_numpy(near), torch.from_numpy(far), 17, perturb=perturb, u=torch.from_numpy(u)
    )
    want = jsamp.stratified_z_vals(None, jnp.asarray(near), jnp.asarray(far), 17, perturb=perturb, u=jnp.asarray(u))
    close(got, want)


def test_stratified_z_vals_generator_draws_in_bins():
    near, far = near_far(seed=3)
    z_det = tsamp.stratified_z_vals(torch.from_numpy(near), torch.from_numpy(far), 9)
    z = tsamp.stratified_z_vals(
        torch.from_numpy(near), torch.from_numpy(far), 9, perturb=1.0, generator=torch.Generator().manual_seed(0)
    )
    mid = 0.5 * (z_det[:, 1:] + z_det[:, :-1])
    assert (z[:, 1:-1] >= mid[:, :-1]).all() and (z[:, 1:-1] <= mid[:, 1:]).all()
    assert not torch.equal(z, z_det)


def pdf_inputs(seed=4, R=5, M=14):
    rng = np.random.RandomState(seed)
    bins = np.sort(rng.uniform(0.1, 5.0, (R, M + 1)), -1).astype(np.float32)
    # Generic rows keep every bin's mass well above 0: a sample drawn from a
    # bin of mass p moves by (bin width / p) times the cdf's rounding, and
    # the frameworks sum the cdf in different orders.
    weights = rng.uniform(0.2, 1.0, (R, M)).astype(np.float32)
    weights[0] = 0.0  # all-zero row: the eps floor makes it uniform
    # Mass on the last bins only: u = 0 lands in a bin whose cdf step
    # (eps / sum) is far below eps, so the denom guard decides the sample.
    # A flat stretch just below cdf = 1 is avoided: there where u = 1 lands
    # depends on the last bit of the cumsum, which differs between the
    # frameworks' summation orders.
    weights[1] = 0.0
    weights[1, -3:] = [20.0, 35.0, 10.0]
    return bins, weights


@pytest.mark.parametrize("n", [8, 33])
def test_sample_pdf_det(n):
    bins, weights = pdf_inputs()
    got = tsamp.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), n, det=True)
    want = jsamp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(weights), n, det=True)
    assert got.shape == (5, n)
    close(got, want)


def test_sample_pdf_with_u():
    bins, weights = pdf_inputs(seed=5)
    u = np.random.RandomState(6).rand(5, 21).astype(np.float32)
    u[0, :3] = [0.0, 1.0, 0.5]
    got = tsamp.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), 21, u=torch.from_numpy(u))
    want = jsamp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(weights), 21, u=jnp.asarray(u))
    close(got, want)


def test_merge_sorted_z():
    rng = np.random.RandomState(7)
    a = np.sort(rng.rand(4, 6), -1).astype(np.float32)
    b = rng.rand(4, 5).astype(np.float32)
    got = tvol.merge_sorted_z(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jvol.merge_sorted_z(jnp.asarray(a), jnp.asarray(b))))


def test_volume_helpers():
    rng = np.random.RandomState(8)
    z = np.sort(rng.uniform(0.1, 5.0, (4, 12)), -1).astype(np.float32)
    s_sig = rng.uniform(0.0, 3.0, (4, 12)).astype(np.float32)
    c_sig = rng.uniform(0.0, 3.0, (4, 12)).astype(np.float32)
    vals = rng.rand(4, 12, 3).astype(np.float32)
    T = {k: torch.from_numpy(v) for k, v in dict(z=z, s=s_sig, c=c_sig, v=vals).items()}
    J = {k: jnp.asarray(v) for k, v in dict(z=z, s=s_sig, c=c_sig, v=vals).items()}

    close(tvol.deltas_from_z(T["z"]), jvol.deltas_from_z(J["z"]))
    td, jd = tvol.deltas_from_z(T["z"]), jvol.deltas_from_z(J["z"])
    ta, ja = tvol.alpha_from_sigma(T["s"], td), jvol.alpha_from_sigma(J["s"], jd)
    close(ta, ja)
    close(tvol.transmittance_of(ta), jvol.transmittance_of(ja))
    tw, jw = tvol.composite_weights(ta), jvol.composite_weights(ja)
    close(tw, jw)
    close(tvol.weighted_sum(tw, T["v"]), jvol.weighted_sum(jw, J["v"]))
    close(tvol.depth_map(tw, T["z"]), jvol.depth_map(jw, J["z"]))
    for t_out, j_out in zip(tvol.split_alphas(T["s"], T["c"], td), jvol.split_alphas(J["s"], J["c"], jd)):
        close(t_out, j_out)
