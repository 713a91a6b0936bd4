"""upnerf_torch.geometry against upnerf.geometry (JAX), same numpy inputs,
float32 on both sides. Tolerance 1e-6 absolute: the same f32 formulas, with
the order of a few sums and products left to each framework. Covers the
se(3) / so(3) exp maps, pose composition, the novel-view orbit, rays (pixel
directions, the full-image grid, NDC) and the quaternions (R_to_q also at
the rotations where its largest eigenvalue changes hands: angles 0, pi / 2
and pi about each axis, and pi about a diagonal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upnerf.geometry as jgeometry
import upnerf_torch.geometry as tgeometry
from upnerf.geometry import quaternion as jquat
from upnerf.geometry import rays as jrays
from upnerf.geometry import se3 as jse3
from upnerf_torch.geometry import quaternion as tquat
from upnerf_torch.geometry import rays as trays
from upnerf_torch.geometry import se3 as tse3

ATOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(t: torch.Tensor, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.mark.parametrize("scale", [0.0, 1e-4, 0.3, 1.5])
def test_se3_to_SE3(scale):
    wu = (np.random.RandomState(0).randn(5, 6) * scale).astype(np.float32)
    close(tse3.se3_to_SE3(torch.from_numpy(wu)), jse3.se3_to_SE3(jnp.asarray(wu)))


def test_se3_to_SE3_identity_at_zero():
    out = tse3.se3_to_SE3(torch.zeros(6))
    assert torch.equal(out, torch.eye(3, 4))


def test_compose():
    rng = np.random.RandomState(1)
    poses = [np.asarray(jse3.se3_to_SE3(jnp.asarray(rng.randn(4, 6).astype(np.float32) * 0.5))) for _ in range(3)]
    close(tse3.compose([torch.from_numpy(p) for p in poses]), jse3.compose([jnp.asarray(p) for p in poses]))


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_get_novel_view_poses(scale):
    wu = (np.random.RandomState(2).randn(6) * 0.2).astype(np.float32)
    anchor = np.asarray(jse3.compose([jse3.se3_to_SE3(jnp.asarray(wu)), jnp.eye(3, 4)]))
    got = tse3.get_novel_view_poses(torch.from_numpy(anchor), N=7, scale=scale)
    assert got.shape == (7, 3, 4)
    close(got, jse3.get_novel_view_poses(jnp.asarray(anchor), N=7, scale=scale), atol=2 * ATOL)


def test_angle_to_rotation_matrix():
    a = np.linspace(-1.0, 1.0, 5, dtype=np.float32)
    for axis in "XYZ":
        close(tse3.angle_to_rotation_matrix(torch.from_numpy(a), axis), jse3.angle_to_rotation_matrix(jnp.asarray(a), axis))


@pytest.mark.parametrize("per_ray_K", [False, True])
def test_pixel_directions(per_ray_K):
    rng = np.random.RandomState(3)
    px = rng.randint(0, 40, 9).astype(np.float32)
    py = rng.randint(0, 30, 9).astype(np.float32)
    K = np.array([[35.0, 0, 20.0], [0, 33.0, 15.0], [0, 0, 1]], np.float32)
    if per_ray_K:
        K = np.broadcast_to(K, (9, 3, 3)) * rng.uniform(0.9, 1.1, (9, 1, 1)).astype(np.float32)
        K = np.ascontiguousarray(K, np.float32)
    got = trays.pixel_directions(torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(K))
    close(got, jrays.pixel_directions(jnp.asarray(px), jnp.asarray(py), jnp.asarray(K)))


@pytest.mark.parametrize("per_ray_pose", [False, True])
def test_get_rays(per_ray_pose):
    rng = np.random.RandomState(4)
    dirs = np.concatenate([rng.randn(6, 2), -np.ones((6, 1))], -1).astype(np.float32)
    n = 6 if per_ray_pose else 1
    c2w = np.asarray(jse3.se3_to_SE3(jnp.asarray(rng.randn(n, 6).astype(np.float32) * 0.4)))
    if not per_ray_pose:
        c2w = c2w[0]
    o_t, d_t = trays.get_rays(torch.from_numpy(dirs), torch.from_numpy(c2w))
    o_j, d_j = jrays.get_rays(jnp.asarray(dirs), jnp.asarray(c2w))
    close(o_t, o_j)
    close(d_t, d_j)


@pytest.mark.parametrize("scale", [0.0, 1e-4, 0.3, 1.5])
def test_so3_to_SO3(scale):
    w = (np.random.RandomState(5).randn(7, 3) * scale).astype(np.float32)
    close(tse3.so3_to_SO3(torch.from_numpy(w)), jse3.so3_to_SO3(jnp.asarray(w)))


def test_get_ray_directions():
    K = np.array([[35.0, 0, 20.5], [0, 33.0, 15.0], [0, 0, 1]], np.float32)
    got = trays.get_ray_directions(30, 41, torch.from_numpy(K))
    assert got.shape == (30, 41, 3) and got.dtype == torch.float32
    close(got, jrays.get_ray_directions(30, 41, K))


def test_get_ndc_rays():
    rng = np.random.RandomState(6)
    o = (rng.randn(11, 3) * 0.3).astype(np.float32)
    d = np.concatenate([rng.randn(11, 2) * 0.3, -np.ones((11, 1))], -1).astype(np.float32)
    got = trays.get_ndc_rays(48, 64, 50.0, 1.0, torch.from_numpy(o), torch.from_numpy(d))
    want = jrays.get_ndc_rays(48, 64, 50.0, 1.0, jnp.asarray(o), jnp.asarray(d))
    for g, w in zip(got, want):
        close(g, w, atol=1e-5 * max(1.0, float(np.abs(np.asarray(w)).max())))


def _rotations() -> np.ndarray:
    """Random rotations, and those where R_to_q's largest eigenvalue changes
    hands: angle 0, pi / 2, pi about each axis and pi about a diagonal."""
    rng = np.random.RandomState(7)
    w = [rng.randn(3) * s for s in (0.1, 1.0, 2.0, 3.0)]
    for axis in np.eye(3):
        w += [axis * a for a in (0.0, np.pi / 2, np.pi - 1e-4, np.pi)]
    w.append(np.ones(3) / np.sqrt(3.0) * np.pi)
    return np.asarray(jse3.so3_to_SO3(jnp.asarray(np.asarray(w, np.float32))))


def test_R_to_q():
    R = _rotations()
    got = tquat.R_to_q(torch.from_numpy(R))
    want = np.asarray(jquat.R_to_q(jnp.asarray(R)))
    assert got.shape == (len(R), 4) and got.dtype == torch.float32
    close(got, want)
    assert (got[:, 0] >= 0).all()
    # q_to_R inverts it (a 180-degree turn's q and -q give the same R)
    close(tquat.q_to_R(got), R, atol=1e-5)


def test_quaternion_algebra():
    rng = np.random.RandomState(8)
    q1, q2 = (rng.randn(2, 5, 4).astype(np.float32))
    unit = q1 / np.linalg.norm(q1, axis=-1, keepdims=True)
    close(tquat.q_to_R(torch.from_numpy(unit)), jquat.q_to_R(jnp.asarray(unit)))
    close(tquat.invert(torch.from_numpy(q1)), jquat.invert(jnp.asarray(q1)))
    close(tquat.product(torch.from_numpy(q1), torch.from_numpy(q2)), jquat.product(jnp.asarray(q1), jnp.asarray(q2)),
          atol=1e-5)
    ident = tquat.product(torch.from_numpy(q1), tquat.invert(torch.from_numpy(q1)))
    close(ident, np.broadcast_to(np.array([1.0, 0, 0, 0], np.float32), (5, 4)))


def test_geometry_exports_match_jax():
    assert sorted(tgeometry.__all__) == sorted(jgeometry.__all__)
    assert all(hasattr(tgeometry, name) for name in tgeometry.__all__)
