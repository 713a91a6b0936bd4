"""upnerf_torch.geometry against upnerf.geometry (JAX), same numpy inputs,
float32 on both sides. Tolerance 1e-6 absolute: the same f32 formulas, with
the order of a few sums and products left to each framework."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.geometry import rays as jrays
from upnerf.geometry import se3 as jse3
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
