"""The eval layer of upnerf_torch against the JAX package: the SE(3) log map
and pose algebra, every function of geometry/procrustes.py, the image
metrics and LPIPS (seeded random AlexNet weights; the real npz is not in the
repository), on seeded numpy inputs.

Tolerances: float32 on both sides. Pose algebra and Procrustes 1e-5 absolute
(matrix products in another order); the SVDs run in float64 numpy on the host
in both packages, so the sign / reflection branches agree, including the
planar camera ring where the centre-only estimate is reflection-bistable.
MSE / PSNR 1e-5 relative, SSIM 1e-5 absolute, LPIPS 1e-5 relative (f32
convolutions, TF32 off).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.evaluate import lpips as jlpips
from upnerf.evaluate import metrics as jmetrics
from upnerf.geometry import procrustes as jproc
from upnerf.geometry import se3 as jse3
from upnerf_torch.evaluate import lpips as tlpips
from upnerf_torch.evaluate import metrics as tmetrics
from upnerf_torch.geometry import procrustes as tproc
from upnerf_torch.geometry import se3 as tse3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def close(got, want, atol=1e-5, rtol=0.0):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def random_poses(n, seed, scale=0.5):
    """(n, 3, 4) rigid poses from random se(3) vectors."""
    wu = np.random.RandomState(seed).randn(n, 6).astype(np.float32) * scale
    return np.asarray(jse3.se3_to_SE3(jnp.asarray(wu)))


def ring(n, planar):
    """c2w poses on a ring looking at the origin; heights alternate unless planar."""
    out = []
    for i in range(n):
        a = 2 * np.pi * 0.3 * (i / n - 0.5)
        eye = np.array([3 * np.sin(a), 0.6 + (0 if planar else 0.3 * (-1) ** i), 3 * np.cos(a)])
        f = -eye / np.linalg.norm(eye)
        r = np.cross(f, [0.0, 1.0, 0.0])
        r /= np.linalg.norm(r)
        out.append(np.concatenate([np.stack([r, np.cross(r, f), -f], 1), eye[:, None]], 1))
    return np.stack(out).astype(np.float32)


SE3_FUNCS = {
    "SO3_to_so3": lambda m, x: m.SO3_to_so3(x[..., :3]),
    "SE3_to_se3": lambda m, x: m.SE3_to_se3(x),
    "invert": lambda m, x: m.invert(x),
    "to_hom": lambda m, x: m.to_hom(x[..., 3]),
    "world2cam": lambda m, x: m.world2cam(x[:, :, :3] * 0.7, x),
    "cam2world": lambda m, x: m.cam2world(x[:, :, :3] * 0.7, x),
}


@pytest.mark.parametrize("name", list(SE3_FUNCS))
def test_se3_matches_jax(name):
    poses = random_poses(7, seed=1)
    fn = SE3_FUNCS[name]
    close(fn(tse3, t(poses)), fn(jse3, jnp.asarray(poses)))


def test_se3_log_inverts_exp():
    wu = np.random.RandomState(2).randn(9, 6).astype(np.float32) * 0.6
    close(tse3.SE3_to_se3(tse3.se3_to_SE3(t(wu))), wu, atol=2e-5)


PROC_FUNCS = {
    "procrustes_analysis": lambda m, a, b: tuple(m.procrustes_analysis(a[:, :, 3], b[:, :, 3])),
    "rotation_distance": lambda m, a, b: m.rotation_distance(a[..., :3], b[..., :3]),
    "parse_raw_camera": lambda m, a, b: m.parse_raw_camera(a),
    "gauge_rotation_from_orientations": lambda m, a, b: m.gauge_rotation_from_orientations(a, b),
    "prealign_cameras": lambda m, a, b: m.prealign_cameras(a, b)[0],
    "evaluate_camera_alignment": lambda m, a, b: (m.evaluate_camera_alignment(a, b)["R"],
                                                  m.evaluate_camera_alignment(a, b)["t"]),
    "relative_pose_error": lambda m, a, b: (m.relative_pose_error(a, b)["R"], m.relative_pose_error(a, b)["t"]),
}


@pytest.mark.parametrize("name", list(PROC_FUNCS))
def test_procrustes_matches_jax(name):
    gt = ring(8, planar=False)
    # a sim(3)-transformed, perturbed copy: what a learned frame looks like
    noisy = np.array(jse3.compose([jnp.asarray(random_poses(8, seed=3, scale=0.05)), jnp.asarray(gt)]))
    noisy[..., 3] = noisy[..., 3] * 0.5 + 0.2
    # in the parsed (w2c-like) form the eval code aligns: camera centres spread out
    noisy, gt = (np.asarray(jproc.parse_raw_camera(jnp.asarray(p))) for p in (noisy, gt))
    fn = PROC_FUNCS[name]
    got = fn(tproc, t(noisy), t(gt))
    want = fn(jproc, jnp.asarray(noisy), jnp.asarray(gt))
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        close(g, w, atol=2e-5)


@pytest.mark.parametrize("planar", [False, True], ids=["helix", "planar"])
def test_pose_metric_matches_jax(planar):
    """pose_metric on an identity-frame copy of GT: ~0 on the non-planar rig;
    on the planar ring the centre-only Procrustes is reflection-bistable and
    both packages land on the same (~180 degree) branch."""
    gt = ring(8, planar=planar)
    refined = np.asarray(jse3.compose([jnp.asarray(random_poses(8, seed=4, scale=0.01)), jnp.asarray(gt)]))
    err, aligned, gt_parsed = tproc.pose_metric(t(refined), t(gt))
    jerr, jaligned, jgt = jproc.pose_metric(jnp.asarray(refined), jnp.asarray(gt))
    assert (err is None) == (jerr is None)
    close(err["R"], jerr["R"], atol=2e-5)
    close(err["t"], jerr["t"], atol=2e-5)
    close(aligned, jaligned, atol=2e-5)
    close(gt_parsed, jgt)
    if not planar:
        assert float(err["R"].max()) < 0.05


@pytest.mark.parametrize("hw", [(24, 32), (17, 9)])
def test_image_metrics_match_jax(hw):
    rng = np.random.RandomState(sum(hw))
    gt = rng.rand(*hw, 3).astype(np.float32)
    pred = np.clip(gt + rng.randn(*hw, 3).astype(np.float32) * 0.05, 0, 1)
    mask = rng.rand(*hw) > 0.3
    close(tmetrics.mse(t(pred), t(gt)), jmetrics.mse(jnp.asarray(pred), jnp.asarray(gt)), atol=0, rtol=1e-5)
    close(tmetrics.psnr(t(pred), t(gt)), jmetrics.psnr(jnp.asarray(pred), jnp.asarray(gt)), atol=0, rtol=1e-5)
    close(tmetrics.psnr(t(pred), t(gt), torch.from_numpy(mask)),
          jmetrics.psnr(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask)), atol=0, rtol=1e-5)
    close(tmetrics.ssim(t(pred), t(gt)), jmetrics.ssim(jnp.asarray(pred), jnp.asarray(gt)), atol=1e-5)
    close(tmetrics.ssim(t(gt), t(gt)), 1.0, atol=1e-6)


def lpips_weights(seed=0):
    """Seeded AlexNet-LPIPS weights in the npz asset's layout."""
    rng = np.random.RandomState(seed)
    w, cin = {}, 3
    for i, (cout, k, _, _) in enumerate(jlpips._ALEX):
        w[f"conv{i}_w"] = (rng.randn(cout, cin, k, k) * (cin * k * k) ** -0.5).astype(np.float32)
        w[f"conv{i}_b"] = (rng.randn(cout) * 0.1).astype(np.float32)
        w[f"lin{i}"] = rng.uniform(0, 1, cout).astype(np.float32)
        cin = cout
    return w


def test_lpips_matches_jax_with_random_weights(tmp_path, monkeypatch):
    weights = lpips_weights()
    rng = np.random.RandomState(5)
    a = rng.rand(64, 72, 3).astype(np.float32)
    b = np.clip(a + rng.randn(64, 72, 3).astype(np.float32) * 0.1, 0, 1)
    want = jlpips.LPIPS(weights)(a, b)
    got = tlpips.LPIPS(weights)(a, b)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tlpips.LPIPS(weights)(a, a) == 0.0
    # both packages load the same npz through UPNERF_LPIPS_WEIGHTS
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **weights)
    monkeypatch.setenv("UPNERF_LPIPS_WEIGHTS", str(path))
    np.testing.assert_allclose(tlpips.load_lpips()(a, b), jlpips.load_lpips()(a, b), rtol=1e-5)
    monkeypatch.delenv("UPNERF_LPIPS_WEIGHTS")
    assert tlpips.load_lpips() is None
