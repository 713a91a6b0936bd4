"""Procrustes sim(3) alignment and pose-error metrics (upnerf/geometry/procrustes.py).

Aligns refined poses to ground truth for the rotation / translation errors of
eval, and maps ground-truth test poses into the learned frame for test-time
optimization. The SVDs run in float64 numpy on the host, as in the JAX
package, so both packages pick the same branch (a reflection fix, a
near-degenerate centre set) on the same input.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .se3 import cam2world, compose, invert, make_pose


class Sim3(NamedTuple):
    """Similarity transform aligning point set X1 to X0:
    X1to0 = (X1 - t1) / s1 @ R.T * s0 + t0."""

    t0: torch.Tensor  # (3,)
    t1: torch.Tensor  # (3,)
    s0: torch.Tensor  # scalar
    s1: torch.Tensor  # scalar
    R: torch.Tensor  # (3, 3)


def procrustes_analysis(X0: torch.Tensor, X1: torch.Tensor) -> Sim3:
    """Similarity alignment of two [N, 3] point sets."""
    t0, t1 = X0.mean(dim=0), X1.mean(dim=0)
    X0c, X1c = X0 - t0, X1 - t1
    s0 = torch.sqrt((X0c**2).sum(dim=-1).mean())
    s1 = torch.sqrt((X1c**2).sum(dim=-1).mean())
    M = ((X0c / s0).T @ (X1c / s1)).detach().cpu().numpy().astype(np.float64)
    U, _, Vt = np.linalg.svd(M, full_matrices=False)
    R = np.asarray(U @ Vt, dtype=np.float32)
    if np.linalg.det(R) < 0:
        R[2] *= -1
    return Sim3(t0=t0, t1=t1, s0=s0, s1=s1, R=torch.from_numpy(R).to(X0.device))


def rotation_distance(R1: torch.Tensor, R2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Geodesic angle (rad) between rotations."""
    R_diff = R1 @ R2.transpose(-2, -1)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))


def parse_raw_camera(pose_raw: torch.Tensor) -> torch.Tensor:
    """Reparameterise a raw c2w pose for alignment: flip o pose, inverted,
    then flipped again, with flip = diag(1, -1, -1)."""
    flip = make_pose(R=torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=pose_raw.dtype, device=pose_raw.device)))
    flip = flip.expand(*pose_raw.shape[:-2], 3, 4)
    return compose([flip, invert(compose([flip, pose_raw[..., :3, :]]))])


def gauge_rotation_from_orientations(pose: torch.Tensor, pose_GT: torch.Tensor) -> torch.Tensor:
    """Gauge rotation Q with pose_R_i ~= pose_GT_R_i @ Q, both [N, 3, 4] parsed
    poses: the chordal-L2 mean of {gt_R_i^T pred_R_i}. Unlike the centre-only
    estimate it constrains all three rotational degrees of freedom for planar
    camera rigs (the JAX package's documented deviation, used to initialise
    test poses; the error metrics keep the centre-only estimate)."""
    R_gt = pose_GT[..., :3].detach().cpu().numpy().astype(np.float64)
    R_pr = pose[..., :3].detach().cpu().numpy().astype(np.float64)
    M = np.einsum("nij,nik->jk", R_gt, R_pr)
    U, _, Vt = np.linalg.svd(M, full_matrices=False)
    d = np.sign(np.linalg.det(U @ Vt))
    Q = (U * np.array([1.0, 1.0, d])) @ Vt
    return torch.from_numpy(Q.astype(np.float32)).to(pose.device)


def prealign_cameras(pose: torch.Tensor, pose_GT: torch.Tensor) -> Tuple[torch.Tensor, Sim3]:
    """Procrustes-align the camera centres of `pose` to `pose_GT` (both [N, 3, 4])."""
    center = torch.zeros((1, 1, 3), dtype=pose.dtype, device=pose.device)
    center_pred = cam2world(center, pose)[:, 0]
    center_GT = cam2world(center, pose_GT)[:, 0]
    sim3 = procrustes_analysis(center_GT, center_pred)
    center_aligned = (center_pred - sim3.t1) / sim3.s1 @ sim3.R.T * sim3.s0 + sim3.t0
    R_aligned = pose[..., :3] @ sim3.R.T
    t_aligned = (-R_aligned @ center_aligned[..., None])[..., 0]
    return make_pose(R=R_aligned, t=t_aligned), sim3


def evaluate_camera_alignment(pose_aligned: torch.Tensor, pose_GT: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Rotation (rad) and translation errors."""
    R_error = rotation_distance(pose_aligned[..., :3], pose_GT[..., :3])
    t_error = torch.linalg.norm((pose_aligned[..., 3:] - pose_GT[..., 3:])[..., 0], dim=-1)
    return {"R": R_error, "t": t_error}


def relative_pose_error(poses: torch.Tensor, gt_poses: torch.Tensor) -> Dict[str, np.ndarray]:
    """Gauge-free pose error over all camera pairs (both [N, 3, 4] c2w):
    {"R": pairwise geodesic angle (rad), "t": pairwise relative-translation
    error over the mean GT relative translation}, flat [N (N - 1) / 2]."""
    n = poses.shape[0]
    iu, ju = (torch.from_numpy(a) for a in np.triu_indices(n, k=1))

    def rel_pairs(p):
        return compose([p[ju], invert(p[iu])])  # P_i^-1 o P_j: free of any global gauge

    rel, rel_g = rel_pairs(poses), rel_pairs(gt_poses)
    R_err = rotation_distance(rel[..., :3], rel_g[..., :3]).detach().cpu().numpy()
    t = rel[..., 3].detach().cpu().numpy()
    t_g = rel_g[..., 3].detach().cpu().numpy()
    mean_g = max(float(np.linalg.norm(t_g, axis=-1).mean()), 1e-9)
    scale = float(np.linalg.norm(t, axis=-1).mean()) / mean_g  # one global scale
    t_err = np.linalg.norm(t / max(scale, 1e-9) - t_g, axis=-1) / mean_g
    return {"R": R_err, "t": t_err}


def pose_metric(refine_poses: torch.Tensor, gt_poses: torch.Tensor):
    """End-to-end pose error: (error dict | None when the alignment does not
    converge, aligned poses, parsed GT poses)."""
    refine_poses = parse_raw_camera(refine_poses.float())
    gt_poses = parse_raw_camera(gt_poses.float())
    try:
        aligned_pose, _ = prealign_cameras(refine_poses, gt_poses)
        error = evaluate_camera_alignment(aligned_pose, gt_poses)
        if not bool(torch.isfinite(error["R"]).all()):
            raise FloatingPointError("non-finite rotation error")
    except (np.linalg.LinAlgError, FloatingPointError):
        return None, refine_poses, gt_poses
    return error, aligned_pose, gt_poses
