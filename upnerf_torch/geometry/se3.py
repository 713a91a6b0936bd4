"""SE(3) / SO(3) exp and log maps and [R|t] pose algebra (upnerf/geometry/se3.py).

Functions broadcast over leading batch dims. The exp and log maps use the
same 10-term Taylor series as the reference, so the exp map is exact and safe
at w = 0 (the se3 refinement table is zero-initialised).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def _norm(w: torch.Tensor) -> torch.Tensor:
    """||w|| over the last axis; 0 (not NaN) at w == 0."""
    sq = (w**2).sum(dim=-1)
    return torch.where(sq == 0, torch.zeros_like(sq), torch.sqrt(torch.where(sq == 0, torch.ones_like(sq), sq)))


def skew_symmetric(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    O = torch.zeros_like(w0)
    return torch.stack(
        [
            torch.stack([O, -w2, w1], dim=-1),
            torch.stack([w2, O, -w0], dim=-1),
            torch.stack([-w1, w0, O], dim=-1),
        ],
        dim=-2,
    )


def taylor_A(x: torch.Tensor, nth: int = 10) -> torch.Tensor:
    """Taylor expansion of sin(x)/x."""
    ans = torch.zeros_like(x)
    denom = 1.0
    for i in range(nth + 1):
        if i > 0:
            denom *= (2 * i) * (2 * i + 1)
        ans = ans + (-1) ** i * x ** (2 * i) / denom
    return ans


def taylor_B(x: torch.Tensor, nth: int = 10) -> torch.Tensor:
    """Taylor expansion of (1-cos(x))/x**2."""
    ans = torch.zeros_like(x)
    denom = 1.0
    for i in range(nth + 1):
        denom *= (2 * i + 1) * (2 * i + 2)
        ans = ans + (-1) ** i * x ** (2 * i) / denom
    return ans


def taylor_C(x: torch.Tensor, nth: int = 10) -> torch.Tensor:
    """Taylor expansion of (x-sin(x))/x**3."""
    ans = torch.zeros_like(x)
    denom = 1.0
    for i in range(nth + 1):
        denom *= (2 * i + 2) * (2 * i + 3)
        ans = ans + (-1) ** i * x ** (2 * i) / denom
    return ans


def se3_to_SE3(wu: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3): [..., 6] -> [..., 3, 4]."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew_symmetric(w)
    theta = _norm(w)[..., None, None]
    I = torch.eye(3, dtype=wu.dtype, device=wu.device)
    A, B, C = taylor_A(theta), taylor_B(theta), taylor_C(theta)
    wxwx = wx @ wx
    R = I + A * wx + B * wxwx
    V = I + B * wx + C * wxwx
    return torch.cat([R, V @ u[..., None]], dim=-1)


def SO3_to_so3(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Log map SO(3) -> so(3): [..., 3, 3] -> [..., 3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.remainder(torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps)), math.pi)[..., None, None]
    lnR = 1 / (2 * taylor_A(theta) + 1e-8) * (R - R.transpose(-2, -1))  # explodes at theta == pi
    return torch.stack([lnR[..., 2, 1], lnR[..., 0, 2], lnR[..., 1, 0]], dim=-1)


def SE3_to_se3(Rt: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Log map SE(3) -> se(3): [..., 3, 4] -> [..., 6]."""
    R, t = Rt[..., :3], Rt[..., 3:]
    w = SO3_to_so3(R)
    wx = skew_symmetric(w)
    theta = _norm(w)[..., None, None]
    I = torch.eye(3, dtype=Rt.dtype, device=Rt.device)
    A, B = taylor_A(theta), taylor_B(theta)
    invV = I - 0.5 * wx + (1 - A / (2 * B)) / (theta**2 + eps) * (wx @ wx)
    return torch.cat([w, (invV @ t)[..., 0]], dim=-1)


def make_pose(R: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[..., 3, 4] pose from R and/or t."""
    if R is None and t is None:
        raise ValueError("make_pose needs R or t")
    if R is None:
        R = torch.eye(3, dtype=t.dtype, device=t.device).expand(*t.shape[:-1], 3, 3)
    elif t is None:
        t = torch.zeros(R.shape[:-1], dtype=R.dtype, device=R.device)
    return torch.cat([R, t[..., None]], dim=-1)


def invert(pose: torch.Tensor) -> torch.Tensor:
    """Inverse of a [..., 3, 4] pose."""
    R_inv = pose[..., :3].transpose(-2, -1)
    return make_pose(R=R_inv, t=(-R_inv @ pose[..., 3:])[..., 0])


def compose_pair(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """pose_new(x) = pose_b o pose_a(x)."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return make_pose(R=R_b @ R_a, t=(R_b @ t_a + t_b)[..., 0])


def compose(pose_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """poseN o ... o pose1."""
    pose_new = pose_list[0]
    for pose in pose_list[1:]:
        pose_new = compose_pair(pose_new, pose)
    return pose_new


def to_hom(X: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 4] homogeneous coordinates."""
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def world2cam(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] x [..., 3, 4] -> [..., N, 3]."""
    return to_hom(X) @ pose.transpose(-1, -2)


def cam2world(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] x [..., 3, 4] -> [..., N, 3]."""
    return to_hom(X) @ invert(pose).transpose(-1, -2)


def angle_to_rotation_matrix(a: torch.Tensor, axis: str) -> torch.Tensor:
    """Rotation by angle(s) `a` about X, Y or Z: [...] -> [..., 3, 3]."""
    roll = dict(X=1, Y=2, Z=0)[axis]
    O, I = torch.zeros_like(a), torch.ones_like(a)
    M = torch.stack(
        [
            torch.stack([torch.cos(a), -torch.sin(a), O], -1),
            torch.stack([torch.sin(a), torch.cos(a), O], -1),
            torch.stack([O, O, I], -1),
        ],
        -2,
    )
    return torch.roll(M, shifts=(roll, roll), dims=(-2, -1))


def get_novel_view_poses(pose_anchor: torch.Tensor, N: int = 60, scale: float = 1.0) -> torch.Tensor:
    """(N, 3, 4) circular novel-view path around a (3, 4) anchor camera."""
    dev, dt = pose_anchor.device, pose_anchor.dtype
    theta = torch.arange(N, device=dev).to(dt) / N * 2 * math.pi
    R_x = angle_to_rotation_matrix(torch.arcsin(torch.sin(theta) * 0.05), "X")
    R_y = angle_to_rotation_matrix(torch.arcsin(torch.cos(theta) * 0.05), "Y")
    pose_rot = make_pose(R=R_y @ R_x)
    shift = make_pose(t=torch.tensor([0.0, 0.0, -4.0 * scale], dtype=dt, device=dev)).expand(N, 3, 4)
    shift2 = make_pose(t=torch.tensor([0.0, 0.0, 3.8 * scale], dtype=dt, device=dev)).expand(N, 3, 4)
    pose_oscil = compose([shift, pose_rot, shift2])
    return compose([pose_oscil, pose_anchor.expand(N, 3, 4)])
