"""Quaternion operations (upnerf/geometry/quaternion.py).

Quaternions are (..., 4) tensors ordered (w, x, y, z).
"""

from __future__ import annotations

import numpy as np
import torch


def q_to_R(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix, (..., 4) -> (..., 3, 3)."""
    qa, qb, qc, qd = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (qc**2 + qd**2), 2 * (qb * qc - qa * qd), 2 * (qa * qc + qb * qd)], -1),
            torch.stack([2 * (qb * qc + qa * qd), 1 - 2 * (qb**2 + qd**2), 2 * (qc * qd - qa * qb)], -1),
            torch.stack([2 * (qb * qd - qa * qc), 2 * (qa * qb + qc * qd), 1 - 2 * (qb**2 + qc**2)], -1),
        ],
        -2,
    )


def R_to_q(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rotation matrix -> quaternion with w >= 0, (..., 3, 3) -> (..., 4),
    by the eigenvector method: the branch-free formulation, robust for every
    rotation. The difference terms' signs make it the inverse of q_to_R
    (the reference's own fallback, utils/camera.py:190-234, is not). Runs in
    numpy on the host, in the input's precision, as the JAX package does;
    the result is float32 on the input's device."""
    Rn = R.detach().cpu().numpy()
    Rf = Rn.reshape(-1, 3, 3)
    out = np.empty((len(Rf), 4), np.float32)
    for i, M in enumerate(Rf):
        R00, R01, R02 = M[0]
        R10, R11, R12 = M[1]
        R20, R21, R22 = M[2]
        K = np.array([
            [R00 - R11 - R22, R10 + R01, R20 + R02, R21 - R12],
            [R10 + R01, R11 - R00 - R22, R21 + R12, R02 - R20],
            [R20 + R02, R21 + R12, R22 - R00 - R11, R10 - R01],
            [R21 - R12, R02 - R20, R10 - R01, R00 + R11 + R22],
        ]) / 3.0
        eigval, eigvec = np.linalg.eigh(K)
        V = eigvec[:, eigval.argmax()]
        q = np.array([V[3], V[0], V[1], V[2]], np.float32)
        out[i] = -q if q[0] < 0 else q
    return torch.from_numpy(out.reshape(*Rn.shape[:-2], 4)).to(R.device)


def invert(q: torch.Tensor) -> torch.Tensor:
    """The inverse quaternion: the conjugate over the squared norm."""
    conj = q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)
    return conj / (q**2).sum(-1, keepdim=True)


def product(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 q2."""
    a1, b1, c1, d1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    a2, b2, c2, d2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
            a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
            a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
            a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
        ],
        -1,
    )
