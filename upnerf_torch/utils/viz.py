"""Visualisation (upnerf/utils/viz.py): JET-coloured depth, PCA feature
images, and a plot of estimated against GT camera frusta (matplotlib, which
the GPU host may not have: its caller turns a failure into a warning)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _jet(x: np.ndarray) -> np.ndarray:
    """OpenCV-style JET colormap for x in [0, 1] -> (..., 3) float in [0, 1]."""
    v = 4.0 * np.clip(x, 0.0, 1.0)
    r = np.clip(np.minimum(v - 1.5, -v + 4.5), 0, 1)
    g = np.clip(np.minimum(v - 0.5, -v + 3.5), 0, 1)
    b = np.clip(np.minimum(v + 0.5, -v + 2.5), 0, 1)
    return np.stack([r, g, b], axis=-1)


def visualize_depth(depth: np.ndarray, min_max: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) uint8 JET image."""
    x = np.nan_to_num(np.asarray(depth, np.float32))
    mi, ma = (float(x.min()), float(x.max())) if min_max is None else min_max
    x = np.clip((x - mi) / (ma - mi + 1e-8), 0, 1)
    return (_jet(x) * 255).astype(np.uint8)


def get_pca_img(feat: np.ndarray, mean: np.ndarray, components: np.ndarray) -> np.ndarray:
    """(H, W, C) features + PCA (mean, 3 x C components) -> (H, W, 3) in [0, 1]."""
    pc = (feat - mean[None, None, :]) @ components.T
    M, m = pc.max(), pc.min()
    return (pc - m) / (M - m + 1e-12)


def get_camera_mesh(pose: np.ndarray, depth: float = 0.5) -> np.ndarray:
    """Camera frustum vertices in world coordinates, (5, 3): 4 image corners + centre."""
    corners = np.array([[-0.5, -0.5, 1], [0.5, -0.5, 1], [0.5, 0.5, 1], [-0.5, 0.5, 1], [0, 0, 0]]) * depth
    R, t = pose[:, :3], pose[:, 3]
    return corners @ R.T + t


def get_pose_image(poses: np.ndarray, gt_poses: np.ndarray, path: Optional[str] = None) -> np.ndarray:
    """3-D plot of estimated (blue) against GT (magenta) camera frusta with red
    error lines between centres; (H, W, 3) uint8."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(5, 5), dpi=100)
    ax = fig.add_subplot(111, projection="3d")
    order = [0, 1, 2, 3, 0, 4, 1, 2, 4, 3]
    for pose, color in [(gt_poses, "magenta"), (poses, "blue")]:
        for p in np.asarray(pose):
            m = get_camera_mesh(p)
            ax.plot(m[order, 0], m[order, 1], m[order, 2], color=color, lw=0.7)
    for p_est, p_gt in zip(np.asarray(poses), np.asarray(gt_poses)):
        ax.plot(*zip(p_est[:, 3], p_gt[:, 3]), color="red", lw=0.8)
    ax.set_box_aspect([1, 1, 1])
    fig.tight_layout()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    if path is not None:
        fig.savefig(path)
    plt.close(fig)
    return img
