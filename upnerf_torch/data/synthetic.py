"""Synthetic on-disk scene generator (upnerf/data/synthetic.py).

Writes a self-contained custom-format scene from a seed: images,
metadata.json, DINO feature maps + PCA infos, DPT inverse-depth maps; with
phototourism_layout=True also the tsv and COLMAP binaries of the same
scene. `generate_scene` is the JAX generator's, file for file: the same
`NNN.jpg` bytes (the port's JPEG encoder, upnerf_torch/features/jpeg.py, at
PIL's quality 95), the same metadata.json, and the same feature maps (PIL's
8-bit BILINEAR through `resize_u8`), PCA infos and DPT arrays, with no PIL
on the host. `upnerf_torch.data.load_custom` and `load_phototourism` read
the scene as they read any other.
"""

from __future__ import annotations

import json
import os

import numpy as np

from upnerf_torch.features.images import resize_u8
from upnerf_torch.features.jpeg import write_jpeg

from . import colmap


def _camera_ring(n: int, radius: float = 3.0, height: float = 0.6, arc: float = 0.2):
    """c2w poses (right-up-back) on a ring looking at the origin.

    arc: fraction of the full circle spanned. Small arcs give heavy view
    overlap (easy photometry, but pose recovery from identity init is
    ill-conditioned when many cameras nearly coincide); use ~0.5 for
    pose-convergence testbeds."""
    poses = []
    for i in range(n):
        ang = 2 * np.pi * i / max(n, 1) * arc
        eye = np.array([radius * np.sin(ang), height, radius * np.cos(ang)])
        forward = -eye / np.linalg.norm(eye)  # toward origin
        right = np.cross(forward, np.array([0.0, 1.0, 0.0]))
        right /= np.linalg.norm(right)
        up = np.cross(right, forward)
        # columns: x right, y up, z back (-forward)
        R = np.stack([right, up, -forward], axis=1)
        poses.append(np.concatenate([R, eye[:, None]], 1))
    return np.stack(poses).astype(np.float32)


def _sphere_hit(o: np.ndarray, d: np.ndarray, center: np.ndarray, r: float):
    """Nearest positive ray-sphere intersection distance (inf if none)."""
    oc = o - center
    b = 2 * (d @ oc)
    c = oc @ oc - r * r
    disc = b**2 - 4 * c
    tt = (-b - np.sqrt(np.maximum(disc, 0))) / 2
    return np.where((disc > 0) & (tt > 1e-3), tt, np.inf)


def _render_image(pose: np.ndarray, K: np.ndarray, H: int, W: int):
    """Analytic scene with world-anchored high-frequency texture: two
    patterned spheres over a checkered ground plane, gradient sky.

    Pose-free NeRF recovers ROTATIONS only when the photometric/feature
    landscape has texture gradients; the earlier smooth sphere + gradient
    background gave near-zero rotation signal, and identity-initialized
    training only ever optimized translations (see docs/DESIGN.md pose
    audit). Returns (rgb u8, inverse depth).
    """
    jj, ii = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dirs = np.stack(
        [
            (ii - K[0, 2]) / K[0, 0],
            -(jj - K[1, 2]) / K[1, 1],
            -np.ones_like(ii, np.float64),
        ],
        -1,
    )
    R, t = pose[:, :3], pose[:, 3]
    d = dirs @ R.T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = t

    c2 = np.array([1.5, -0.1, 0.6])
    t1 = _sphere_hit(o, d, np.zeros(3), 1.0)
    t2 = _sphere_hit(o, d, c2, 0.45)
    # ground plane y = -1.2 (only in front of the camera)
    denom = d[..., 1]
    tp = np.where(np.abs(denom) > 1e-6, (-1.2 - o[1]) / denom, np.inf)
    tp = np.where(tp > 1e-3, tp, np.inf)

    depth = np.minimum(np.minimum(t1, t2), tp)
    hit_any = np.isfinite(depth)
    p = o + d * np.where(hit_any, depth, 0.0)[..., None]

    rgb = np.empty((H, W, 3), np.float32)
    # sky: smooth direction gradient (no parallax; fine — it is never the
    # argmax of the pose gradient)
    rgb[..., 0] = 0.5 + 0.4 * d[..., 0]
    rgb[..., 1] = 0.5 + 0.4 * d[..., 1]
    rgb[..., 2] = 0.65

    # ground: world-anchored checkerboard (strong parallax + texture)
    plane = depth == tp
    checker = ((np.floor(p[..., 0] / 0.6) + np.floor(p[..., 2] / 0.6)) % 2)
    ground = np.where(
        checker[..., None] > 0.5,
        np.array([0.85, 0.8, 0.7]),
        np.array([0.25, 0.3, 0.35]),
    ).astype(np.float32)
    # fade the checker out with distance: the far field otherwise aliases
    # into Moire noise at these small image sizes
    fade = np.clip((depth - 3.0) / 3.0, 0.0, 1.0)[..., None].astype(np.float32)
    ground = ground * (1 - fade) + np.float32(0.55) * fade
    rgb[plane] = ground[plane]

    # big sphere: spherical checker (crisp, world-anchored) + normal tint
    s1 = depth == t1
    n1 = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    az1 = np.arctan2(n1[..., 2], n1[..., 0])
    el1 = np.arctan2(n1[..., 1], np.linalg.norm(n1[..., [0, 2]], axis=-1))
    check1 = ((np.floor(az1 / 0.45) + np.floor(el1 / 0.45)) % 2)
    sph1 = np.where(
        check1[..., None] > 0.5,
        np.array([0.9, 0.2, 0.25]),
        np.array([0.95, 0.9, 0.3]),
    ).astype(np.float32)
    sph1 *= (0.6 + 0.4 * (0.5 + 0.5 * n1[..., 1]))[..., None]
    rgb[s1] = sph1[s1]

    # small sphere: tight checker in spherical angle
    s2 = depth == t2
    q = p - c2
    az = np.arctan2(q[..., 2], q[..., 0])
    el = np.arctan2(q[..., 1], np.linalg.norm(q[..., [0, 2]], axis=-1))
    check2 = ((np.floor(az / 0.5) + np.floor(el / 0.5)) % 2)
    sph2 = np.where(
        check2[..., None] > 0.5,
        np.array([0.95, 0.55, 0.15]),
        np.array([0.15, 0.25, 0.8]),
    ).astype(np.float32)
    rgb[s2] = sph2[s2]

    depth = np.where(hit_any, depth, 6.0)
    inv_depth = 1.0 / np.maximum(depth, 1e-3)
    return (
        (np.clip(rgb, 0, 1) * 255).astype(np.uint8),
        inv_depth.astype(np.float32),
        p.astype(np.float32),      # world hit points (sky: origin-projected)
        hit_any,
        d.astype(np.float32),
    )


def generate_scene(
    out_dir: str,
    n_train: int = 3,
    n_test: int = 1,
    H: int = 40,
    W: int = 48,
    feat_hw: int = 8,
    feat_dim: int = 16,
    focal: float = 40.0,
    seed: int = 0,
    phototourism_layout: bool = False,
    arc: float = 0.2,
    feature_mode: str = "color",
    interleave_test: bool = False,
) -> dict:
    """Write a complete scene under out_dir; returns the metadata dict.

    interleave_test: by default the test cameras sit at the END of the arc
    (extrapolating past the train views). With True, test indices are
    spread evenly through the arc's interior so every test view
    interpolates between adjacent train views — the well-conditioned
    setting for TTO benchmarks (a test camera outside the training view
    frustum union renders unreconstructed space regardless of pose
    quality).

    feature_mode:
      "color" — sinusoidal projections of local image color (round-1
        stand-in). View-consistent only where color is locally unique;
        checker textures repeat, so wide-baseline matching is ambiguous and
        identity-init pose recovery stalls (docs/DESIGN.md pose study).
      "world" — random Fourier embedding of the WORLD surface point hit by
        each feature cell's center ray: globally unique, perfectly
        view-consistent landmarks — the property real DINO descriptors
        supply for the reference's identity-init training
        (datasets/phototourism.py:199-202). Use for identity-init pose
        benchmarks.
    """
    rng = np.random.RandomState(seed)
    n = n_train + n_test
    poses = _camera_ring(n, arc=arc)
    if interleave_test:
        test_ids = {
            int(round((j + 1) * n / (n_test + 1))) for j in range(n_test)
        }
        assert len(test_ids) == n_test, (
            f"test views collide at n={n}, n_test={n_test}; "
            "use more total views"
        )
    else:
        test_ids = set(range(n_train, n))
    # One shared color->feature projection for ALL images (view consistency).
    feat_proj = rng.randn(3, feat_dim).astype(np.float32)
    feat_phase = rng.uniform(0, 2 * np.pi, feat_dim).astype(np.float32)
    feat_freq = rng.uniform(2.0, 6.0, feat_dim).astype(np.float32)
    # world mode: multi-octave random Fourier basis over xyz
    world_B = (
        rng.randn(3, feat_dim).astype(np.float32)
        * np.geomspace(0.8, 4.0, feat_dim).astype(np.float32)
    )
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)

    img_dir = os.path.join(out_dir, "dense", "images")
    feat_map_dir = os.path.join(out_dir, "DINO", "feature_maps")
    pca_dir = os.path.join(out_dir, "DINO", "pca_infos")
    dpt_dir = os.path.join(out_dir, "DPT")
    for d in [img_dir, feat_map_dir, pca_dir, dpt_dir]:
        os.makedirs(d, exist_ok=True)

    metadata = {}
    for i in range(n):
        name = f"{i:03d}.jpg"
        rgb, inv_depth, pts_w, hit, dirs_w = _render_image(poses[i], K, H, W)
        write_jpeg(os.path.join(img_dir, name), rgb, quality=95)

        small = resize_u8(rgb, (feat_hw, feat_hw), "bilinear").astype(np.float32) / 255.0
        if feature_mode == "world":
            # Per-landmark descriptors: sample the world hit point at each
            # feature cell's center pixel and embed it. Sky cells embed the
            # (world) view direction — consistent at infinity.
            cy = (np.arange(feat_hw) + 0.5) * H / feat_hw
            cx = (np.arange(feat_hw) + 0.5) * W / feat_hw
            yi = np.clip(cy.astype(int), 0, H - 1)
            xi = np.clip(cx.astype(int), 0, W - 1)
            p_cell = pts_w[yi][:, xi]          # (fh, fw, 3)
            hit_cell = hit[yi][:, xi]
            d_cell = dirs_w[yi][:, xi]
            anchor = np.where(hit_cell[..., None], p_cell, 5.0 * d_cell)
            feat = np.sin(anchor @ world_B + feat_phase)
            feat[..., :3] = small[..., :3]  # color in the first channels
        else:
            # "DINO" stand-in must be VIEW-CONSISTENT at a 3-D point (real
            # DINO descriptors of the same surface patch agree across
            # views) — it is the phase-0 pose signal. Random sinusoidal
            # projections of local color are world-anchored through the
            # scene texture; image-space positional channels would act as
            # per-view noise instead.
            feat = np.sin(feat_freq * (small @ feat_proj) + feat_phase)
            feat[..., :3] = small  # keep raw color in the first channels
        feat += 0.01 * rng.randn(*feat.shape)
        np.save(os.path.join(feat_map_dir, name[:-4] + ".npy"), feat.astype(np.float32))

        fl = feat.reshape(-1, feat_dim)
        fl = fl / np.linalg.norm(fl, axis=-1, keepdims=True)
        mean = fl.mean(0)
        u, s, vt = np.linalg.svd(fl - mean, full_matrices=False)
        np.save(os.path.join(pca_dir, name[:-4] + "_mean.npy"), mean)
        np.save(os.path.join(pca_dir, name[:-4] + "_components.npy"), vt[:3])

        np.save(os.path.join(dpt_dir, name[:-4] + ".npy"), inv_depth)

        metadata[str(i)] = {
            "name": f"dense/images/{name}",
            "focal": float(focal),
            "split": "test" if i in test_ids else "train",
            "c2w": np.concatenate(
                [poses[i], np.array([[0, 0, 0, 1.0]], np.float32)]
            ).tolist(),
        }

    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f)

    if phototourism_layout:
        _write_phototourism_layout(out_dir, metadata, poses, K, n_train, seed)
    return metadata


def _write_phototourism_layout(out_dir, metadata, poses, K, n_train, seed):
    """tsv + COLMAP binaries for the same images (tests the COLMAP path)."""
    rng = np.random.RandomState(seed + 1)
    scene_name = os.path.basename(os.path.normpath(out_dir))
    sparse_dir = os.path.join(out_dir, "dense", "sparse")
    os.makedirs(sparse_dir, exist_ok=True)

    cameras, images = {}, {}
    with open(os.path.join(out_dir, f"{scene_name}.tsv"), "w") as f:
        f.write("filename\tid\tsplit\tdataset\n")
        for i, (id_str, md) in enumerate(metadata.items()):
            name = os.path.basename(md["name"])
            img_id = i + 1
            f.write(f"{name}\t{img_id}\t{md['split']}\t{scene_name}\n")
            cameras[img_id] = colmap.Camera(
                id=img_id,
                model="PINHOLE",
                width=int(K[0, 2] * 2),
                height=int(K[1, 2] * 2),
                params=np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float64),
            )
            # c2w right-up-back -> COLMAP w2c right-down-front
            c2w = poses[i].astype(np.float64).copy()
            c2w[:, 1:3] *= -1
            w2c = np.linalg.inv(np.concatenate([c2w, [[0, 0, 0, 1]]]))
            images[img_id] = colmap.Image(
                id=img_id,
                qvec=colmap.rotmat2qvec(w2c[:3, :3]),
                tvec=w2c[:3, 3],
                camera_id=img_id,
                name=name,
                xys=np.zeros((0, 2)),
                point3D_ids=np.zeros(0, np.int64),
            )
    # sparse points: on the unit sphere (in front of all ring cameras)
    pts = rng.randn(256, 3)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    points = {
        j
        + 1: colmap.Point3D(
            id=j + 1,
            xyz=pts[j],
            rgb=np.array([128, 128, 128]),
            error=np.array(0.5),
            image_ids=np.array([1], np.int32),
            point2D_idxs=np.array([0], np.int32),
        )
        for j in range(len(pts))
    }
    colmap.write_cameras_binary(cameras, os.path.join(sparse_dir, "cameras.bin"))
    colmap.write_images_binary(images, os.path.join(sparse_dir, "images.bin"))
    colmap.write_points3d_binary(points, os.path.join(sparse_dir, "points3D.bin"))
