"""Scene metadata: Phototourism (tsv + COLMAP) and custom (metadata.json)
scenes (upnerf/data/scene.py, metadata only).

Tsv split parsing, intrinsics rescaled by the integer downscale, w2c -> c2w
with the right-down-front -> right-up-back flip, per-image near/far from the
3-D points' depth percentiles (0.1 / 99.9), a global rescale so the largest
far is 5, and the camera-noise modes:

  noise None : keep the COLMAP poses and per-image near/far
  noise -1   : pose-prior-free: every training pose starts at the identity
  noise s>0  : the GT poses composed with persisted random se(3) noise of scale s

The tsv is read with `csv` and the images' sizes from their headers, so the
loader needs neither pandas nor PIL. `build_arrays` builds the per-image
tables and the compact per-ray store of the training images.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from upnerf_torch.features.images import image_wh, npy_name
from upnerf_torch.geometry import se3 as se3_ops

from . import colmap

# pandas.read_csv's default NA strings: a row whose id is one of these is
# dropped, as the JAX package's `files[~files["id"].isnull()]` drops it.
TSV_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A",
          "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}


def read_tsv(path: str) -> List[Dict[str, str]]:
    """The rows of a Phototourism split tsv whose id is not missing."""
    with open(path, newline="") as f:
        return [row for row in csv.DictReader(f, delimiter="\t") if (row["id"] or "") not in TSV_NA]


@dataclasses.dataclass
class SceneMeta:
    root_dir: str
    image_dir: str
    scale: int
    camera_noise: Optional[float]
    img_ids: List
    image_paths: Dict  # id -> path relative to image_dir
    Ks: Dict  # id -> (3, 3) float32 (rescaled)
    poses_dict: Dict  # id -> (3, 4) training base pose
    GT_poses_dict: Optional[Dict]  # id -> (3, 4) ground-truth pose
    nears: Dict
    fars: Dict
    img_ids_train: List
    img_ids_test: List
    xyz_world: np.ndarray

    @property
    def id2idx(self) -> Dict:
        return {id_: i for i, id_ in enumerate(self.img_ids_train)}

    @property
    def N_images_train(self) -> int:
        return len(self.img_ids_train)

    @property
    def N_images_test(self) -> int:
        return len(self.img_ids_test)


def _apply_camera_noise(meta: SceneMeta) -> None:
    """Set poses_dict per the noise mode; the GT poses move to GT_poses_dict."""
    noise = meta.camera_noise
    if noise is None:
        return
    if meta.GT_poses_dict is None:
        # Phototourism: poses_dict holds the COLMAP (GT) poses; custom scenes
        # arrive with GT_poses_dict set
        meta.GT_poses_dict = dict(meta.poses_dict)
    train_poses = np.stack([np.asarray(meta.poses_dict[i], np.float32) for i in meta.img_ids_train])
    if noise == -1:
        eye = np.eye(3, 4, dtype=np.float32)
        for id_ in meta.img_ids_train:
            meta.poses_dict[id_] = eye.copy()
        return
    # persisted random se(3) noise, stored beside the scene
    noise_file = os.path.join(meta.root_dir, "noises", f"{len(train_poses)}_{noise}.npy")
    if os.path.isfile(noise_file):
        pose_noises = np.load(noise_file)
    else:
        rng = np.random.RandomState(0)
        pose_noises = _noise_SE3(rng.randn(len(train_poses), 6).astype(np.float32) * noise)
        os.makedirs(os.path.dirname(noise_file), exist_ok=True)
        np.save(noise_file, pose_noises)
    # pose_b o pose_a in numpy float32, as the JAX loader's compose computes it on numpy arrays
    R_b, t_b = train_poses[..., :3], train_poses[..., 3:]
    noised = np.concatenate([R_b @ pose_noises[..., :3], R_b @ pose_noises[..., 3:] + t_b], axis=-1)
    for i, id_ in enumerate(meta.img_ids_train):
        meta.poses_dict[id_] = noised[i]


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a * b + c in float32 as a fused multiply-add: float64 holds the
    product exactly, and its sum rounds to float32 as the fused one does but
    where it lands on a float32 halfway point."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _mm_fma(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Batched a @ b in float32 as one fused multiply-add a term, k = 0 first."""
    out = a[..., :, :1] * b[..., :1, :]
    for k in range(1, a.shape[-1]):
        out = _fma(a[..., :, k : k + 1], b[..., k : k + 1, :], out)
    return out


def _noise_SE3(wu: np.ndarray) -> np.ndarray:
    """se3_to_SE3 of the (n, 6) float32 noise draw, bit for bit as the JAX
    loader computes it on the CPU (upnerf/data/scene.py): the norm's squares
    summed in numpy in order, the Taylor coefficients as se3_ops' (which
    match jnp's elementwise ops), and the 3 x 3 products as XLA's, a chain
    of fused multiply-adds. Both packages then draw the same perturbation
    into the same noise file."""
    w, u = wu[..., :3], wu[..., 3:]
    theta = np.sqrt((w[..., 0] * w[..., 0] + w[..., 1] * w[..., 1]) + w[..., 2] * w[..., 2])[..., None, None]
    th = torch.from_numpy(theta)
    A, B, C = (f(th).numpy() for f in (se3_ops.taylor_A, se3_ops.taylor_B, se3_ops.taylor_C))
    wx = se3_ops.skew_symmetric(torch.from_numpy(w)).numpy()
    eye = np.eye(3, dtype=np.float32)
    wxwx = _mm_fma(wx, wx)
    R = (eye + A * wx) + B * wxwx
    V = (eye + B * wx) + C * wxwx
    return np.concatenate([R, _mm_fma(V, u[..., None])], axis=-1)


def load_phototourism(root_dir: str, scene_name: str, img_downscale: int = 1,
                      camera_noise: Optional[float] = -1) -> SceneMeta:
    """Parse <root>/<scene_name>.tsv and the COLMAP binaries under
    <root>/dense/sparse."""
    rows = read_tsv(os.path.join(root_dir, f"{scene_name}.tsv"))
    sparse = os.path.join(root_dir, "dense/sparse")
    imdata = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    camdata = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))

    # the tsv's id column is unreliable: map ids through images.bin's names
    name_to_id = {v.name: id_ for id_, v in imdata.items()}
    img_ids, image_paths = [], {}
    for row in rows:
        id_ = name_to_id[row["filename"]]
        image_paths[id_] = row["filename"]
        img_ids.append(id_)

    Ks = {}
    for id_ in img_ids:
        params = camdata[imdata[id_].camera_id].params
        img_w, img_h = int(params[2] * 2), int(params[3] * 2)
        w_, h_ = img_w // img_downscale, img_h // img_downscale
        K = np.zeros((3, 3), np.float32)
        K[0, 0] = params[0] * w_ / img_w
        K[1, 1] = params[1] * h_ / img_h
        K[0, 2] = params[2] * w_ / img_w
        K[1, 2] = params[3] * h_ / img_h
        K[2, 2] = 1
        Ks[id_] = K

    bottom = np.array([[0, 0, 0, 1.0]])
    w2c_mats = np.stack([
        np.concatenate([np.concatenate([colmap.qvec2rotmat(imdata[id_].qvec),
                                        np.asarray(imdata[id_].tvec).reshape(3, 1)], 1), bottom], 0)
        for id_ in img_ids
    ])
    poses = np.linalg.inv(w2c_mats)[:, :3]
    poses[..., 1:3] *= -1  # right-down-front -> right-up-back

    xyz_world = colmap.read_points3d_xyz(os.path.join(sparse, "points3D.bin"))
    xyz_world_h = np.concatenate([xyz_world, np.ones((len(xyz_world), 1))], -1)
    nears, fars = {}, {}
    for i, id_ in enumerate(img_ids):
        xyz_cam = (xyz_world_h @ w2c_mats[i].T)[:, :3]
        xyz_cam = xyz_cam[xyz_cam[:, 2] > 0]
        nears[id_] = float(np.percentile(xyz_cam[:, 2], 0.1))
        fars[id_] = float(np.percentile(xyz_cam[:, 2], 99.9))
    scale_factor = max(fars.values()) / 5
    poses[..., 3] /= scale_factor
    nears = {k: v / scale_factor for k, v in nears.items()}
    fars = {k: v / scale_factor for k, v in fars.items()}

    split = [row["split"] for row in rows]
    meta = SceneMeta(
        root_dir=root_dir,
        image_dir=os.path.join(root_dir, "dense/images"),
        scale=img_downscale,
        camera_noise=camera_noise,
        img_ids=img_ids,
        image_paths=image_paths,
        Ks=Ks,
        poses_dict={id_: poses[i] for i, id_ in enumerate(img_ids)},
        GT_poses_dict=None,
        nears=nears,
        fars=fars,
        img_ids_train=[id_ for i, id_ in enumerate(img_ids) if split[i] == "train"],
        img_ids_test=[id_ for i, id_ in enumerate(img_ids) if split[i] == "test"],
        xyz_world=xyz_world / scale_factor,
    )
    _apply_camera_noise(meta)
    return meta


def load_custom(root_dir: str, img_downscale: int = 1, camera_noise: Optional[float] = -1) -> SceneMeta:
    """A metadata.json scene: per-image focal and split, optional GT c2w
    (right-up-back), global near/far. Training starts from identity poses;
    with GT poses and noise s > 0, from the GT composed with se(3) noise."""
    with open(os.path.join(root_dir, "metadata.json")) as f:
        metadata = json.load(f)

    img_ids = list(metadata.keys())
    image_paths = {id_: v["name"] for id_, v in metadata.items()}
    Ks = {}
    for id_, v in metadata.items():
        width, height = image_wh(os.path.join(root_dir, v["name"]))
        K = np.zeros((3, 3), np.float32)
        K[0, 0] = K[1, 1] = v["focal"] / img_downscale
        K[0, 2] = (width / 2) / img_downscale
        K[1, 2] = (height / 2) / img_downscale
        K[2, 2] = 1
        Ks[id_] = K

    GT_poses = None
    if all("c2w" in v for v in metadata.values()):
        GT_poses = {id_: np.asarray(v["c2w"], np.float32)[:3] for id_, v in metadata.items()}

    perturb = GT_poses is not None and camera_noise is not None and camera_noise != -1
    if perturb:
        poses_dict = {id_: GT_poses[id_][:3, :4].copy() for id_ in img_ids}
    else:
        poses_dict = {id_: np.eye(3, 4, dtype=np.float32) for id_ in img_ids}
    meta = SceneMeta(
        root_dir=root_dir,
        image_dir=root_dir,
        scale=img_downscale,
        camera_noise=camera_noise,
        img_ids=img_ids,
        image_paths=image_paths,
        Ks=Ks,
        poses_dict=poses_dict,
        GT_poses_dict=GT_poses,
        nears={},
        fars={},
        img_ids_train=[i for i in img_ids if metadata[i]["split"] == "train"],
        img_ids_test=[i for i in img_ids if metadata[i]["split"] == "test"],
        xyz_world=np.zeros((0, 3)),
    )
    if perturb:
        _apply_camera_noise(meta)
    return meta


def build_arrays(
    meta: SceneMeta,
    feat_dir: Optional[str],
    depth_dir: Optional[str],
    near: float,
    far: float,
) -> Tuple[Dict[str, Optional[np.ndarray]], Dict[str, np.ndarray]]:
    """The per-image scene tables and the compact per-ray store of the train
    images (upnerf/data/scene.py:build_arrays).

    Returns (scene_np, store_np):
      scene_np: Ks (N,3,3), poses (N,3,4), near_far (N,2), wh (N,2),
                feat_maps (N,h,w,C) | None, ray_offsets (N+1,)
      store_np: px/py (uint16), img_idx (int32), rgb (N_rays,3 uint8),
                inv_depth (float16)
    """
    from .images import load_feat_map, load_rgb_u8, normalize_inv_depth, resize_bilinear

    ids = meta.img_ids_train
    n = len(ids)
    Ks = np.stack([meta.Ks[i] for i in ids]).astype(np.float32)
    poses = np.stack([np.asarray(meta.poses_dict[i], np.float32) for i in ids])
    if meta.camera_noise is not None or not meta.nears:
        near_far = np.tile(np.array([[near, far]], np.float32), (n, 1))
    else:  # per-image COLMAP bounds (cache-building mode)
        near_far = np.stack([[meta.nears[i], meta.fars[i]] for i in ids]).astype(np.float32)

    px_l, py_l, idx_l, rgb_l, invd_l, wh_l, feat_l = [], [], [], [], [], [], []
    offsets = [0]
    for k, id_ in enumerate(ids):
        img = load_rgb_u8(os.path.join(meta.image_dir, meta.image_paths[id_]), meta.scale)
        h, w = img.shape[:2]
        wh_l.append([w, h])
        jj, ii = np.meshgrid(np.arange(h, dtype=np.uint16), np.arange(w, dtype=np.uint16), indexing="ij")
        px_l.append(ii.ravel())
        py_l.append(jj.ravel())
        idx_l.append(np.full(h * w, k, np.int32))
        rgb_l.append(img.reshape(-1, 3))
        offsets.append(offsets[-1] + h * w)
        name = npy_name(meta.image_paths[id_])
        if feat_dir is not None:
            feat_l.append(load_feat_map(os.path.join(feat_dir, "feature_maps", name)))
        if depth_dir is not None:
            invd = normalize_inv_depth(np.load(os.path.join(depth_dir, name)), near, far)
            invd_l.append(resize_bilinear(invd, (w, h)).reshape(-1).astype(np.float16))

    scene_np = {
        "Ks": Ks,
        "poses": poses,
        "near_far": near_far,
        "wh": np.asarray(wh_l, np.int64),
        "feat_maps": np.stack(feat_l) if feat_l else None,
        "ray_offsets": np.asarray(offsets, np.int64),
    }
    store_np = {
        "px": np.concatenate(px_l),
        "py": np.concatenate(py_l),
        "img_idx": np.concatenate(idx_l),
        "rgb": np.concatenate(rgb_l),
        "inv_depth": np.concatenate(invd_l) if invd_l else np.zeros(offsets[-1], np.float16),
    }
    return scene_np, store_np
