"""Ray-store cache (upnerf/data/cache.py): one memmap-able .npy file per
array and a meta.json, the same files the JAX package writes and reads.

The cache holds the COLMAP-derived poses and per-image near/far (built with
camera_noise=None); the noise modes are applied after loading
(`load_training_data`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from .scene import SceneMeta

CACHE_VERSION = 1

_SCENE_KEYS = ["Ks", "poses", "near_far", "wh", "feat_maps", "ray_offsets"]
_STORE_KEYS = ["px", "py", "img_idx", "rgb", "inv_depth"]


def cache_dir_for(root_dir: str, scale: int) -> str:
    return os.path.join(root_dir, "cache_tpu", f"scale{scale}")


def save_cache(cache_dir: str, meta: SceneMeta, scene_np: Dict[str, Optional[np.ndarray]],
               store_np: Dict[str, np.ndarray]) -> None:
    os.makedirs(cache_dir, exist_ok=True)
    for k in _SCENE_KEYS:
        v = scene_np.get(k)
        if v is not None:
            np.save(os.path.join(cache_dir, f"{k}.npy"), v)
    for k in _STORE_KEYS:
        np.save(os.path.join(cache_dir, f"{k}.npy"), store_np[k])
    np.save(os.path.join(cache_dir, "xyz_world.npy"), meta.xyz_world)
    info = {
        "version": CACHE_VERSION,
        "scale": meta.scale,
        "img_ids": [str(i) for i in meta.img_ids],
        "img_ids_train": [str(i) for i in meta.img_ids_train],
        "img_ids_test": [str(i) for i in meta.img_ids_test],
        "image_paths": {str(k): v for k, v in meta.image_paths.items()},
        "nears": {str(k): v for k, v in meta.nears.items()},
        "fars": {str(k): v for k, v in meta.fars.items()},
        "image_dir": os.path.relpath(meta.image_dir, meta.root_dir),
    }
    with open(os.path.join(cache_dir, "meta.json"), "w") as f:
        json.dump(info, f)
    # GT poses (+ intrinsics) of every tsv image, for eval / TTO
    np.save(os.path.join(cache_dir, "all_Ks.npy"), np.stack([meta.Ks[i] for i in meta.img_ids]).astype(np.float32))
    np.save(os.path.join(cache_dir, "all_poses.npy"),
            np.stack([np.asarray(meta.poses_dict[i], np.float32) for i in meta.img_ids]))


def load_cache(cache_dir: str, mmap: bool = True) -> Tuple[dict, Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(info dict, scene_np, store_np)."""
    with open(os.path.join(cache_dir, "meta.json")) as f:
        info = json.load(f)
    if info["version"] != CACHE_VERSION:
        raise ValueError(f"{cache_dir}: cache version {info['version']}, expected {CACHE_VERSION}")
    mode = "r" if mmap else None

    def _load(name):
        p = os.path.join(cache_dir, f"{name}.npy")
        return np.load(p, mmap_mode=mode) if os.path.exists(p) else None

    scene_np = {k: _load(k) for k in _SCENE_KEYS}
    store_np = {k: _load(k) for k in _STORE_KEYS}
    info["all_Ks"] = _load("all_Ks")
    info["all_poses"] = _load("all_poses")
    info["xyz_world"] = _load("xyz_world")
    return info, scene_np, store_np
