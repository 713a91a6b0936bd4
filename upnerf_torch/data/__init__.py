"""Data layer: scene metadata, COLMAP models, scene images, the compact ray
store and its cache (upnerf/data/).

`load_scene_meta(hparams)` resolves the dataset family (phototourism |
custom) from the flat hyperparameters and applies the camera-noise mode;
`load_training_data(hparams)` returns the train split's arrays, from the
cache (`cli.prepare_cache`) or built from the images.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np

from . import cache, colmap, images, scene
from .cache import cache_dir_for, load_cache, save_cache
from .scene import SceneMeta, build_arrays, load_custom, load_phototourism

__all__ = ["SceneMeta", "build_arrays", "cache", "cache_dir_for", "colmap", "images", "load_cache", "load_custom",
           "load_phototourism", "load_scene_meta", "load_training_data", "save_cache", "scene"]


def load_scene_meta(hp: Dict[str, Any], camera_noise="use_hparams") -> SceneMeta:
    name = hp["dataset_name"]
    noise = hp["pose.noise"] if camera_noise == "use_hparams" else camera_noise
    scale = hp["phototourism.img_downscale"]
    if name == "phototourism":
        return load_phototourism(hp["root_dir"], hp["scene_name"], scale, camera_noise=noise)
    if name == "custom":
        return load_custom(hp["root_dir"], scale, camera_noise=noise)
    raise KeyError(f"unknown dataset {name!r}")


def load_training_data(hp: Dict[str, Any]) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], SceneMeta]:
    """(scene_np, store_np, meta) of the train split. With
    phototourism.use_cache and a cache on disk the arrays come from it, and
    the noise mode's poses (and, with noise, the global near/far) replace the
    cached COLMAP values, as the JAX package applies them."""
    meta = load_scene_meta(hp)
    near, far = hp["nerf.near"], hp["nerf.far"]
    cdir = cache_dir_for(hp["root_dir"], meta.scale)
    if hp.get("phototourism.use_cache", False) and os.path.isdir(cdir):
        _, scene_np, store_np = load_cache(cdir)
        scene_np = dict(scene_np)
        n = len(meta.img_ids_train)
        if meta.camera_noise is not None:
            scene_np["near_far"] = np.tile(np.array([[near, far]], np.float32), (n, 1))
        scene_np["poses"] = np.stack([np.asarray(meta.poses_dict[i], np.float32) for i in meta.img_ids_train])
        return scene_np, store_np, meta
    scene_np, store_np = build_arrays(meta, hp.get("feat_dir"), hp.get("depth_dir"), near, far)
    return scene_np, store_np, meta
