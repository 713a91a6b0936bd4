"""Data layer: scene metadata, COLMAP models, scene images (upnerf/data/).

`load_scene_meta(hparams)` resolves the dataset family (phototourism |
custom) from the flat hyperparameters and applies the camera-noise mode.
"""

from __future__ import annotations

from typing import Any, Dict

from . import colmap, images, scene
from .scene import SceneMeta, load_custom, load_phototourism

__all__ = ["SceneMeta", "colmap", "images", "load_custom", "load_phototourism", "load_scene_meta", "scene"]


def load_scene_meta(hp: Dict[str, Any], camera_noise="use_hparams") -> SceneMeta:
    name = hp["dataset_name"]
    noise = hp["pose.noise"] if camera_noise == "use_hparams" else camera_noise
    scale = hp["phototourism.img_downscale"]
    if name == "phototourism":
        return load_phototourism(hp["root_dir"], hp["scene_name"], scale, camera_noise=noise)
    if name == "custom":
        return load_custom(hp["root_dir"], scale, camera_noise=noise)
    raise KeyError(f"unknown dataset {name!r}")
