"""Metric and image logging (upnerf/utils/logging.py): one JSON record per
log call in `<log_dir>/metrics.jsonl`, images as PNGs under
`<log_dir>/images/` (the port's zlib writer; no PIL, no wandb)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

from upnerf_torch.features.images import write_png


class MetricLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.img_dir = os.path.join(log_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_image(self, step: int, name: str, image: np.ndarray) -> str:
        """image: (H, W, 3) uint8, or float in [0, 1]; returns the file's path."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        path = os.path.join(self.img_dir, f"{name.replace('/', '_')}_{step:08d}.png")
        write_png(path, np.ascontiguousarray(img))
        return path

    def close(self) -> None:
        self._f.close()
