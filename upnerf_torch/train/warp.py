"""GT-free pose-warp (basin-stall) detection (upnerf/train/warp.py),
detection and logging only, the default (`pose.warp.mitigate: none`).

The detector reads the per-image loss sums and counts the train step already
returns (`img_loss_sum` / `img_loss_cnt`). It keeps an EMA of each image's
loss-to-median ratio and flags images whose EMA exceeds `ratio` for
`patience` consecutive checks inside the [min_progress, max_progress]
window. GT poses are never read, so it runs on real scenes. The JAX
package's mitigations (`multistart`, `reset`) are not ported.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np


class WarpConfig(NamedTuple):
    detect: bool = True
    ratio: float = 2.5  # flag when EMA(loss / median loss) exceeds
    patience: int = 3  # ... for this many consecutive checks
    decay: float = 0.7  # EMA decay per check
    min_progress: float = 0.35  # detection window (early spread is normal,
    max_progress: float = 0.9  # late kicks cannot re-converge)
    mitigate: str = "none"
    kicks: int = 8
    kick_sigma_rot: float = 0.08
    kick_sigma_t: float = 0.05
    score_progress: float = 0.5
    score_rays: int = 1024
    max_events: int = 4
    cooldown: int = 5

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any]) -> "WarpConfig":
        def g(k, d):
            return hp.get(f"pose.warp.{k}", d)

        cfg = cls(
            detect=bool(g("detect", True)), ratio=float(g("ratio", 2.5)), patience=int(g("patience", 3)),
            decay=float(g("decay", 0.7)), min_progress=float(g("min_progress", 0.35)),
            max_progress=float(g("max_progress", 0.9)), mitigate=str(g("mitigate", "none")), kicks=int(g("kicks", 8)),
            kick_sigma_rot=float(g("kick_sigma_rot", 0.08)), kick_sigma_t=float(g("kick_sigma_t", 0.05)),
            score_progress=float(g("score_progress", 0.5)), score_rays=int(g("score_rays", 1024)),
            max_events=int(g("max_events", 4)), cooldown=int(g("cooldown", 5)),
        )
        if cfg.mitigate != "none":
            raise NotImplementedError(f"pose.warp.mitigate {cfg.mitigate!r} is not ported (ROADMAP.md, warp"
                                      " mitigations); the port detects and logs only (mitigate: none)")
        return cfg


class WarpDetector:
    """EMA-ratio stall detector over the per-image loss stream.

    `update` takes one check's (sum, count) vectors and returns the boolean
    flag vector (all False outside the detection window or during a
    cooldown). Images unsampled in a check (count 0) keep their EMA."""

    def __init__(self, n_images: int, cfg: WarpConfig):
        self.cfg = cfg
        self.ema = np.ones(n_images, np.float64)
        self.streak = np.zeros(n_images, np.int64)
        self.cooldown = 0
        self.events = 0

    def update(self, img_sum, img_cnt, progress: float) -> np.ndarray:
        cfg = self.cfg
        s = np.asarray(img_sum, np.float64)
        c = np.asarray(img_cnt, np.float64)
        seen = c > 0
        mean = np.where(seen, s / np.maximum(c, 1.0), 0.0)
        med = np.median(mean[seen]) if seen.any() else 0.0
        if med <= 0:
            return np.zeros_like(seen)
        ratio = mean / med
        self.ema = np.where(seen, cfg.decay * self.ema + (1.0 - cfg.decay) * ratio, self.ema)
        self.streak = np.where(self.ema > cfg.ratio, self.streak + 1, 0)
        if self.cooldown > 0:
            self.cooldown -= 1
            return np.zeros_like(seen)
        if not (cfg.min_progress <= progress <= cfg.max_progress):
            return np.zeros_like(seen)
        return self.streak >= cfg.patience
