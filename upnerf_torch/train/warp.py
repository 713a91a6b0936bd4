"""GT-free pose-warp (basin-stall) detection and mitigation
(upnerf/train/warp.py).

Detection reads the per-image loss sums and counts the train step already
returns (`img_loss_sum` / `img_loss_cnt`). The detector keeps an EMA of each
image's loss-to-median ratio and flags images whose EMA exceeds `ratio` for
`patience` consecutive checks inside the [min_progress, max_progress]
window. GT poses are never read, so it runs on real scenes.

Mitigation (`pose.warp.mitigate`; the Trainer runs it, train/loop.py):
- `multistart`: for each flagged image, a fixed set of candidate se(3) rows
  (the incumbent, the base pose, Gaussian kicks around both) is scored by
  the feature alignment loss rendered at a widened coarse PE progress, and
  the argmin is adopted; the incumbent is candidate 0, so adoption never
  raises the score. `make_pose_scorer` renders every candidate's rays in one
  call: rays are independent, so the scores are the per-candidate route's.
- `reset`: every flagged row goes back to its base pose (zero refinement),
  without scoring.
Adopted rows get their optimizer moments zeroed (`reset_opt_rows`), so the
optimizer re-adapts from the new basin. `none` (the default) logs only.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from upnerf_torch.geometry import rays as ray_utils
from upnerf_torch.geometry import se3
from upnerf_torch.render.render_rays import render_rays

from .step import StepConfig, gather_feats

MITIGATIONS = ("none", "multistart", "reset")


class WarpConfig(NamedTuple):
    detect: bool = True
    ratio: float = 2.5  # flag when EMA(loss / median loss) exceeds
    patience: int = 3  # ... for this many consecutive checks
    decay: float = 0.7  # EMA decay per check
    min_progress: float = 0.35  # detection window (early spread is normal,
    max_progress: float = 0.9  # late kicks cannot re-converge)
    mitigate: str = "none"  # "none" (log only) | "multistart" | "reset"
    kicks: int = 8  # random kick candidates per flagged image
    kick_sigma_rot: float = 0.08  # rad, ~4.6 deg
    kick_sigma_t: float = 0.05
    score_progress: float = 0.5  # PE progress for candidate scoring
    score_rays: int = 1024
    max_events: int = 4  # total mitigation events per run
    cooldown: int = 5  # checks skipped after an event

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
        if cfg.mitigate not in MITIGATIONS:
            raise ValueError(f"pose.warp.mitigate {cfg.mitigate!r}: one of {MITIGATIONS}")
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

    def start_cooldown(self) -> None:
        """Count an event and skip the next `cooldown` checks. The EMA is
        left as it is, as in the JAX package."""
        self.events += 1
        self.cooldown = self.cfg.cooldown
        self.streak[:] = 0

    @property
    def budget_left(self) -> bool:
        return self.events < self.cfg.max_events


def make_pose_scorer(cfg: StepConfig, n_rays: int, score_progress: float):
    """The candidate scorer for one image.

    score(params, scene, img_i, px, py, cands) -> (M,) float32: for each
    candidate se(3) refinement (M, 6), the mean squared difference between
    the rendered features and the image's gathered DINO targets at the pixels
    (px, py) (n_rays each), rendered deterministically in phase 0 at PE
    progress `score_progress`, under no_grad. Every candidate's rays go
    through one render call; rays are independent, so each score is that of
    a render of its candidate alone. Needs the feature head: it is the
    scoring objective."""
    if not cfg.nerf.encode_feat:
        raise ValueError("pose multistart needs feature encoding (nerf.feat_dim > 0)")
    rcfg = cfg.render._replace(perturb=0.0)
    typ = "fine" if cfg.loss.fine else "coarse"

    @torch.no_grad()
    def score(params, scene, img_i: int, px, py, cands) -> torch.Tensor:
        dev = scene.poses.device
        px = torch.as_tensor(px, dtype=torch.float32, device=dev)
        py = torch.as_tensor(py, dtype=torch.float32, device=dev)
        cands = torch.as_tensor(cands, dtype=torch.float32, device=dev)
        B, M = n_rays, cands.shape[0]
        img_idx = torch.full((B,), int(img_i), dtype=torch.long, device=dev)
        dirs = ray_utils.pixel_directions(px, py, scene.Ks[img_i])
        target = gather_feats(scene, {"px": px, "py": py, "img_idx": img_idx})
        poses = se3.compose([se3.se3_to_SE3(cands), scene.poses[img_i].expand(M, 3, 4)])
        rays_o, rays_d = ray_utils.get_rays(dirs.repeat(M, 1), poses[:, None].expand(M, B, 3, 4).reshape(M * B, 3, 4))
        rays = torch.cat([rays_o, rays_d, scene.near_far[img_i].expand(M * B, 2)], -1)
        res = render_rays(params.render_params(), rcfg, rays, img_idx.repeat(M), phase=0, sched_mult=0.0,
                          progress=score_progress, det=True)
        feat = res[f"feat_{typ}"].float().reshape(M, B, -1)
        return ((feat - target[None]) ** 2).mean(dim=(1, 2))

    return score


def propose_candidates(current: np.ndarray, cfg: WarpConfig, rng: np.random.RandomState) -> np.ndarray:
    """Candidate se(3) rows for one flagged image: [current, reset-to-base,
    kicks/2 around current, kicks/2 around base], float32. Candidate 0 is
    always the incumbent, so adoption is monotone in the scoring objective.
    The draws are the JAX package's, in its order."""
    sig = np.array([cfg.kick_sigma_rot] * 3 + [cfg.kick_sigma_t] * 3, np.float64)
    half = max(1, cfg.kicks // 2)
    around_cur = current[None] + rng.randn(half, 6) * sig
    around_base = rng.randn(cfg.kicks - half, 6) * sig
    return np.concatenate([current[None], np.zeros((1, 6)), around_cur, around_base]).astype(np.float32)


def reset_opt_rows(opt_state, rows: np.ndarray, table_shape: Tuple[int, int]):
    """Zero the adopted rows of every optimizer-state tensor whose shape is
    the se3 table's (Adam / AdamW: exp_avg and exp_avg_sq; SGD keeps none),
    so stale moments from the abandoned basin do not drag the new pose
    straight back. Step counts are left alone, as optax's count is. In place;
    returns `opt_state`."""
    rows = torch.as_tensor(np.asarray(rows, np.int64))
    with torch.no_grad():
        for state in opt_state.optimizer.state.values():
            for v in state.values():
                if torch.is_tensor(v) and tuple(v.shape) == tuple(table_shape):
                    v[rows.to(v.device)] = 0
    return opt_state


def run_multistart(scorer, params, scene, se3_table: np.ndarray, flags: np.ndarray, wh: np.ndarray,
                   cfg: WarpConfig, rng: np.random.RandomState, log=print) -> Tuple[np.ndarray, np.ndarray]:
    """Score the candidates of every flagged image; returns (new se3 table,
    adopted rows). `rng` draws each image's pixels, then its candidates, in
    the JAX package's order."""
    new_tab = np.array(se3_table)
    adopted = []
    for i in np.nonzero(flags)[0]:
        w, h = float(wh[i][0]), float(wh[i][1])
        px = np.floor(rng.rand(cfg.score_rays) * w).clip(0, w - 1).astype(np.float32)
        py = np.floor(rng.rand(cfg.score_rays) * h).clip(0, h - 1).astype(np.float32)
        cands = propose_candidates(new_tab[i], cfg, rng)
        scores = scorer(params, scene, int(i), px, py, cands).cpu().numpy()
        best = int(np.argmin(scores))
        log(f"[warp] image {i}: candidate scores cur={scores[0]:.4f} base={scores[1]:.4f}"
            f" best={scores[best]:.4f} (#{best})")
        if best != 0:
            new_tab[i] = cands[best]
            adopted.append(i)
    return new_tab, np.asarray(adopted, np.int64)
