"""The numbers that decide `correct`: what the timed path produced against
what the plain reference computes from the same inputs.

Steps (train, TTO), as readings of the first steps that set-up drove:
- `loss_gap`: the largest |loss - reference| / |reference| over the steps;
- `grad_gap`: over the leaves, the largest gap between the program's norm
  of the first gradient (from Adam's first moment) and the reference's,
  over the larger of the reference's norm of that leaf and of the median
  leaf's;
- `change_gap`: the same for each leaf's change after the last step,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone under Adam);
- `change_gap.median`: the median over those leaves of the same gap. The
  worst leaf can be one small leaf's noise (a gradient element near zero
  flips sign under rounding, and Adam makes that a whole step), which the
  control does not pass; the median leaf separates the control, and the
  worst leaf, at a limit above that noise, still holds every leaf (the pose
  tables among them) to having moved once and no more;
- `grad_err.<leaf>`, where the driver keeps a leaf's rows (TTO's per-image
  rows): the norm of the first gradient's difference from the reference's
  over the reference's norm. A gap of norms moves only at second order
  with an error across the gradient; this moves at first order.
Frames (renders), over the frames kept from the window:
- `rgb_rmse`: the root mean square of rgb - reference over every pixel;
- `depth_rel_rms`: the root mean square of depth - reference over that of
  the reference's depth.
Features (the preprocessing pass), over the images kept from the window:
- `key_rel_rms`: the root mean square of DINO's keys - reference over that
  of the reference's keys;
- `depth_rel_rms`: as for frames, of DPT's inverse depth at the image's size;
- `pca_mean_gap`: the largest |PCA mean - reference| / |reference|;
- `pca_comp_gap`: over the images and the PCA components, the largest
  distance, up to sign, between a component and the reference's (unit
  vectors), times the gap between its singular value and the nearest of
  its neighbours' over its own, all in the reference. A component moves
  with an error in the keys by about that error over the gap (first-order
  perturbation), and the keys' singular values lie within a few percent of
  each other, so the distance alone swings from image to image with the
  gap; weighted by it, it reads the keys' error as the PCA sees it.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np


def _median(xs) -> float:
    return float(np.median(np.asarray(list(xs), np.float64)))


def _norm_gap(prog: Dict[str, float], ref: Dict[str, float], keys, over=max) -> float:
    """`over` (the worst, or the median) leaf's |norm - reference norm| over
    the larger of the reference's norm and the median leaf's."""
    keys = list(keys)
    if not all(math.isfinite(prog[k]) for k in keys):
        return math.inf
    med = _median(ref[k] for k in keys)
    return float(over([abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]))


def step_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    loss = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"]))
    if not all(math.isfinite(x) for x in prog["loss"]):
        loss = math.inf
    med = _median(ref["grad"].values())
    moving = [k for k, g in ref["grad"].items() if g >= 1e-3 * med]
    out = {"loss_gap": loss, "grad_gap": _norm_gap(prog["grad"], ref["grad"], ref["grad"]),
           "change_gap": _norm_gap(prog["change"], ref["change"], moving),
           "change_gap.median": _norm_gap(prog["change"], ref["change"], moving, np.median)}
    for k, rows in prog.get("grad_rows", {}).items():
        p, r = np.asarray(rows, np.float64), np.asarray(ref["grad_rows"][k], np.float64)
        err = float(np.linalg.norm(p - r) / max(np.linalg.norm(r), 1e-30))
        out[f"grad_err.{k}"] = err if np.isfinite(err) else math.inf
    return out


def frame_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    if not prog["frames"]:
        return {"rgb_rmse": math.inf, "depth_rel_rms": math.inf}
    d_rgb = np.concatenate([(p["rgb"] - r["rgb"]).ravel() for p, r in zip(prog["frames"], ref["frames"])])
    d_dep = np.concatenate([(p["depth"] - r["depth"]).ravel() for p, r in zip(prog["frames"], ref["frames"])])
    r_dep = np.concatenate([r["depth"].ravel() for r in ref["frames"]])
    rgb = float(np.sqrt(np.mean(d_rgb.astype(np.float64) ** 2)))
    dep = float(np.sqrt(np.sum(d_dep.astype(np.float64) ** 2) / np.sum(r_dep.astype(np.float64) ** 2)))
    return {"rgb_rmse": rgb if np.isfinite(rgb) else math.inf, "depth_rel_rms": dep if np.isfinite(dep) else math.inf}


def _rel_rms(prog, ref, key: str) -> float:
    d = sum(float(np.sum((p[key].astype(np.float64) - r[key].astype(np.float64)) ** 2)) for p, r in zip(prog, ref))
    n = sum(float(np.sum(r[key].astype(np.float64) ** 2)) for r in ref)
    out = math.sqrt(d / n) if n > 0 else math.inf
    return out if math.isfinite(out) else math.inf


def _rel_gap(sv: np.ndarray, k: int) -> float:
    """The gap from singular value k to the nearer of its neighbours, over it."""
    return float(min(sv[k] - sv[k + 1], sv[k - 1] - sv[k] if k else math.inf) / sv[k])


def feature_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    P, R = prog["features"], ref["features"]
    if not P:
        return {k: math.inf for k in ("key_rel_rms", "depth_rel_rms", "pca_mean_gap", "pca_comp_gap")}
    mean = max(float(np.linalg.norm(p["mean"].astype(np.float64) - r["mean"]) / np.linalg.norm(r["mean"]))
               for p, r in zip(P, R))
    comp = 0.0
    for p, r in zip(P, R):
        for k in range(len(r["components"])):
            a, b = p["components"][k].astype(np.float64), r["components"][k]
            comp = max(comp, float(min(np.linalg.norm(a - b), np.linalg.norm(a + b))) * _rel_gap(r["sv"], k))
    return {"key_rel_rms": _rel_rms(P, R, "keys"), "depth_rel_rms": _rel_rms(P, R, "depth"),
            "pca_mean_gap": mean if math.isfinite(mean) else math.inf,
            "pca_comp_gap": comp if math.isfinite(comp) else math.inf}


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    if "features" in prog:
        return feature_readings(prog, ref)
    return frame_readings(prog, ref) if "frames" in prog else step_readings(prog, ref)
