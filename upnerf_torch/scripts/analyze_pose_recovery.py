"""Per-camera pose-error breakdown of a finished run (scripts/analyze_pose_recovery.py).

    python -m upnerf_torch.scripts.analyze_pose_recovery <result_dir> [--device cuda]

The logged train/pose_R_rel is a mean over all camera pairs; identity-init
recovery often ends bimodal (most cameras on the right ring, a few in a
mirrored or stuck basin) and the mean hides it. This restores the run's
latest checkpoint into the port's Trainer (built from the run's config.yaml)
and prints the per-camera mean relative rotation error (over the pairs that
touch each camera) and the pairwise quantiles. The device is the card unless
--device cpu is given.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch


def refined_and_gt(trainer):
    """(base o exp(se3), GT) train poses of a Trainer, [N, 3, 4] each."""
    from upnerf_torch.geometry import se3

    meta = trainer.meta
    base = torch.as_tensor(np.stack([np.asarray(meta.poses_dict[i], np.float32) for i in meta.img_ids_train]))
    gt = torch.as_tensor(np.stack([np.asarray(meta.GT_poses_dict[i], np.float32) for i in meta.img_ids_train]))
    with torch.no_grad():
        refine = se3.se3_to_SE3(trainer.state.pose_params.se3_refine.weight.detach().float().cpu())
        return se3.compose([refine, base]), gt


def breakdown(refined: torch.Tensor, gt: torch.Tensor) -> Dict[str, np.ndarray]:
    """The pairwise rel-R in degrees ("R_deg"), the pairwise rel-t ("t") and
    each camera's mean rel-R over its pairs ("per_cam")."""
    from upnerf_torch.geometry import procrustes

    rel = procrustes.relative_pose_error(refined, gt)
    n = refined.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    R_deg = np.asarray(rel["R"]) * 180 / math.pi
    per_cam = np.array([R_deg[(iu == c) | (ju == c)].mean() for c in range(n)])
    return {"R_deg": R_deg, "t": np.asarray(rel["t"]), "per_cam": per_cam}


def report(b: Dict[str, np.ndarray]) -> List[str]:
    """The JAX script's printed lines."""
    R_deg, per_cam = b["R_deg"], b["per_cam"]
    n = len(per_cam)
    iu, ju = np.triu_indices(n, k=1)
    lines = [f"pairwise rel-R: mean {R_deg.mean():.2f} median {np.median(R_deg):.2f} "
             f"p90 {np.percentile(R_deg, 90):.2f} max {R_deg.max():.2f} deg",
             f"rel-t mean {np.mean(b['t']):.3f}",
             "per-camera mean rel-R (deg):"]
    lines += [f"  cam {c:2d}: {per_cam[c]:7.2f} {'#' * int(per_cam[c] / 2)}" for c in range(n)]
    good = per_cam < 10
    if good.sum() >= 2:
        sel = np.isin(iu, np.where(good)[0]) & np.isin(ju, np.where(good)[0])
        lines.append(f"{good.sum()}/{n} cameras under 10 deg; mean over those pairs only: {R_deg[sel].mean():.2f} deg")
    else:  # no good-good pairs: an empty mean would print nan for exactly the failed runs
        lines.append(f"{good.sum()}/{n} cameras under 10 deg; mean over those pairs only: n/a (<2 good cameras)")
    return lines


def main(argv: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    from upnerf_torch.config import default, merge_from_file
    from upnerf_torch.train.loop import Trainer

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("result_dir")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")

    hp = default()
    merge_from_file(hp, os.path.join(args.result_dir, "config.yaml"))
    hp["debug"] = True
    trainer = Trainer(hp, device=device)
    trainer._restore(trainer.ckpt.load())
    print(f"checkpoint step {trainer.state.step}")
    b = breakdown(*refined_and_gt(trainer))
    print("\n".join(report(b)))
    return b


if __name__ == "__main__":
    main()
