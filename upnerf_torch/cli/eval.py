"""Evaluation CLI (upnerf/cli/eval.py).

    python -m upnerf_torch.cli.eval --ckpt model.ckpt --result_dir DIR [--device cuda]

Prints the mean train-pose rotation / translation errors (the refined poses
base o exp(se3) Procrustes-aligned to GT) and their gauge-free relative
versions, then the mean PSNR / SSIM / LPIPS of the TTO results in
DIR/a_optimize/ (metrics.json, and the metrics.shard*.json files of a
sharded run, merged: shards first, so a full metrics.json wins per image).
Returns the printed numbers as a dict.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="reference checkpoint whose hyper_parameters name the scene")
    p.add_argument("--result_dir", required=True, help="holds a_optimize/ from upnerf_torch.cli.tto")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    from upnerf_torch.geometry import procrustes, se3

    from .tto import load_trained

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    _, _, se3_table, meta = load_trained(args.ckpt, device)
    out: Dict[str, float] = {}

    if meta.GT_poses_dict is not None:
        base = torch.from_numpy(np.stack([np.asarray(meta.poses_dict[i], np.float32) for i in meta.img_ids_train]))
        gt = torch.from_numpy(np.stack([np.asarray(meta.GT_poses_dict[i], np.float32) for i in meta.img_ids_train]))
        refined = se3.compose([se3.se3_to_SE3(se3_table.cpu()), base])
        err, _, _ = procrustes.pose_metric(refined, gt)
        if err is not None:
            out["train/pose_R"] = float(err["R"].mean()) * 180 / np.pi
            out["train/pose_t"] = float(err["t"].mean())
            print("train/pose_R", out["train/pose_R"])
            print("train/pose_t", out["train/pose_t"])
        else:
            print("pose alignment is not converged")
        rel = procrustes.relative_pose_error(refined, gt)
        out["train/pose_R_rel"] = float(np.mean(rel["R"])) * 180 / np.pi
        out["train/pose_t_rel"] = float(np.mean(rel["t"]))
        print("train/pose_R_rel", out["train/pose_R_rel"])
        print("train/pose_t_rel", out["train/pose_t_rel"])
    else:
        print("Dataset does not have GT poses. Skip pose evaluation.")

    save_root = os.path.join(args.result_dir, "a_optimize")
    shard_paths = sorted(glob.glob(os.path.join(save_root, "metrics.shard*.json")))
    full_path = os.path.join(save_root, "metrics.json")
    paths = shard_paths + ([full_path] if os.path.isfile(full_path) else [])
    if not paths:
        print(f"There is no {full_path}.")
        print("You should run upnerf_torch.cli.tto for getting NVS results.")
        return out
    m = {}
    for p in paths:
        with open(p) as f:
            m.update(json.load(f))
    if shard_paths:
        print(f"merged {len(paths)} metrics file(s) ({', '.join(os.path.basename(p) for p in paths)}): {len(m)} images")
    lpips = [v["lpips"] for v in m.values() if v.get("lpips") is not None]
    out["PSNR"] = float(np.mean([v["psnr"] for v in m.values()]))
    out["SSIM"] = float(np.mean([v["ssim"] for v in m.values()]))
    print("PSNR: \t", out["PSNR"])
    print("SSIM: \t", out["SSIM"])
    if lpips:
        out["LPIPS"] = float(np.mean(lpips))
        print("LPIPS: \t", out["LPIPS"])
    else:
        print("LPIPS: \t n/a (no LPIPS weights; set UPNERF_LPIPS_WEIGHTS)")
    return out


if __name__ == "__main__":
    main()
