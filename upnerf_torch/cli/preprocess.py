"""Offline preprocessing CLI: DINO features + DPT depth for a scene
(upnerf/cli/preprocess.py).

    python -m upnerf_torch.cli.preprocess --image_dir <dir> --save_dir <root> \\
        [--tsv_path <scene.tsv>] [--what dino dpt] \\
        [--dino_weights dino_vits8.npz] [--dpt_weights dpt_large.npz] [--device cuda]

Writes <root>/DINO/feature_maps/<stem>.npy, <root>/DINO/pca_infos/
<stem>_{mean,components}.npy and <root>/DPT/<stem>.npy. The weights are the
converted npz files (upnerf_torch.features.convert), or UPNERF_DINO_WEIGHTS
/ UPNERF_DPT_WEIGHTS. Images are read as .npy, PNG or JPEG without PIL
(upnerf_torch.features.images.read_rgb_u8), any other format with PIL where
it is installed.
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from typing import List, Optional

import torch

from upnerf_torch.data.scene import read_tsv


def collect_images(image_dir: str, tsv_path: Optional[str] = None) -> List[str]:
    if tsv_path is None:
        names = sorted(os.path.basename(p) for p in glob(os.path.join(image_dir, "*")))
    else:
        names = [row["filename"] for row in read_tsv(tsv_path)]
    return [os.path.join(image_dir, n) for n in names]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image_dir", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--tsv_path", default=None)
    p.add_argument("--what", nargs="+", default=["dino", "dpt"], choices=["dino", "dpt"])
    p.add_argument("--dino_weights", default=None)
    p.add_argument("--dpt_weights", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    from upnerf_torch.features import dino, dpt

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    paths = collect_images(args.image_dir, args.tsv_path)
    print(f"[preprocess] {len(paths)} images", flush=True)

    if "dino" in args.what:
        extractor = dino.load_dino(args.dino_weights, device=device)
        if extractor is None:
            raise SystemExit("DINO weights unavailable: pass --dino_weights or set UPNERF_DINO_WEIGHTS to a converted"
                             " dino_vits8 npz (upnerf_torch.features.convert)")
        dino.save_features(extractor, paths, os.path.join(args.save_dir, "DINO"))
        del extractor
    if "dpt" in args.what:
        model = dpt.load_dpt(args.dpt_weights, device=device)
        if model is None:
            raise SystemExit("DPT weights unavailable: pass --dpt_weights or set UPNERF_DPT_WEIGHTS to a converted"
                             " dpt_large npz (upnerf_torch.features.convert)")
        dpt.save_depths(model, paths, os.path.join(args.save_dir, "DPT"))


if __name__ == "__main__":
    main()
