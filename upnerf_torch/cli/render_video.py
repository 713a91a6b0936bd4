"""Novel-view orbit rendering from a reference checkpoint (upnerf/cli/render_video.py).

    python -m upnerf_torch.cli.render_video --ckpt model.ckpt --wh 128 128 \\
        --focal 120 [--anchor 0] [--frames 60] [--scale 1.0] [--out DIR] [--device cuda] \\
        [--fast [--fast_probe 64] [--fast_samples 64] [--fast_importance 64]]

Renders a circular camera path around a training view with that view's
appearance embedding, writing frame_XXX.png (8-bit RGB) and depth_XXX.npy.
The checkpoint is a reference checkpoint ({"state_dict",
"hyper_parameters", "global_step"}, see upnerf_torch/utils/weights.py). The
anchor pose is the refined training pose exp(se3_refine[anchor]) o I: in the
pose-prior-free mode every training base pose is the identity. The
intrinsics come from --wh and --focal (principal point at the image
centre). --fast is the serving-only interval-tightened render: a
sigma-only probe of the coarse field (through the CUDA trunk kernel on the
card) shrinks each ray's [near, far], and a reduced sample budget renders
inside it (upnerf_torch/render/fast.py).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from upnerf_torch.features.images import write_png


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="reference checkpoint (torch.save'd dict)")
    p.add_argument("--out", default="video", help="output directory")
    p.add_argument("--anchor", default=0, type=int, help="training image whose pose and appearance anchor the orbit")
    p.add_argument("--frames", default=60, type=int)
    p.add_argument("--scale", default=1.0, type=float, help="orbit radius scale")
    p.add_argument("--wh", nargs=2, type=int, required=True, metavar=("W", "H"))
    p.add_argument("--focal", type=float, required=True, help="focal length in pixels")
    p.add_argument("--device", default="cuda")
    p.add_argument("--fast", action="store_true",
                   help="interval-tightened serving render (reduced sample budget inside a sigma-probed [near, far])")
    p.add_argument("--fast_probe", default=64, type=int)
    p.add_argument("--fast_samples", default=64, type=int)
    p.add_argument("--fast_importance", default=64, type=int)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Render the orbit; returns {"frames": [png paths], "depths": [npy paths]}."""
    args = parse_args(argv)
    from upnerf_torch.evaluate.render import make_pose_renderer, render_image
    from upnerf_torch.geometry import se3
    from upnerf_torch.models.nerf import NeRFConfig
    from upnerf_torch.render.fast import FastRenderConfig
    from upnerf_torch.render.render_rays import RenderConfig
    from upnerf_torch.utils.weights import load_reference_ckpt, render_params

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    sd, hparams, _ = load_reference_ckpt(args.ckpt)
    if hparams is None:
        raise ValueError(f"{args.ckpt} has no hyper_parameters")
    nerf_cfg = NeRFConfig.from_hparams(hparams)
    rcfg = RenderConfig.from_hparams(hparams)._replace(perturb=0.0)
    chunk = int(hparams["val.chunk_size"])
    params, se3_table = render_params(sd, nerf_cfg, device)
    if not 0 <= args.anchor < se3_table.shape[0]:
        raise ValueError(f"--anchor {args.anchor} outside the {se3_table.shape[0]} training images")

    base = torch.eye(3, 4, device=device)
    anchor_pose = se3.compose([se3.se3_to_SE3(se3_table[args.anchor]), base])
    poses = se3.get_novel_view_poses(anchor_pose, N=args.frames, scale=args.scale)
    w, h = args.wh
    K = np.array([[args.focal, 0.0, w / 2.0], [0.0, args.focal, h / 2.0], [0.0, 0.0, 1.0]], np.float32)
    near_far = np.array([hparams["nerf.near"], hparams["nerf.far"]], np.float32)
    fast = None
    if args.fast:
        fast = FastRenderConfig(n_probe=args.fast_probe, N_samples=args.fast_samples,
                                N_importance=args.fast_importance)
    renderer = make_pose_renderer(rcfg, chunk=chunk, fast=fast)

    os.makedirs(args.out, exist_ok=True)
    frames, depths = [], []
    for i in range(args.frames):
        rgb, depth = render_image(
            renderer, params, K, poses[i].cpu().numpy(), (w, h), near_far,
            a_idx=args.anchor, chunk=chunk, device=device,
        )
        frames.append(os.path.join(args.out, f"frame_{i:03d}.png"))
        depths.append(os.path.join(args.out, f"depth_{i:03d}.npy"))
        write_png(frames[-1], (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
        np.save(depths[-1], depth.astype(np.float32))
        print(f"[video] frame {i + 1}/{args.frames}", flush=True)
    print(f"[video] frames -> {args.out}", flush=True)
    return {"frames": frames, "depths": depths}


if __name__ == "__main__":
    main()
