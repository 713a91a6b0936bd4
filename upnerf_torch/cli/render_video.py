"""Novel-view orbit rendering from a trained checkpoint (upnerf/cli/render_video.py).

    python -m upnerf_torch.cli.render_video --result_dir RUN [--ckpt last|best] \
        [--anchor 0] [--frames 60] [--scale 1.0] [--out DIR] [--device cuda] \
        [--fast [--fast_probe 64] [--fast_samples 64] [--fast_importance 64]]
    python -m upnerf_torch.cli.render_video --ckpt model.ckpt [--wh W H --focal F] ...

Renders a circular camera path around a training view with that view's
appearance embedding, writing frame_XXX.png (8-bit RGB) and depth_XXX.npy
(into RUN/video unless --out says otherwise). RUN is a training run
directory (`upnerf_torch.cli.train`'s <out_dir>/<scene_name>/<exp_name>);
--ckpt last | best picks its latest checkpoint or the best by val PSNR, and
--ckpt FILE reads that file. Checkpoints are reference checkpoints
({"state_dict", "hyper_parameters", "global_step"}, see
upnerf_torch/utils/weights.py).

As the JAX CLI does, the orbit is anchored at the refined training pose
exp(se3_refine[anchor]) o base, base the scene's pose of that training image
(meta.poses_dict, the identity in the pose-prior-free mode), with the
scene's intrinsics meta.Ks and the image size 2 (cx, cy); the scene is the
one the checkpoint's hyper_parameters name. --wh and --focal override the
intrinsics (principal point at the image centre). A bare checkpoint, whose
hyper_parameters name no scene, needs them, and its base is the identity.
--fast is the serving-only interval-tightened render: a sigma-only probe of
the coarse field (through the CUDA trunk kernel on the card) shrinks each
ray's [near, far], and a reduced sample budget renders inside it
(upnerf_torch/render/fast.py).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from upnerf_torch.features.images import write_png


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--result_dir", default=None, help="training run directory (holds ckpts/)")
    p.add_argument("--ckpt", default="last", help="last | best (of --result_dir's checkpoints) | a checkpoint file")
    p.add_argument("--out", default=None, help="output directory (default: RUN/video, or video)")
    p.add_argument("--anchor", default=0, type=int, help="training image whose pose and appearance anchor the orbit")
    p.add_argument("--frames", default=60, type=int)
    p.add_argument("--scale", default=1.0, type=float, help="orbit radius scale")
    p.add_argument("--wh", nargs=2, type=int, default=None, metavar=("W", "H"),
                   help="image size, overriding the scene's (with --focal)")
    p.add_argument("--focal", type=float, default=None, help="focal length in pixels, overriding the scene's")
    p.add_argument("--device", default="cuda")
    p.add_argument("--fast", action="store_true",
                   help="interval-tightened serving render (reduced sample budget inside a sigma-probed [near, far])")
    p.add_argument("--fast_probe", default=64, type=int)
    p.add_argument("--fast_samples", default=64, type=int)
    p.add_argument("--fast_importance", default=64, type=int)
    return p.parse_args(argv)


def resolve_ckpt(result_dir: Optional[str], ckpt: str) -> str:
    """The checkpoint file: --ckpt last | best among result_dir/ckpts, else
    --ckpt itself."""
    if ckpt not in ("last", "best"):
        return ckpt
    if result_dir is None:
        raise ValueError(f"--ckpt {ckpt} needs --result_dir")
    from upnerf_torch.utils.ckpt import CheckpointManager

    mngr = CheckpointManager(os.path.join(result_dir, "ckpts"))
    step = mngr.best_step() if ckpt == "best" else mngr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {mngr.directory}")
    return mngr.path(step)


def anchor_view(meta, se3_table: torch.Tensor, anchor: int) -> Tuple[torch.Tensor, np.ndarray, Tuple[int, int]]:
    """(anchor pose exp(se3[anchor]) o base (3, 4), K (3, 3), (w, h)) of
    training image `anchor` of the scene `meta`, as the JAX CLI derives them
    (upnerf/cli/render_video.py:55-64): base = meta.poses_dict[id], K =
    meta.Ks[id], w, h = round(2 cx), round(2 cy)."""
    from upnerf_torch.geometry import se3

    anchor_id = meta.img_ids_train[anchor]
    base = torch.as_tensor(np.asarray(meta.poses_dict[anchor_id], np.float32), device=se3_table.device)
    pose = se3.compose([se3.se3_to_SE3(se3_table[anchor]), base])
    K = np.asarray(meta.Ks[anchor_id], np.float32)
    return pose, K, (int(round(K[0, 2] * 2)), int(round(K[1, 2] * 2)))


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Render the orbit; returns {"frames": [png paths], "depths": [npy paths]}."""
    args = parse_args(argv)
    from upnerf_torch.evaluate.render import make_pose_renderer, render_image
    from upnerf_torch.geometry import se3
    from upnerf_torch.models.nerf import NeRFConfig
    from upnerf_torch.render.fast import FastRenderConfig
    from upnerf_torch.render.render_rays import RenderConfig
    from upnerf_torch.utils.weights import load_reference_ckpt, render_params

    from .tto import load_trained

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    if (args.wh is None) != (args.focal is None):
        raise ValueError("--wh and --focal go together")
    path = resolve_ckpt(args.result_dir, args.ckpt)
    sd, hparams, _ = load_reference_ckpt(path)
    if hparams is None:
        raise ValueError(f"{path} has no hyper_parameters")
    if "dataset_name" in hparams:
        hparams, params, se3_table, meta = load_trained(path, device)
    else:
        if args.wh is None:
            raise ValueError(f"{path} names no scene: give --wh and --focal")
        params, se3_table = render_params(sd, NeRFConfig.from_hparams(hparams), device)
        meta = None
    if not 0 <= args.anchor < se3_table.shape[0]:
        raise ValueError(f"--anchor {args.anchor} outside the {se3_table.shape[0]} training images")
    if meta is not None:
        anchor_pose, K, (w, h) = anchor_view(meta, se3_table, args.anchor)
    else:
        anchor_pose = se3.compose([se3.se3_to_SE3(se3_table[args.anchor]), torch.eye(3, 4, device=device)])
    if args.wh is not None:
        w, h = args.wh
        K = np.array([[args.focal, 0.0, w / 2.0], [0.0, args.focal, h / 2.0], [0.0, 0.0, 1.0]], np.float32)
    rcfg = RenderConfig.from_hparams(hparams)._replace(perturb=0.0)
    chunk = int(hparams["val.chunk_size"])
    poses = se3.get_novel_view_poses(anchor_pose, N=args.frames, scale=args.scale)
    near_far = np.array([hparams["nerf.near"], hparams["nerf.far"]], np.float32)
    out_dir = args.out or (os.path.join(args.result_dir, "video") if args.result_dir else "video")
    fast = None
    if args.fast:
        fast = FastRenderConfig(n_probe=args.fast_probe, N_samples=args.fast_samples,
                                N_importance=args.fast_importance)
    renderer = make_pose_renderer(rcfg, chunk=chunk, fast=fast)

    os.makedirs(out_dir, exist_ok=True)
    frames, depths = [], []
    for i in range(args.frames):
        rgb, depth = render_image(
            renderer, params, K, poses[i].cpu().numpy(), (w, h), near_far,
            a_idx=args.anchor, chunk=chunk, device=device,
        )
        frames.append(os.path.join(out_dir, f"frame_{i:03d}.png"))
        depths.append(os.path.join(out_dir, f"depth_{i:03d}.npy"))
        write_png(frames[-1], (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
        np.save(depths[-1], depth.astype(np.float32))
        print(f"[video] frame {i + 1}/{args.frames}", flush=True)
    print(f"[video] frames -> {out_dir}", flush=True)
    return {"frames": frames, "depths": depths}


if __name__ == "__main__":
    main()
