"""Test-time optimization CLI (upnerf/cli/tto.py).

    python -m upnerf_torch.cli.tto --ckpt model.ckpt --result_dir DIR \\
        [--batch_size 1024] [--optimize_num -1] [--group_size 4] [--pose_epochs 50] \\
        [--appearance_epochs 20] [--pose_anneal 0] [--pose_blur ''] [--pose_blur_frac 0.5] \\
        [--eval_every 1] [--shard i/n] [--device cuda]

Reads a reference checkpoint ({"state_dict", "hyper_parameters",
"global_step"}, upnerf_torch/utils/weights.py) whose hyper_parameters name
the scene (dataset_name, root_dir, scene_name, phototourism.img_downscale,
pose.noise), maps the GT test poses into the learned frame by the train
set's sim(3), and runs both TTO phases for every test image (or one, with
--optimize_num), in groups. Writes the JAX CLI's layout under
DIR/a_optimize/: optimized_pose/best_pose_NN.npy,
optimized_emb_a/best_emb_NN.npy and metrics.json (metrics.shard{i}of{n}.json
with --shard), which upnerf_torch.cli.eval reads. Every step's backward is the
fused render kernel's frozen-model mode (no weight gradients).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch


def image_wh(path: str, downscale: int) -> List[int]:
    """[W, H] after load_rgb_u8's integer downscale, from the file's header."""
    from upnerf_torch.features.images import image_wh as file_wh

    w, h = file_wh(path)
    if downscale > 1:
        w, h = w // downscale, h // downscale
    return [int(w), int(h)]


def load_trained(ckpt: str, device):
    """(hparams, frozen params {"nerf_coarse", "nerf_fine", "embeddings"},
    se3 table (N_train, 6), SceneMeta) of a reference checkpoint."""
    from upnerf_torch.data import load_scene_meta
    from upnerf_torch.models.nerf import NeRFConfig
    from upnerf_torch.utils.weights import load_reference_ckpt, render_params

    sd, hparams, _ = load_reference_ckpt(ckpt)
    if hparams is None:
        raise ValueError(f"{ckpt} has no hyper_parameters")
    meta = load_scene_meta(hparams)
    params, se3_table = render_params(sd, NeRFConfig.from_hparams(hparams), device)
    if se3_table.shape[0] != meta.N_images_train:
        raise ValueError(f"{ckpt} holds {se3_table.shape[0]} train poses, the scene {meta.N_images_train}")
    return hparams, params, se3_table, meta


def _parse_blur(spec) -> tuple:
    """pose_blur sigmas from '4,2' or a sequence."""
    if spec is None:
        return ()
    if isinstance(spec, str):
        return tuple(float(s) for s in spec.split(",") if s.strip())
    return tuple(float(s) for s in spec)


def _parse_shard(spec: str):
    """'i/n' -> (i, n), validated."""
    try:
        i, n = (int(x) for x in str(spec).split("/"))
    except ValueError:
        raise SystemExit(f"--shard must be 'i/n' (got {spec!r})")
    if not (n >= 1 and 0 <= i < n):
        raise SystemExit(f"--shard needs 0 <= i < n (got {spec!r})")
    return i, n


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="reference checkpoint whose hyper_parameters name the scene")
    p.add_argument("--result_dir", required=True, help="receives a_optimize/")
    p.add_argument("--batch_size", default=1024, type=int)
    p.add_argument("--optimize_num", default=-1, type=int)
    p.add_argument("--group_size", default=4, type=int)
    p.add_argument("--pose_epochs", default=50, type=int)
    p.add_argument("--appearance_epochs", default=20, type=int)
    p.add_argument("--pose_anneal", default=0.0, type=float,
                   help="fraction of pose epochs ramping the PE anneal progress 0.3 -> 1.0 (0 = reference behavior)")
    p.add_argument("--pose_blur", default="",
                   help="comma list of Gaussian sigmas for a coarse-to-fine phase-A target (e.g. '4,2'); empty = sharp")
    p.add_argument("--pose_blur_frac", default=0.5, type=float,
                   help="fraction of pose epochs spent on the blurred levels")
    p.add_argument("--eval_every", default=1, type=int, help="best-metric eval render every k-th epoch")
    p.add_argument("--shard", default="0/1",
                   help="'i/n': optimize every n-th test image from i (images are independent; eval merges shards)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> str:
    """Run TTO; returns the metrics file's path."""
    args = parse_args(argv)
    from upnerf_torch.data.images import load_rgb_u8
    from upnerf_torch.evaluate.lpips import load_lpips
    from upnerf_torch.evaluate.tto import TTOConfig, TTOGroup, TTORunner, align_test_poses, tto_region_size
    from upnerf_torch.models.nerf import NeRFConfig
    from upnerf_torch.render.render_rays import RenderConfig

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    hparams, frozen, se3_table, meta = load_trained(args.ckpt, device)
    save_root = os.path.join(args.result_dir, "a_optimize")
    os.makedirs(os.path.join(save_root, "optimized_pose"), exist_ok=True)

    if meta.GT_poses_dict is None:
        raise SystemExit("TTO needs GT test poses")
    gt_train = np.stack([np.asarray(meta.GT_poses_dict[i], np.float32) for i in meta.img_ids_train])
    gt_test = np.stack([np.asarray(meta.GT_poses_dict[i], np.float32) for i in meta.img_ids_test])
    base_train = np.stack([np.asarray(meta.poses_dict[i], np.float32) for i in meta.img_ids_train])
    aligned_test = align_test_poses(se3_table.cpu().numpy(), gt_train, gt_test, base_train_poses=base_train)

    test_ids = meta.img_ids_test
    nums = list(range(len(test_ids))) if args.optimize_num == -1 else [args.optimize_num]
    shard_i, shard_n = _parse_shard(args.shard)
    nums = nums[shard_i::shard_n]
    if shard_n > 1:
        print(f"[tto] shard {shard_i}/{shard_n}: {len(nums)} of {len(test_ids)} test images", flush=True)
    results_name = "metrics.json" if shard_n == 1 else f"metrics.shard{shard_i}of{shard_n}.json"
    results_path = os.path.join(save_root, results_name)
    if not nums:
        print("[tto] shard owns no test images; nothing to do", flush=True)
        return results_path

    cfg = TTOConfig(
        nerf=NeRFConfig.from_hparams(hparams),
        # the model is frozen: only the test pose and appearance embedding
        # optimize, so the fused backward skips every weight gradient
        render=RenderConfig.from_hparams(hparams)._replace(perturb=1.0, param_grads=False),
        batch_size=args.batch_size,
        pose_epochs=args.pose_epochs,
        appearance_epochs=args.appearance_epochs,
        pose_anneal=args.pose_anneal,
        pose_blur=_parse_blur(args.pose_blur),
        pose_blur_frac=args.pose_blur_frac,
    )
    lpips = load_lpips(device=device)
    if lpips is None:
        print("[tto] LPIPS weights not found (UPNERF_LPIPS_WEIGHTS unset): reporting PSNR/SSIM only", flush=True)

    all_metrics = {}
    if os.path.isfile(results_path):
        with open(results_path) as f:
            all_metrics = json.load(f)

    # scene-global shapes: every group padded to the same G, eval grids sized over all selected images
    all_wh = np.asarray([image_wh(os.path.join(meta.image_dir, meta.image_paths[test_ids[n]]), meta.scale)
                         for n in nums], np.int64)
    runner = TTORunner(frozen, cfg, hparams["nerf.appearance_dim"], region_A=tto_region_size(all_wh, (0.0, 1.0)),
                       region_B=tto_region_size(all_wh, (0.5, 1.0)))
    Hm_img = -(-int(all_wh[:, 1].max()) // 64) * 64
    Wm_img = -(-int(all_wh[:, 0].max()) // 64) * 64

    generator = torch.Generator(device=device).manual_seed(int(hparams.get("seed", 42)))
    near_far = torch.tensor([[hparams["nerf.near"], hparams["nerf.far"]]], dtype=torch.float32, device=device)
    for g0 in range(0, len(nums), args.group_size):
        group_nums = nums[g0 : g0 + args.group_size]
        n_valid = len(group_nums)
        # the last group is padded to the group size with its final image (results discarded)
        padded_nums = group_nums + [group_nums[-1]] * (args.group_size - n_valid)
        imgs = [load_rgb_u8(os.path.join(meta.image_dir, meta.image_paths[test_ids[n]]), meta.scale)
                for n in padded_nums]
        rgbs = np.zeros((len(imgs), Hm_img, Wm_img, 3), np.uint8)
        for i, img in enumerate(imgs):
            rgbs[i, : img.shape[0], : img.shape[1]] = img
        group = TTOGroup(
            Ks=torch.from_numpy(np.stack([meta.Ks[test_ids[n]] for n in padded_nums]).astype(np.float32)).to(device),
            base_poses=torch.from_numpy(aligned_test[np.asarray(padded_nums)].astype(np.float32)).to(device),
            rgbs=torch.from_numpy(rgbs).to(device),
            wh=torch.tensor([[img.shape[1], img.shape[0]] for img in imgs], dtype=torch.int32, device=device),
            near_far=near_far.expand(len(imgs), 2).contiguous(),
        )
        out = runner.run_group(group, generator, lpips=lpips, log=lambda s: print(s, flush=True),
                               eval_every=args.eval_every)
        emb_dir = os.path.join(save_root, "optimized_emb_a")
        os.makedirs(emb_dir, exist_ok=True)
        for i, n in enumerate(group_nums):
            np.save(os.path.join(save_root, "optimized_pose", f"best_pose_{n:02d}.npy"), out["pose"][i])
            np.save(os.path.join(emb_dir, f"best_emb_{n:02d}.npy"), out["emb"][i])
            all_metrics[str(n)] = {
                "psnr": float(out["psnr"][i]),
                "ssim": float(out["ssim"][i]),
                "lpips": None if np.isnan(out["lpips"][i]) else float(out["lpips"][i]),
            }
        with open(results_path, "w") as f:
            json.dump(all_metrics, f, indent=1)
        done = sum(1 for n in nums if str(n) in all_metrics)
        print(f"[tto] {done}/{len(nums)} images done -> {results_path}", flush=True)
    return results_path


if __name__ == "__main__":
    main()
