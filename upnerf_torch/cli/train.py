"""Training CLI (upnerf/cli/train.py).

    python -m upnerf_torch.cli.train --config configs/<scene>.yaml [--preset best_pose]
        [--device cuda] [key value ...]

Resolves the port's default.yaml -> the scene yaml -> presets -> `key value`
overrides (e.g. `tpu.fused_train false`, `max_steps 12`), writes the resolved
config to <out_dir>/<scene_name>/<exp_name>/config.yaml beside the
checkpoints, auto-resumes from the last checkpoint there, and trains. Each
checkpoint (`ckpts/<step>.ckpt`) is a reference checkpoint that
`upnerf_torch.cli.tto --ckpt`, `cli.eval` and `cli.render_video` read as it
is. The device is the card unless `--device cpu` is given; without a card,
`--device cuda` raises.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch


def main(argv: Optional[list] = None):
    """Train as the arguments say; returns the Trainer."""
    from upnerf_torch.config import parse_cli, save_yaml
    from upnerf_torch.train.loop import Trainer

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", help="Path to config file.", required=True)
    parser.add_argument("--preset", action="append", default=None,
                        help="recipe bundle merged after the scene config (packaged name like 'best_pose', or a yaml"
                             " path; repeatable)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="`key value` overrides, e.g. train.batch_size 1024")
    hparams = parse_cli(parser, argv)
    if not (hparams["pose.optimize"] is True or (hparams["pose.optimize"] is False and hparams["pose.c2f"] is None)):
        raise ValueError("if you don't optimize poses, pose.c2f must be None")
    device = torch.device(hparams["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    np.random.seed(hparams.get("seed", 42))
    save_dir = os.path.join(hparams["out_dir"], hparams["scene_name"], hparams["exp_name"])
    os.makedirs(save_dir, exist_ok=True)
    save_yaml(hparams, os.path.join(save_dir, "config.yaml"))
    trainer = Trainer(hparams, device=device)
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
