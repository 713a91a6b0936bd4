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

Data-parallel runs (`upnerf_torch.parallel`; rays sharded, state replicated):
- `tpu.n_devices N` (N > 1) starts N ranks of this process, one a card (N
  clamped to the local cards); with `--device cpu`, N CPU ranks. 0 (the
  default) or 1 trains in this process, on its one device.
- `dist.coordinator host:port dist.num_processes P dist.process_id p
  [dist.init_timeout s]`: this process is host p of P, and starts its local
  ranks as above, but 0 = every local card; launch it once per host.
  `dist.multiprocess true` alone reads torchrun's variables (one rank per
  process).
Rank 0 alone writes config.yaml, the metric log and the checkpoints.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _train(hparams: Dict[str, Any], device: torch.device):
    """Write the config (rank 0) and train on this rank; returns the Trainer."""
    from upnerf_torch.config import save_yaml
    from upnerf_torch.parallel import is_main_process
    from upnerf_torch.train.loop import Trainer

    np.random.seed(hparams.get("seed", 42))
    if is_main_process():
        save_dir = os.path.join(hparams["out_dir"], hparams["scene_name"], hparams["exp_name"])
        os.makedirs(save_dir, exist_ok=True)
        save_yaml(hparams, os.path.join(save_dir, "config.yaml"))
    trainer = Trainer(hparams, device=device)
    trainer.fit()
    return trainer


def _train_rank(hparams: Dict[str, Any]) -> int:
    """One spawned rank: trains on its device; returns the final step."""
    from upnerf_torch.parallel import distributed

    return _train(hparams, distributed.local_device()).state.step


def ranks(hparams: Dict[str, Any], device: torch.device) -> Tuple[int, bool, Dict[str, Any]]:
    """(local ranks to start, whether this process is one host of a
    multi-process run, the group's `parallel.initialize` arguments) for the
    run's `tpu.n_devices` and `dist.*` settings."""
    from upnerf_torch import parallel

    multi = bool(hparams.get("dist.multiprocess") or hparams.get("dist.num_processes"))
    spec = dict(coordinator_address=hparams.get("dist.coordinator"), num_processes=hparams.get("dist.num_processes"),
                process_id=hparams.get("dist.process_id"), initialization_timeout=hparams.get("dist.init_timeout"))
    if multi and all(spec[k] is None for k in ("coordinator_address", "num_processes", "process_id")):
        return 1, multi, spec  # torchrun's variables: torchrun started one process a rank
    n_devices = hparams.get("tpu.n_devices", hparams.get("tpu.data_axis", 0))
    return parallel.local_ranks(n_devices, device, every_card=multi), multi, spec


def main(argv: Optional[list] = None):
    """Train as the arguments say; returns the Trainer when this process is
    the run's only rank or one rank of a multi-process run, and the ranks'
    final steps when it started several."""
    from upnerf_torch import parallel
    from upnerf_torch.config import parse_cli

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

    n_local, multi, spec = ranks(hparams, device)
    if n_local > 1:
        return parallel.launch(_train_rank, (hparams,), n_local=n_local, device=device, **(spec if multi else {}))
    if not multi:
        return _train(hparams, device)
    parallel.initialize(**spec, device=device)  # this process is one rank of the group
    try:
        return _train(hparams, parallel.distributed.local_device())
    finally:
        parallel.shutdown()


if __name__ == "__main__":
    main()
