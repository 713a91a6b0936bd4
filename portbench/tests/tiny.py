"""A cell of the benchmark at a size the CPU runs in seconds: the widths cut
(W 64, D 4, F 32, 8 + 8 samples, 64 rays a step), a scene of 3 + 2 views of
16 x 12. The program takes its CPU path (the kernels' plain versions)."""

from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402

CELLS = ("bg_train_blend", "bg_tto", "idhi_render")
TINY = {
    "dims": {"W": 64, "D": 4, "skips": [2], "feat_dim": 32, "N_samples": 8, "N_importance": 8, "transient_dim": 16},
    "scene": {"n_train": 3, "n_test": 2, "width": 16, "height": 12, "feat_h": 8, "feat_w": 8},
    "hparams": {"nerf.W": 64, "nerf.D": 4, "nerf.skips": [2], "nerf.feat_dim": 32, "t_net.feat_dim": 32,
                "t_net.transient_dim": 16, "nerf.N_samples": 8, "nerf.N_importance": 8, "train.batch_size": 64},
}


def run_cell(cell: str, seed: int = 3000000019, fault=None, precision: str = "bfloat16", seconds: float = 0.5):
    """(exit code, the result line as a dict) of one CPU run of `cell`."""
    over = {k: dict(v) for k, v in TINY.items()}
    over["hparams"]["tpu.matmul_precision"] = precision
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
                      device=torch.device("cpu"), cfg_overrides=over, fault=fault)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
