"""A cell of the benchmark at a size the CPU runs in seconds: the widths cut
(W 64, D 4, F 32, 8 + 8 samples, 64 rays a step), a scene of 3 + 2 views of
16 x 12; for the preprocessing cell a 4-block ViT of width 64 at 226 tokens
(DINO, keys of block 2; attention by the flash kernel's plain bf16 version),
DPT's small backbone at 64 x 64 (upnerf_torch.features.dpt.SMALL_VIT,
init_dpt_params(small=True)'s widths) and 3 images of 48 x 40. The program
takes its CPU path (the kernels' plain versions)."""

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

CELLS = ("bg_train_blend", "bg_tto", "idhi_render", "bg_render")  # the cells that count rays
PREPROCESS = "bg_preprocess"
TINY = {
    "dims": {"W": 64, "D": 4, "skips": [2], "feat_dim": 32, "N_samples": 8, "N_importance": 8, "transient_dim": 16},
    "scene": {"n_train": 3, "n_test": 2, "width": 16, "height": 12, "feat_h": 8, "feat_w": 8},
    "hparams": {"nerf.W": 64, "nerf.D": 4, "nerf.skips": [2], "nerf.feat_dim": 32, "t_net.feat_dim": 32,
                "t_net.transient_dim": 16, "nerf.N_samples": 8, "nerf.N_importance": 8, "train.batch_size": 64},
}

TINY_PREPROCESS = {
    "dims": {"dino": {"patch_size": 8, "dim": 64, "depth": 4, "heads": 4, "mlp_ratio": 4, "base_grid": 4, "stride": 4,
                      "load_size": 64, "layer": 2, "facet": "key", "attn_impl": "flash"},
             "dpt": {"patch_size": 16, "dim": 64, "depth": 4, "heads": 4, "mlp_ratio": 4, "base_grid": 24,
                     "net_size": 64, "hooks": [0, 1, 2, 3], "channels": [32, 48, 64, 64], "features": 32,
                     "readout": "project", "attn_impl": "auto"}},
    "scene": {"n_images": 3, "width": 48, "height": 40},
}


def overrides(cell: str, precision: str = "bfloat16") -> dict:
    """The small size of `cell`, in `precision` (the field's products, or
    DINO's attention: bf16 by the flash kernel's plain version, or dense
    float32)."""
    if cell == PREPROCESS:
        over = {"dims": {k: dict(v) for k, v in TINY_PREPROCESS["dims"].items()},
                "scene": dict(TINY_PREPROCESS["scene"])}
        over["dims"]["dino"]["attn_impl"] = "flash" if precision == "bfloat16" else "dense"
        return over
    over = {k: dict(v) for k, v in TINY.items()}
    over["hparams"]["tpu.matmul_precision"] = precision
    return over


def run_cell(cell: str, seed: int = 3000000019, fault=None, precision: str = "bfloat16", seconds: float = 0.5):
    """(exit code, the result line as a dict) of one CPU run of `cell`."""
    over = overrides(cell, precision)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
                      device=torch.device("cpu"), cfg_overrides=over, fault=fault)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
