"""The ray-cache CLI (upnerf/cli/prepare_cache.py): builds the train split's
ray store with camera_noise=None (the COLMAP poses and per-image near/far)
and writes the memmap-able .npy cache that `load_training_data` reads.

    python -m upnerf_torch.cli.prepare_cache --config configs/<scene>.yaml [key value ...]
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional


def main(hparams: Dict[str, Any]) -> str:
    """Build and write the cache; returns its directory."""
    from upnerf_torch.data import build_arrays, cache_dir_for, load_scene_meta, save_cache

    meta = load_scene_meta(hparams, camera_noise=None)
    scene_np, store_np = build_arrays(meta, hparams.get("feat_dir"), hparams.get("depth_dir"), hparams["nerf.near"],
                                      hparams["nerf.far"])
    cdir = cache_dir_for(hparams["root_dir"], meta.scale)
    save_cache(cdir, meta, scene_np, store_np)
    print(f"[upnerf_torch] cached {store_np['px'].shape[0]} rays for {meta.N_images_train} images -> {cdir}")
    return cdir


def cli(argv: Optional[list] = None) -> str:
    from upnerf_torch.config import parse_cli

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", help="Path to config file.", required=True)
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return main(parse_cli(parser, argv))


if __name__ == "__main__":
    cli()
