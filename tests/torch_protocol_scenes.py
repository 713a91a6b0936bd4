"""Write a protocol recipe's scene with the JAX package's generator, its
JPEGs decoded by PIL and stored as PNGs: the pixels the JAX loader reads,
for the port's loader, which reads PNGs without PIL.

    python tests/torch_protocol_scenes.py DST --recipe pose|tto|quality

The JAX records in benchmarks/ were trained on these scenes (JPEG at quality
95, 4:2:0); the port's generator writes the same renders losslessly. Placed
as `<work>/<scene>` (e.g. DST = <work>/scene for quality), a port driver's
--work trains on them in place of its own scene.
"""

import argparse
import json
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_scene(dst: str, scene_kwargs: dict) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from PIL import Image

    from upnerf.data import synthetic
    from upnerf_torch.features.images import write_png

    shutil.rmtree(dst, ignore_errors=True)
    synthetic.generate_scene(dst, **scene_kwargs)
    meta_path = os.path.join(dst, "metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    for v in meta.values():
        path = os.path.join(dst, v["name"])
        rgb = np.asarray(Image.open(path).convert("RGB"))
        os.remove(path)
        v["name"] = os.path.splitext(v["name"])[0] + ".png"
        write_png(os.path.join(dst, v["name"]), rgb)
    with open(meta_path, "w") as f:
        json.dump(meta, f)


def main(argv=None) -> None:
    from upnerf_torch.scripts import pose_protocol, quality_protocol, tto_protocol

    kwargs = {"pose": pose_protocol.RECIPES["pose"]["scene_kwargs"], "tto": tto_protocol.SCENE_KWARGS,
              "quality": quality_protocol.SCENE_KWARGS}
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dst")
    ap.add_argument("--recipe", choices=sorted(kwargs), required=True)
    args = ap.parse_args(argv)
    write_scene(args.dst, kwargs[args.recipe])


if __name__ == "__main__":
    main()
