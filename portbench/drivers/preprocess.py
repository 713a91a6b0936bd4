"""The preprocessing pass, one client in a closed loop: each image of the
scene through the CLI's own functions, `dino.save_features` (DINO ViT-S/8's
block-9 keys, their PCA, three .npy files) and then `dpt.save_depths`
(DPT-Large's inverse depth, one .npy file), with both models resident. The
CLI runs every image through DINO before any through DPT; an image's work
is the same either way. The images cycle; an image is complete when both
extractors' files are written.

Set-up writes the scene's decoded images (uint8 .npy, random from the seed)
to a temporary directory, draws the weights on the card and runs one image,
which warms the only shapes the window uses. The window keeps a sample of
its images, drawn from the seed by reservoir sampling: their files are
moved aside and read back after the window; every other image's files are
removed as soon as they are written, so that the run writes little to disk.
The check recomputes the kept images with the reference from the same
pixels and weights.
"""

from __future__ import annotations

import functools
import math
import os
import random
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import scene as S
from portbench import work
from portbench.reference import vit as ref_vit

OUTPUTS = ("keys", "mean", "components", "depth")


def make_params(spec: Dict, seed: int, purpose: str, device) -> Dict:
    """The extractor's weights from the seed, as `spec` says: every "normal"
    and "abs_normal" leaf from one N(0, 0.02) call on the card, zero biases,
    unit LayerNorm scales."""
    drawn = [(k, s, init) for k, (s, init) in spec.items() if init in ("normal", "abs_normal")]
    z = torch.randn(sum(math.prod(s) for _, s, _ in drawn), generator=S.generator(seed, purpose, device),
                    device=device).mul_(0.02)
    flat, o = {}, 0
    for k, s, init in drawn:
        flat[k] = z[o : o + math.prod(s)].reshape(s)
        if init == "abs_normal":
            flat[k].abs_()
        o += math.prod(s)
    for k, (s, init) in spec.items():
        if k not in flat:
            flat[k] = (torch.ones if init == "ones" else torch.zeros)(s, device=device)
    return ref_vit.nest({k: flat[k] for k in spec})


def _vit_config(d: Dict):
    from upnerf_torch.features.vit import ViTConfig

    return ViTConfig(patch_size=d["patch_size"], dim=d["dim"], depth=d["depth"], heads=d["heads"],
                     mlp_ratio=d["mlp_ratio"], base_grid=d["base_grid"], attn_impl=d["attn_impl"])


def _quiet(_msg: str) -> None:
    pass


class Driver:
    """`fault`, for the check's own test, plants one of: block 8's keys in
    place of block 9's ("keys_of_block_before"), DPT's third hook read one
    block early ("hook_one_block_early"), the skip into one fusion stage,
    refine1's, left out ("skip_left_out")."""

    control = "tf32"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, fault: Optional[str] = None):
        from upnerf_torch.features import dino, dpt

        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, device
        d, p = cfg["dims"]["dino"], cfg["dims"]["dpt"]
        self.dino_params = make_params(ref_vit.vit_spec(d), seed, "weights.dino", device)
        self.dpt_params = make_params(ref_vit.dpt_spec(p), seed, "weights.dpt", device)
        sc = cfg["scene"]
        self.pixels = torch.randint(0, 256, (sc["n_images"], sc["height"], sc["width"], 3), dtype=torch.uint8,
                                    generator=S.generator(seed, "images", device), device=device).cpu().numpy()
        self.tmp = tempfile.mkdtemp(prefix="portbench_preprocess_")
        self.paths = []
        for i, img in enumerate(self.pixels):
            self.paths.append(os.path.join(self.tmp, f"{i:04d}.npy"))
            np.save(self.paths[-1], img)
        self.out = os.path.join(self.tmp, "out")
        os.makedirs(os.path.join(self.out, "kept"))

        self._dino, self._dpt, self._undo = dino, dpt, []
        layer = d["layer"] - (fault == "keys_of_block_before")
        self.extractor = dino.DinoExtractor(self.dino_params, _vit_config(d), stride=d["stride"], layer=layer,
                                            load_size=d["load_size"])
        hooks = list(p["hooks"])
        if fault == "hook_one_block_early":
            hooks[2] -= 1
        if _vit_config(p) != dpt.DPT_VIT or tuple(hooks) != dpt.DPT_HOOKS:  # a configuration other than DPT-Large's
            self._patch(dpt, "dpt_forward", functools.partial(dpt.dpt_forward, cfg=_vit_config(p), hooks=tuple(hooks)))
        if fault == "skip_left_out":
            inner, left_out = dpt._fusion, self.dpt_params["refine1"]
            self._patch(dpt, "_fusion", lambda x, skip, q: inner(x, None if q is left_out else skip, q))
        self.model = dpt.DPTDepth(self.dpt_params, net_size=p["net_size"])
        self.kept: List[Dict] = []
        for f in self._unit(0):  # warm-up
            os.remove(f)

    def _patch(self, mod, name: str, value) -> None:
        self._undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def _unit(self, i: int) -> List[str]:
        """One image through both extractors; returns the four files it
        wrote (keys, PCA mean, PCA components, inverse depth)."""
        path = self.paths[i % len(self.paths)]
        self._dino.save_features(self.extractor, [path], os.path.join(self.out, "DINO"), log=_quiet)
        self._dpt.save_depths(self.model, [path], os.path.join(self.out, "DPT"), log=_quiet)
        stem = os.path.basename(path)[:-4]
        return [os.path.join(self.out, "DINO", "feature_maps", f"{stem}.npy"),
                os.path.join(self.out, "DINO", "pca_infos", f"{stem}_mean.npy"),
                os.path.join(self.out, "DINO", "pca_infos", f"{stem}_components.npy"),
                os.path.join(self.out, "DPT", f"{stem}.npy")]

    def run(self, seconds: float, max_units: Optional[int] = None) -> Dict:
        """Images back to back for `seconds` (or `max_units` images).
        Reservoir sampling keeps `check_images` of them, drawn from the seed;
        the first run's are read back for the check."""
        rng = random.Random(S.sub_seed(self.seed, "preprocess.sample"))
        k = self.traffic["check_images"]
        kept: List[Dict] = []
        _sync(self.dev)
        t0 = time.perf_counter()
        i = 0
        while True:
            files = self._unit(i)
            slot = len(kept) if len(kept) < k else rng.randrange(i + 1)
            if slot < k:
                if slot < len(kept):
                    for f in kept[slot]["files"]:
                        os.remove(f)
                else:
                    kept.append({})
                moved = [os.path.join(self.out, "kept", f"{i}.{name}.npy") for name in OUTPUTS]
                for a, b in zip(files, moved):
                    os.replace(a, b)
                kept[slot] = {"i": i, "image": i % len(self.paths), "files": moved}
            else:
                for f in files:
                    os.remove(f)
            i += 1
            if i >= max_units if max_units is not None else time.perf_counter() - t0 >= seconds:
                break
        _sync(self.dev)
        dt = time.perf_counter() - t0
        failed = 0
        for e in kept:
            arrays = {name: np.load(f) for name, f in zip(OUTPUTS, e.pop("files"))}
            if not self.kept:  # stays for the first run (the window's, or a calibration's)
                failed += int(not all(np.isfinite(a).all() for a in arrays.values()))
                e.update(arrays)
        if not self.kept:
            self.kept = kept
        for f in os.listdir(os.path.join(self.out, "kept")):
            os.remove(os.path.join(self.out, "kept", f))
        return {"units": i, "seconds": dt, "images": i, "failed": failed,
                "unit_flops": work.preprocess_image_flops(self.cfg["dims"])}

    def record(self) -> Dict:
        d = self.cfg["dims"]["dino"]
        n = work.vit_grid(d["load_size"], d["patch_size"], d["stride"]) ** 2 + 1
        return {"dims": self.cfg["dims"], "attn_calls": [(d["heads"], n, d["dim"] // d["heads"])] * d["layer"]}

    def release(self) -> None:
        """Drop the program's extractors and the files; the pixels and the
        weights stay for the reference."""
        self.extractor = self.model = None
        for mod, name, value in reversed(self._undo):
            setattr(mod, name, value)
        self._undo = []
        shutil.rmtree(self.tmp, ignore_errors=True)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    @property
    def prog(self) -> Dict:
        return {"features": [{name: e[name] for name in OUTPUTS} for e in self.kept]}

    def reference(self, precision: str) -> Dict:
        return {"features": [ref_vit.image_outputs(self.dino_params, self.dpt_params, self.cfg["dims"],
                                                   self.pixels[e["image"]], precision) for e in self.kept]}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
