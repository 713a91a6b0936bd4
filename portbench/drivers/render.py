"""Novel views, one client in a closed loop: each frame through
`make_pose_renderer` and `render_image` (the grid padded to whole chunks,
rgb and depth back on the host), the poses cycling over the traffic's
views with each view's appearance row. The weights are seeded and frozen.

Set-up renders one frame, which warms the only shapes the window uses. The
window keeps a sample of its frames, drawn from the seed by reservoir
sampling over every frame it completes; the check renders those frames
again with the reference.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import scene as S
from portbench import work
from portbench.reference import model as ref_model
from portbench.reference import steps as ref_steps


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, fault: Optional[str] = None):
        from upnerf_torch.evaluate.render import make_pose_renderer, render_image
        from upnerf_torch.render.render_rays import RenderConfig
        from upnerf_torch.models.nerf import NeRFConfig
        from upnerf_torch.train import init_params

        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, device
        hp, sc = cfg["hparams"], cfg["scene"]
        n_img = sc["n_train"] + sc["n_test"]
        self.weights = S.make_weights(cfg, seed, device)
        model = init_params(NeRFConfig.from_hparams(hp), None, n_img).to(device)
        S.load_into(model, {k: v for k, v in self.weights.items() if not k.startswith("transient_net.")})
        for p in model.parameters():
            p.requires_grad_(False)
        self.model, self.params = model, model.render_params()
        scene = S.make_scene(cfg, seed, device, feats=False)
        tables = S.make_pose_tables(cfg, seed, device)
        views = range(n_img) if traffic["views"] == "all" else range(sc["n_train"], n_img)
        poses = ref_model.compose(ref_model.se3_exp(tables["se3_refine.weight"]), scene.poses)
        self.views = [{"K": scene.Ks[v].cpu().numpy(), "pose": poses[v].cpu().numpy(),
                       "wh": (sc["width"], sc["height"]), "near_far": scene.near_far[v].cpu().numpy(), "a_idx": v}
                      for v in views]
        self.chunk = traffic["chunk"]
        self.renderer = make_pose_renderer(RenderConfig.from_hparams(hp), self.chunk)
        self._render_image = render_image
        self.fault = fault
        self.kept: List[Dict] = []
        self._frame(self.views[0])  # warm-up

    def _frame(self, view: Dict):
        rgb, depth = self._render_image(self.renderer, self.params, view["K"], view["pose"], view["wh"],
                                        view["near_far"], view["a_idx"], chunk=self.chunk, device=self.dev)
        if self.fault == "altered":  # a fault for the check's own test: one chunk's answer moved
            rgb = rgb.copy()
            rgb.reshape(-1, 3)[: self.chunk] += 0.05
        return rgb, depth

    def run(self, seconds: float, max_units: Optional[int] = None) -> Dict:
        """Frames back to back for `seconds` (or `max_units` frames); a frame
        is complete when its rgb and depth are on the host. Reservoir
        sampling keeps `check_frames` of them, drawn from the seed."""
        rng = random.Random(S.sub_seed(self.seed, "render.sample"))
        k = self.traffic["check_frames"]
        kept, frame_s, failed = [], [], 0
        _sync(self.dev)
        t0 = time.perf_counter()
        i = 0
        while True:
            view = self.views[i % len(self.views)]
            t = time.perf_counter()
            rgb, depth = self._frame(view)
            frame_s.append(time.perf_counter() - t)
            failed += int(not (np.isfinite(rgb).all() and np.isfinite(depth).all()))
            entry = {"i": i, "view": i % len(self.views), "rgb": rgb, "depth": depth}
            if len(kept) < k:
                kept.append(entry)
            else:
                j = rng.randrange(i + 1)
                if j < k:
                    kept[j] = entry
            i += 1
            if i >= max_units if max_units is not None else time.perf_counter() - t0 >= seconds:
                break
        dt = time.perf_counter() - t0
        if not self.kept:  # the first run after set-up: the window's (or a calibration's) frames
            self.kept = kept
        w, h = self.views[0]["wh"]
        return {"units": i, "seconds": dt, "rays": i * w * h, "failed": failed, "frame_s": frame_s,
                "unit_flops": work.render_ray_flops(self.cfg["dims"]) * w * h}

    def record(self) -> Dict:
        w, h = self.views[0]["wh"]
        n_chunks = -(-w * h // self.chunk)
        return {"dims": self.cfg["dims"],
                "passes": [("fwd", 2, n_chunks * self.chunk, s) for s in work.passes(self.cfg["dims"])]}

    def release(self) -> None:
        self.renderer = self.params = self.model = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    @property
    def prog(self) -> Dict:
        return {"frames": [{"rgb": f["rgb"], "depth": f["depth"]} for f in self.kept]}

    def reference(self, precision: str) -> Dict:
        out = []
        for f in self.kept:
            v = self.views[f["view"]]
            t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.dev)  # noqa: E731
            out.append(ref_steps.frame(self.weights, self.cfg["dims"], t(v["K"]), t(v["pose"]), v["wh"],
                                       t(v["near_far"]), v["a_idx"], precision=precision))
        return {"frames": out}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
