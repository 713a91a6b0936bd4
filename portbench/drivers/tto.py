"""Test-time optimization of the held-out views on frozen seeded weights, as
TTORunner.run_group steps it, without its eval renders: per group of views,
fresh trainables, the pose phase (`make_tto_step` with the pose, Adam on the
embedding and se3) for `pose_epochs` epochs of ceil(largest W x H /
rays_per_image) steps, then the appearance phase (the embedding alone,
AdamW, the left half) for `appearance_epochs` epochs of half as many steps
from the refined poses (run_group's best pose needs the eval renders; the
last is taken); the groups in turn, the views cycled so that every group
has `group_size` of them. At 512 x 340 and 1024 rays an image a group is
8,500 pose steps and 1,700 appearance steps, so a window of a minute spans
the start of group 0's pose phase.

Set-up builds the runner and takes group 0's first `check_steps` pose
steps (kept for the check) and one appearance step on throwaway
trainables, which warm every shape up. The window starts again at group 0.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from portbench import scene as S
from portbench import work
from portbench.reference import model as ref_model
from portbench.reference import steps as ref_steps


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, fault: Optional[str] = None):
        from upnerf_torch.evaluate.tto import TTOConfig, TTOGroup, TTORunner
        from upnerf_torch.geometry import se3
        from upnerf_torch.render.render_rays import RenderConfig
        from upnerf_torch.models.nerf import NeRFConfig
        from upnerf_torch.train import init_params

        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, device
        hp = cfg["hparams"]
        sc = cfg["scene"]
        n_img = sc["n_train"] + sc["n_test"]
        self.weights = S.make_weights(cfg, seed, device)
        model = init_params(NeRFConfig.from_hparams(hp), None, n_img).to(device)
        S.load_into(model, {k: v for k, v in self.weights.items() if not k.startswith("transient_net.")})
        for p in model.parameters():
            p.requires_grad_(False)
        self.model = model
        scene = S.make_scene(cfg, seed, device, feats=False)
        tables = S.make_pose_tables(cfg, seed, device)
        test = list(range(sc["n_train"], n_img))
        base = ref_model.se3_exp(tables["se3_refine.weight"][test])  # the held-out views' aligned initial poses
        pixels = S.make_test_pixels(cfg, seed, device)
        G = traffic["group_size"]
        self.group_size, self.rays_per_image = G, traffic["rays_per_image"]
        self.groups = []
        for k in range(len(test) // _gcd(len(test), G)):
            views = [(k * G + i) % len(test) for i in range(G)]
            ix = torch.as_tensor(views, device=device)
            self.groups.append({"Ks": scene.Ks[test][ix], "base_poses": base[ix].contiguous(), "rgbs": pixels[ix],
                                "wh": scene.wh[test][ix], "near_far": scene.near_far[test][ix]})
        rcfg = RenderConfig.from_hparams(hp)._replace(param_grads=False)
        self.lrs = {"fine_a": traffic["lr_emb_pose_phase"], "se3": traffic["lr_se3"]}
        tcfg = TTOConfig(nerf=NeRFConfig.from_hparams(hp), render=rcfg, batch_size=self.rays_per_image,
                         pose_epochs=traffic["pose_epochs"], appearance_epochs=traffic["appearance_epochs"],
                         lr_emb_pose_phase=self.lrs["fine_a"], lr_se3=self.lrs["se3"],
                         lr_emb_appearance=traffic["lr_emb_appearance"])
        epoch_A = max(1, -(-sc["width"] * sc["height"] // self.rays_per_image))  # run_group's epoch_steps_A
        self.steps_A = tcfg.pose_epochs * epoch_A
        self.steps_B = tcfg.appearance_epochs * max(1, epoch_A // 2)
        self.runner = TTORunner(model.render_params(), tcfg, cfg["dims"]["appearance_dim"], region_A=(0, 0),
                                region_B=(0, 0))
        self._TTOGroup, self._se3 = TTOGroup, se3
        self.gen = S.generator(seed, "tto.draws", device)
        self.draw_seed = S.sub_seed(seed, "tto.check_draws")
        self.fault = fault
        self.prog = self._first_steps()

    def _group(self, k: int):
        return self._TTOGroup(**self.groups[k % len(self.groups)])

    def _fresh(self, gen) -> Dict[str, torch.Tensor]:
        A = self.cfg["dims"]["appearance_dim"]
        return {"fine_a": torch.randn((self.group_size, A), generator=gen, device=self.dev).requires_grad_(True),
                "se3": torch.zeros((self.group_size, 6), device=self.dev, requires_grad=True)}

    def _first_steps(self) -> Dict:
        """Group 0's first pose steps from a generator of their own (kept for
        the check), then one appearance step; both on throwaway
        trainables."""
        gen = torch.Generator(device=self.dev).manual_seed(self.draw_seed)
        fresh = self._fresh(S.generator(self.seed, "tto.init", self.dev))
        self.init = {k: v.detach().clone() for k, v in fresh.items()}
        tr = {k: v.clone().requires_grad_(True) for k, v in self.init.items()}
        opt = self.runner.opt_A(tr)
        if self.fault == "unchanged":
            opt.step = lambda *a, **k: None
        group = self._group(0)
        out = {"loss": []}
        for i in range(self.traffic["check_steps"]):
            out["loss"].append(float(self._step_A(tr, opt, group, gen)))
            if i == 0:
                g = {k: opt.state.get(v, {}).get("exp_avg", torch.zeros_like(v)) / 0.1 for k, v in tr.items()}
                out["grad"] = {k: float(torch.linalg.vector_norm(v.double())) for k, v in g.items()}
                out["grad_rows"] = {k: v.cpu().tolist() for k, v in g.items()}
        out["change"] = {k: float(torch.linalg.vector_norm((tr[k].detach() - self.init[k]).double())) for k in tr}
        tb = {"fine_a": tr["fine_a"].detach().clone().requires_grad_(True)}
        self.runner.step_B(tb, self.runner.opt_B(tb), group, gen)
        return out

    def _step_A(self, tr, opt, group, gen):
        if self.fault == "half_batch":  # the first half of each image's rays alone, their mean
            from upnerf_torch.evaluate import tto as T

            px, py = T._sample_pixels(gen, group.wh, (0.0, 1.0), self.rays_per_image)
            noise = T._draw_render_noise(gen, self.runner.cfg.render, self.group_size, self.rays_per_image, self.dev)
            h = self.rays_per_image // 2
            half = self.runner.cfg._replace(batch_size=h)
            step = T.make_tto_step(self.runner.frozen, half, optimize_pose=True, x_frac=(0.0, 1.0))
            return step(tr, opt, group, gen, px=px[:, :h].contiguous(), py=py[:, :h].contiguous(),
                        noise={k: v[:, :h] for k, v in noise.items()})
        return self.runner.step_A(tr, opt, group, gen)

    def run(self, seconds: float, max_units: Optional[int] = None) -> Dict:
        """Groups in turn, each its `steps_A` pose then its `steps_B`
        appearance steps, until `seconds` have passed (or `max_units`
        steps), then a synchronise."""
        losses = []
        _sync(self.dev)
        t0 = time.perf_counter()

        def full() -> bool:
            if max_units is not None:
                return len(losses) >= max_units
            return time.perf_counter() - t0 >= seconds

        k = 0
        while not full():
            group = self._group(k)
            tr = self._fresh(self.gen)
            opt = self.runner.opt_A(tr)
            for _ in range(self.steps_A):
                losses.append(self.runner.step_A(tr, opt, group, self.gen))
                if full():
                    break
            else:
                with torch.no_grad():
                    refined = self._se3.compose([self._se3.se3_to_SE3(tr["se3"]), group.base_poses])
                group = group._replace(base_poses=refined)
                tr = {"fine_a": self._fresh(self.gen)["fine_a"]}
                opt = self.runner.opt_B(tr)
                for _ in range(self.steps_B):
                    losses.append(self.runner.step_B(tr, opt, group, self.gen))
                    if full():
                        break
            k += 1
        _sync(self.dev)
        dt = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        rays = self.group_size * self.rays_per_image
        return {"units": len(losses), "seconds": dt, "rays": len(losses) * rays, "failed": failed,
                "unit_flops": work.tto_step_flops(self.cfg["dims"], rays)}

    def record(self) -> Dict:
        rays = self.group_size * self.rays_per_image
        c, f = work.passes(self.cfg["dims"])
        return {"dims": self.cfg["dims"],
                "passes": [("fwd", 2, rays, c), ("fwd", 2, rays, f), ("bwd_frozen", 2, rays, f)]}

    def release(self) -> None:
        self.runner = self.model = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str) -> Dict:
        return ref_steps.tto_steps(self.weights, self.groups[0], self.init, self.cfg["dims"], self.lrs,
                                   draw_seed=self.draw_seed, rays_per_image=self.rays_per_image,
                                   n_steps=self.traffic["check_steps"], precision=precision,
                                   perturb=self.cfg["hparams"]["nerf.perturb"])


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
