"""Training, closed loop: `make_train_step`'s step_fn back to back, as
Trainer.fit drives it with the device-resident store, at the phase that
`schedule_phase` gives the traffic's progress.

Set-up builds the one state the window uses and drives it through the
traffic's first steps (`check_steps`), which also warm every shape up;
each step's loss, every leaf's first gradient (from Adam's first moment
after step 1) and every leaf's change after the last are kept for the
check. The reference follows the same steps from the same inputs.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from portbench import scene as S
from portbench import work
from portbench.reference import steps as ref_steps


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, fault: Optional[str] = None):
        from upnerf_torch.train import (RayStore, SceneConstants, StepConfig, init_params, init_pose_params,
                                        make_optimizer, make_train_state, make_train_step)
        from upnerf_torch.train import step as tstep
        from upnerf_torch.train.schedules import schedule_phase

        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, device
        hp = self.hp = cfg["hparams"]
        self.step_cfg = StepConfig.from_hparams(hp)
        self.scene = S.make_scene(cfg, seed, device)
        self.store = S.make_store(cfg, seed, device)
        self.p_scene = SceneConstants(Ks=self.scene.Ks, poses=self.scene.poses, near_far=self.scene.near_far,
                                      wh=self.scene.wh, feat_maps=self.scene.feat_maps)
        self.p_store = RayStore(*self.store)
        n_img = cfg["scene"]["n_train"] + cfg["scene"]["n_test"]
        self.weights = S.make_weights(cfg, seed, device)
        self.pose_tables = S.make_pose_tables(cfg, seed, device)
        opt = make_optimizer(hp["optimizer.type"], hp["optimizer.lr"], hp["optimizer.scheduler.lr_end"],
                             hp["max_steps"], hp["optimizer.scheduler.type"])
        pose_opt = make_optimizer(hp["optimizer_pose.type"], hp["optimizer_pose.lr"],
                                  hp["optimizer_pose.scheduler.lr_end"], hp["max_steps"],
                                  hp["optimizer_pose.scheduler.type"])
        model = init_params(self.step_cfg.nerf, self.step_cfg.transient, n_img)
        self.draw_seed = S.sub_seed(seed, "train.draws")
        state = make_train_state(model, init_pose_params(n_img), opt, pose_opt, seed=self.draw_seed, device=device)
        S.load_into(state.params, self.weights)
        S.load_into(state.pose_params, self.pose_tables)
        self.start = int(round(traffic["progress"] * hp["max_steps"]))
        state.opt_state.seek(self.start)
        state.pose_opt_state.seek(self.start)
        self.state = state._replace(step=self.start)
        self.phase = schedule_phase(self.start / hp["max_steps"], self.step_cfg.candidate_schedule)
        self.step_fn, _ = make_train_step(self.step_cfg, opt, pose_opt)
        self.batch = self.step_cfg.batch_size
        self._undo = _plant_half_batch(tstep) if fault == "half_batch" else None
        if fault == "unchanged":
            for o in (self.state.opt_state, self.state.pose_opt_state):
                o.optimizer.step = lambda *a, **k: None
        self.prog = self._first_steps(traffic["check_steps"])

    def _named(self):
        st = self.state
        return ([(k, p, st.opt_state) for k, p in st.params.named_parameters() if p.requires_grad]
                + [(k, p, st.pose_opt_state) for k, p in st.pose_params.named_parameters()])

    def _first_steps(self, n: int) -> Dict:
        out = {"loss": []}
        for i in range(n):
            self.state, m = self.step_fn(self.state, self.p_scene, self.p_store, self.phase)
            out["loss"].append(float(m["loss"]))
            if i == 0:
                out["grad"] = {}
                for k, p, o in self._named():
                    m1 = o.optimizer.state.get(p, {}).get("exp_avg")
                    g = torch.zeros_like(p) if m1 is None else m1 / (1.0 - o.optimizer.param_groups[0]["betas"][0])
                    out["grad"][k] = float(torch.linalg.vector_norm(g.double()))
        init = {**self.weights, **self.pose_tables}
        out["change"] = {k: float(torch.linalg.vector_norm((p.detach() - init[k]).double()))
                         for k, p, _ in self._named()}
        return out

    def run(self, seconds: float, max_units: Optional[int] = None) -> Dict:
        """Steps back to back for `seconds` (or `max_units` steps), then a
        synchronise; every step's loss checked for finiteness at the end."""
        losses = []
        _sync(self.dev)
        t0 = time.perf_counter()
        while True:
            self.state, m = self.step_fn(self.state, self.p_scene, self.p_store, self.phase)
            losses.append(m["loss"])
            if len(losses) >= max_units if max_units is not None else time.perf_counter() - t0 >= seconds:
                break
        _sync(self.dev)
        dt = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"units": len(losses), "seconds": dt, "rays": len(losses) * self.batch, "failed": failed,
                "unit_flops": work.train_step_flops(self.cfg["dims"], self.phase, self.batch)}

    def record(self) -> Dict:
        """What a per-layer metric needs besides the run's numbers."""
        return {"dims": self.cfg["dims"],
                "passes": [("fwd", self.phase, self.batch, s) for s in work.passes(self.cfg["dims"])]
                + [("bwd", self.phase, self.batch, s) for s in work.passes(self.cfg["dims"])]}

    def release(self) -> None:
        """Drop the program's state; the scene and the inputs stay."""
        self.state = self.step_fn = None
        if self._undo is not None:
            self._undo()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str) -> Dict:
        return ref_steps.train_steps(self.weights, self.pose_tables, self.scene, self.store, self.hp,
                                     self.cfg["dims"], draw_seed=self.draw_seed, start=self.start, phase=self.phase,
                                     n_steps=self.traffic["check_steps"], precision=precision)


def _plant_half_batch(tstep):
    """A fault for the check's own test: the loss of the first half of the
    batch alone, its mean over those rows. Returns its undo."""
    inner = tstep._loss_and_metrics

    def half(params, pose_params, cfg, scene, batch, noise, *a):
        n = batch["px"].shape[0] // 2
        return inner(params, pose_params, cfg, scene, {k: v[:n] for k, v in batch.items()},
                     {k: v[:n] for k, v in noise.items()}, *a)

    tstep._loss_and_metrics = half
    return lambda: setattr(tstep, "_loss_and_metrics", inner)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
