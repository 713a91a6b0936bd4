"""Host training loop (upnerf/train/loop.py), on one device.

`Trainer(hparams, device)` builds the device-resident scene and ray store
(load_training_data), the two modules and their Adam optimizers, the train
step and the val renderer; `fit()` drives the step with the schedule phase
derived from progress, reads the metrics back only every `log_every` steps
(the steps queue on the device in between), renders the val images, logs the
pose errors, checkpoints with auto-resume and `resume_ckpt`, recovers from a
non-finite loss by restoring the latest checkpoint with a reseeded generator
(up to `train.max_nan_restarts` times), stops cleanly between steps on
SIGTERM / SIGINT, and with `train.profile_at` traces `train.profile_steps`
steps with torch.profiler. The GT-free pose-warp detector logs flagged images.

Not ported: the mesh / multi-process branches (`tpu.n_devices` > 1, `dist.*`),
the host prefetcher (`tpu.store_on_device` false) and the warp mitigations;
each raises with its ROADMAP item.
"""

from __future__ import annotations

import math
import os
import signal
import threading
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from upnerf_torch.data import SceneMeta, load_training_data
from upnerf_torch.data.images import load_rgb_u8
from upnerf_torch.evaluate.metrics import psnr as psnr_fn
from upnerf_torch.geometry import procrustes, se3
from upnerf_torch.utils.ckpt import CheckpointManager
from upnerf_torch.utils.logging import MetricLogger
from upnerf_torch.utils.viz import get_pca_img, visualize_depth
from upnerf_torch.utils.weights import reference_payload

from .optim import make_optimizer
from .schedules import pe_progress, schedule_phase
from .state import TrainState, init_params, init_pose_params, make_ray_store, make_scene_constants, make_train_state
from .step import StepConfig, make_eval_render, make_train_step
from .warp import WarpConfig, WarpDetector


def check_supported(hp: Dict[str, Any]) -> None:
    """Raise on the JAX trainer's configurations the port does not run."""
    if not bool(hp.get("tpu.store_on_device", True)):
        raise NotImplementedError("tpu.store_on_device false (the host prefetcher) is not ported (ROADMAP.md)")
    if int(hp.get("tpu.n_devices", 0) or 0) > 1:
        raise NotImplementedError("tpu.n_devices > 1 needs torch.distributed, which is not ported (ROADMAP.md)")
    if any(k.startswith("dist.") and v not in (None, False, 0, "") for k, v in hp.items()):
        raise NotImplementedError("dist.* (multi-process training) is not ported (ROADMAP.md)")


class Trainer:
    def __init__(self, hparams: Dict[str, Any], device="cuda"):
        check_supported(hparams)
        self.hp = hp = hparams
        self.device = torch.device(device)
        self.cfg = StepConfig.from_hparams(hparams)
        self.max_steps = hp["max_steps"]
        self.debug = hp.get("debug", False)
        self.seed = hp.get("seed", 42)
        self._nan_restarts = 0  # divergence-watchdog budget spent so far
        self._preempted = None

        scene_np, store_np, meta = load_training_data(hparams)
        self.meta: SceneMeta = meta
        self.ray_offsets = np.asarray(scene_np["ray_offsets"])
        self.n_images = meta.N_images_train
        pyr_sigma = float(hp.get("feat.pyramid_sigma", 0.0) or 0.0)
        self.scene = make_scene_constants(
            scene_np["Ks"], scene_np["poses"], scene_np["near_far"], scene_np["wh"], scene_np["feat_maps"],
            self.device, feat_pyramid_sigma=pyr_sigma if hp.get("feat.c2f") else 0.0,
        )
        self.store = make_ray_store(store_np["px"], store_np["py"], store_np["img_idx"], store_np["rgb"],
                                    store_np["inv_depth"], self.device)
        self.n_rays = self.store.n_rays

        self.optimizer = make_optimizer(hp["optimizer.type"], hp["optimizer.lr"], hp["optimizer.scheduler.lr_end"],
                                        self.max_steps, hp["optimizer.scheduler.type"])
        self.pose_optimizer = make_optimizer(hp["optimizer_pose.type"], hp["optimizer_pose.lr"],
                                             hp["optimizer_pose.scheduler.lr_end"], self.max_steps,
                                             hp["optimizer_pose.scheduler.type"])
        params = init_params(self.cfg.nerf, self.cfg.transient, self.n_images,
                             generator=torch.Generator().manual_seed(self.seed))
        self.state: TrainState = make_train_state(params, init_pose_params(self.n_images), self.optimizer,
                                                  self.pose_optimizer, self.seed + 1, self.device)
        self.step_fn, self.batch_step_fn = make_train_step(self.cfg, self.optimizer, self.pose_optimizer)
        self.eval_render = make_eval_render(self.cfg, hp["val.chunk_size"])

        self.save_dir = os.path.join(hp["out_dir"], hp["scene_name"], hp["exp_name"])
        os.makedirs(self.save_dir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(self.save_dir, "ckpts"))
        self.logger = MetricLogger(self.save_dir)

        # val cadence: a fraction of an epoch (Lightning's val_check_interval) or steps when >= 1
        li = hp["val.log_interval"]
        steps_per_epoch = max(1, self.n_rays // self.cfg.batch_size)
        self.val_interval = int(li) if li >= 1 else max(1, int(li * steps_per_epoch))
        self.ckpt_interval = hp.get("train.ckpt_interval", 10000)
        self.log_pose_interval = hp.get("train.log_pose_interval", 3000)

        self.warp_cfg = WarpConfig.from_hparams(hp)
        self._warp = WarpDetector(self.n_images, self.warp_cfg) if self.warp_cfg.detect and self.cfg.pose_optimize \
            else None
        self.val_img_idx = list(hp.get("val.img_idx", (0,)))
        self._setup_val_scale()

    def _setup_val_scale(self) -> None:
        """Val renders at downscale >= 2 even for scale-1 training (the
        reference's memory guard): the val images and intrinsics are loaded
        separately at the floored scale."""
        self.val_scale = max(2, self.meta.scale)
        self.val_data = None
        if self.val_scale == self.meta.scale:
            return
        factor = self.meta.scale / self.val_scale
        val_Ks = self.scene.Ks.clone()
        val_Ks[:, :2, :] *= factor  # fx, fy, cx, cy scale with the resolution
        rgbs = {}
        for img_i in self.val_img_idx:
            id_ = self.meta.img_ids_train[img_i]
            rgbs[img_i] = load_rgb_u8(os.path.join(self.meta.image_dir, self.meta.image_paths[id_]), self.val_scale)
        val_wh = np.maximum((self.scene.wh.cpu().numpy() * factor).astype(np.int64), 1)
        for img_i, img in rgbs.items():
            val_wh[img_i] = [img.shape[1], img.shape[0]]
        self.val_data = {
            "scene": self.scene._replace(Ks=val_Ks, wh=torch.as_tensor(val_wh, dtype=torch.int32, device=self.device)),
            "rgbs": rgbs,
        }

    # --- checkpoints ---------------------------------------------------------

    def _payload(self) -> Dict[str, Any]:
        """The state as a reference checkpoint plus both optimizers' and
        schedulers' states and the generator's."""
        st = self.state
        payload = reference_payload(st.params, st.pose_params, self.hp, st.step,
                                    pe_progress(st.step, self.max_steps))
        payload["optimizer_states"] = [st.opt_state.optimizer.state_dict(), st.pose_opt_state.optimizer.state_dict()]
        payload["lr_schedulers"] = [st.opt_state.scheduler.state_dict(), st.pose_opt_state.scheduler.state_dict()]
        payload["generator"] = st.generator.get_state()
        return payload

    def _restore(self, payload: Dict[str, Any]) -> None:
        """Load a checkpoint payload into the state in place."""
        st = self.state
        sd = payload["state_dict"]
        pose_keys = set(st.pose_params.state_dict())
        st.params.load_state_dict({k: v for k, v in sd.items() if k not in pose_keys})
        st.pose_params.load_state_dict({k: v for k, v in sd.items() if k in pose_keys})
        for opt, o_sd, s_sd in zip((st.opt_state, st.pose_opt_state), payload["optimizer_states"],
                                   payload["lr_schedulers"]):
            opt.optimizer.load_state_dict(o_sd)
            opt.scheduler.load_state_dict(s_sd)
        st.generator.set_state(payload["generator"])
        self.state = st._replace(step=int(payload["global_step"]))

    def _load_explicit(self, path: str) -> Dict[str, Any]:
        """`resume_ckpt`: a checkpoint file, a run directory (its ckpts/) or a
        checkpoint directory; a directory gives its latest step."""
        path = os.path.abspath(str(path))
        if os.path.isfile(path):
            return torch.load(path, map_location="cpu", weights_only=False)
        if os.path.isdir(os.path.join(path, "ckpts")):
            path = os.path.join(path, "ckpts")
        return CheckpointManager(path).load()

    # --- training ------------------------------------------------------------

    def fit(self, log_every: int = 100, resume: bool = True, max_steps: Optional[int] = None) -> TrainState:
        resume_ckpt = self.hp.get("resume_ckpt")
        if resume and resume_ckpt not in (None, "None", ""):
            self._restore(self._load_explicit(resume_ckpt))  # an explicit checkpoint wins over auto-resume
            print(f"[upnerf_torch] restarted from {resume_ckpt} at step {self.state.step}", flush=True)
        elif resume and self.ckpt.latest_step() is not None:
            self._restore(self.ckpt.load())
            print(f"[upnerf_torch] resumed from step {self.state.step}", flush=True)
        max_steps = max_steps or self.max_steps

        t0 = time.time()
        window_rays = 0
        last_saved = None
        step = self.state.step
        restore_handlers = self._install_preemption_handlers()
        profile_at = int(self.hp.get("train.profile_at", 0) or 0)
        profile_steps = int(self.hp.get("train.profile_steps", 3))
        profiler = None
        try:
            while step < max_steps:
                phase = schedule_phase(step / self.max_steps, self.cfg.candidate_schedule)
                self.state, metrics = self.step_fn(self.state, self.scene, self.store, phase)
                step += 1
                window_rays += self.cfg.batch_size

                if profile_at and step == profile_at:
                    profiler = self._start_profile()
                if profiler is not None and step >= profile_at + profile_steps:
                    self._stop_profile(profiler, profile_steps, profile_at)
                    profiler = None

                if step % log_every == 0 or step == max_steps:
                    img_sum, img_cnt = metrics.pop("img_loss_sum", None), metrics.pop("img_loss_cnt", None)
                    names = list(metrics)
                    vals = torch.stack([metrics[k].detach().float().reshape(()) for k in names]).cpu().tolist()
                    m = dict(zip(names, vals))
                    # divergence watchdog: the total loss only (psnr is +inf on a perfect fit)
                    if not math.isfinite(m.get("loss", 0.0)):
                        step = self._recover_from_nonfinite(step, m)
                        t0, window_rays = time.time(), 0
                        continue
                    m["rays_per_sec"] = window_rays / max(time.time() - t0, 1e-9)
                    m["lr"] = self.state.opt_state.scheduler.get_last_lr()[0]
                    m["lr_pose"] = self.state.pose_opt_state.scheduler.get_last_lr()[0]
                    m["phase"] = phase
                    self.logger.log(step, m)
                    if self._warp is not None and img_sum is not None:
                        self._warp_check(step, img_sum.cpu().numpy(), img_cnt.cpu().numpy())
                    t0, window_rays = time.time(), 0

                if self.log_pose_interval and step % self.log_pose_interval == 0:
                    self.log_pose(step)
                if step % self.val_interval == 0 or step == max_steps:
                    val_psnr = self.validate(step)
                    self.ckpt.save(step, self._payload(), {"val_psnr": val_psnr})
                    last_saved = step
                elif step % self.ckpt_interval == 0:
                    self.ckpt.save(step, self._payload())
                    last_saved = step

                if self._preempted is not None:
                    # between steps the state is consistent: checkpoint it and leave
                    if last_saved != step:
                        self.ckpt.save(step, self._payload())
                        last_saved = step
                    print(f"[upnerf_torch] caught signal {self._preempted}; checkpointed step {step} and stopped"
                          " cleanly", flush=True)
                    break
        finally:
            if profiler is not None:  # fit ended mid-capture
                profiler.stop()
            for sig, old in restore_handlers.items():
                signal.signal(sig, old)
        return self.state

    def _start_profile(self):
        self._sync()
        profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                          + ([torch.profiler.ProfilerActivity.CUDA] if self.device.type == "cuda"
                                             else []))
        profiler.start()
        return profiler

    def _stop_profile(self, profiler, n: int, start: int) -> None:
        self._sync()
        profiler.stop()
        out = os.path.join(self.save_dir, "profile")
        os.makedirs(out, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(out, "trace.json"))
        sort = "self_cuda_time_total" if self.device.type == "cuda" else "self_cpu_time_total"
        with open(os.path.join(out, "table.txt"), "w") as f:
            f.write(profiler.key_averages().table(sort_by=sort, row_limit=40))
        print(f"[upnerf_torch] trace of {n} steps from step {start} -> {out}", flush=True)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _install_preemption_handlers(self):
        """SIGTERM / SIGINT set a flag that fit() checks between steps; the
        original handlers come back when fit() returns. A second SIGINT falls
        through to KeyboardInterrupt. Off the main thread no handler is set."""
        self._preempted = None
        restore = {}
        if not bool(self.hp.get("train.graceful_shutdown", True)):
            return restore
        if threading.current_thread() is not threading.main_thread():
            return restore

        def _flag(signum, frame):
            self._preempted = signum
            if signum == signal.SIGINT:
                signal.signal(signal.SIGINT, restore[signal.SIGINT])

        for sig in (signal.SIGTERM, signal.SIGINT):
            restore[sig] = signal.signal(sig, _flag)
        return restore

    def _warp_check(self, step: int, img_sum: np.ndarray, img_cnt: np.ndarray) -> None:
        flags = self._warp.update(img_sum, img_cnt, step / self.max_steps)
        self.logger.log(step, {"train/warp_max_ratio": float(self._warp.ema.max())})
        if flags.any():
            self.logger.log(step, {"train/warp_flagged": float(flags.sum())})
            print(f"[upnerf_torch] warp detector: image(s) {np.nonzero(flags)[0].tolist()} stalled above"
                  f" {self.warp_cfg.ratio}x median loss at step {step}", flush=True)

    def _recover_from_nonfinite(self, step: int, m: Dict[str, float]) -> int:
        """Divergence watchdog: a non-finite total loss at a log point means the
        updates already poisoned the state. Restore the latest checkpoint,
        reseed the generator from (seed, restart count) so the retry draws other
        batches, and abort once `train.max_nan_restarts` restores are spent (or
        none exists)."""
        self._nan_restarts += 1
        budget = int(self.hp.get("train.max_nan_restarts", 2))
        bad = sorted(k for k, v in m.items() if (k == "loss" or k.startswith("loss/")) and not math.isfinite(v))
        if self.ckpt.latest_step() is None:
            raise FloatingPointError(f"non-finite loss at step {step} ({bad}) before the first checkpoint — lower"
                                     " the learning rate or check the data")
        if self._nan_restarts > budget:
            raise FloatingPointError(f"non-finite loss at step {step} ({bad}) after {budget} checkpoint restore(s) —"
                                     " training diverges reproducibly; lower the learning rate or check the data")
        self._restore(self.ckpt.load())
        restored = self.state.step
        self.state.generator.manual_seed((self.seed + 1) * 1_000_003 + self._nan_restarts)
        self.logger.log(step, {"train/nonfinite_restart": float(restored)})
        print(f"[upnerf_torch] non-finite loss at step {step} ({bad}); restored step {restored}, retry"
              f" {self._nan_restarts}/{budget}", flush=True)
        return restored

    # --- validation ----------------------------------------------------------

    def _pixels(self, px: np.ndarray, py: np.ndarray, invd: np.ndarray, img_i: int):
        """A val batch on the device, padded to a multiple of the chunk."""
        n = len(px)
        pad = (-n) % self.hp["val.chunk_size"]
        batch = {
            "px": np.pad(px, (0, pad)).astype(np.float32),
            "py": np.pad(py, (0, pad)).astype(np.float32),
            "img_idx": np.full(n + pad, img_i, np.int64),
            "inv_depth": np.pad(invd, (0, pad)).astype(np.float32),
        }
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}, n

    def render_image(self, img_i: int):
        """Render one train image at the current state: (results cropped to
        its pixels, as numpy, (W, H))."""
        if self.val_data is not None:
            img = self.val_data["rgbs"][img_i]
            h, w = img.shape[:2]
            jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            batch, n = self._pixels(ii.ravel(), jj.ravel(), np.zeros(h * w, np.float32), img_i)
            scene = self.val_data["scene"]
        else:
            lo, hi = int(self.ray_offsets[img_i]), int(self.ray_offsets[img_i + 1])
            s = self.store
            batch, n = self._pixels(s.px[lo:hi].cpu().numpy(), s.py[lo:hi].cpu().numpy(),
                                    s.inv_depth[lo:hi].float().cpu().numpy(), img_i)
            scene = self.scene
        step = self.state.step
        progress = pe_progress(step, self.max_steps)
        phase = schedule_phase(step / self.max_steps, self.cfg.candidate_schedule)
        out = self.eval_render(self.state.params, self.state.pose_params, scene, batch, progress, phase)
        out = {k: v[:n].float().cpu().numpy() for k, v in out.items()}
        w, h = (int(x) for x in scene.wh[img_i].tolist())
        return out, (w, h)

    def validate(self, step: int) -> float:
        psnrs = []
        for img_i in self.val_img_idx:
            out, (w, h) = self.render_image(img_i)
            if self.val_data is not None:
                rgb_gt = self.val_data["rgbs"][img_i].reshape(-1, 3).astype(np.float32) / 255.0
            else:
                lo, hi = int(self.ray_offsets[img_i]), int(self.ray_offsets[img_i + 1])
                rgb_gt = self.store.rgb[lo:hi].cpu().numpy().astype(np.float32) / 255.0
            # val PSNR on the transient-composited rgb where there is one
            typ = "fine" if self.cfg.loss.fine else "coarse"
            key = next((k for k in (f"rgb_{typ}", f"s_rgb_{typ}") if k in out), None)
            if key is not None:
                psnrs.append(float(psnr_fn(torch.from_numpy(out[key]), torch.from_numpy(rgb_gt))))
            if not self.debug:
                self._log_val_images(step, img_i, out, rgb_gt, (w, h))
        val_psnr = float(np.mean(psnrs)) if psnrs else 0.0
        self.logger.log(step, {"val/psnr": val_psnr})
        return val_psnr

    def _log_val_images(self, step, img_i, out, rgb_gt, wh) -> None:
        """Panels named as the reference's: val_{idx}/viz/<name>."""
        w, h = wh

        def _pca(img):
            flat = img.reshape(-1, img.shape[-1])
            mean = flat.mean(0)
            _, _, vt = np.linalg.svd(flat[:: max(1, len(flat) // 2048)] - mean, full_matrices=False)
            return get_pca_img(img, mean, vt[:3])

        self.logger.log_image(step, f"val_{img_i}/viz/rgb_GT", rgb_gt.reshape(h, w, 3))
        if "feats_gt" in out:
            self.logger.log_image(step, f"val_{img_i}/viz/feat_GT", _pca(out["feats_gt"].reshape(h, w, -1)))
        if "pred_depth" in out:
            self.logger.log_image(step, f"val_{img_i}/viz/rescale_depth_GT",
                                  visualize_depth(out["pred_depth"].reshape(h, w)))
        for name in self.hp.get("val.log_image_list", ()):
            try:
                if name in ("t_beta", "t_alpha", "t_rgb") and name in out:
                    img = out[name].reshape(h, w, -1)
                    img = img / max(img.max(), 1e-9)
                    self.logger.log_image(step, f"val_{img_i}/viz/{name}",
                                          np.repeat(img, 3, -1) if img.shape[-1] == 1 else img)
                elif "depth" in name and name in out:
                    self.logger.log_image(step, f"val_{img_i}/viz/{name}", visualize_depth(out[name].reshape(h, w)))
                elif "feat" in name and name in out:
                    self.logger.log_image(step, f"val_{img_i}/viz/{name}", _pca(out[name].reshape(h, w, -1)))
                elif "rgb" in name and name in out:
                    self.logger.log_image(step, f"val_{img_i}/viz/{name}", out[name].reshape(h, w, 3))
            except Exception as e:  # a panel must never stop training, but a broken one should show
                warnings.warn(f"val image panel {name!r} failed: {e!r}")

    # --- pose errors ---------------------------------------------------------

    def log_pose(self, step: int) -> None:
        if self.meta.GT_poses_dict is None:
            return
        ids = self.meta.img_ids_train
        base = torch.as_tensor(np.stack([np.asarray(self.meta.poses_dict[i], np.float32) for i in ids]))
        gt = torch.as_tensor(np.stack([np.asarray(self.meta.GT_poses_dict[i], np.float32) for i in ids]))
        with torch.no_grad():
            refine = se3.se3_to_SE3(self.state.pose_params.se3_refine.weight.detach().float().cpu())
            refined = se3.compose([refine, base])
        err, aligned, gt_parsed = procrustes.pose_metric(refined, gt)
        # the gauge-free pairwise metric beside the Procrustes one, which is
        # reflection-bistable on small or near-coplanar camera sets
        rel = procrustes.relative_pose_error(refined, gt)
        pose_m = {"train/pose_R_rel": float(np.mean(rel["R"])) * 180 / math.pi,
                  "train/pose_t_rel": float(np.mean(rel["t"]))}
        if err is not None:
            pose_m["train/pose_R"] = float(err["R"].mean()) * 180 / math.pi
            pose_m["train/pose_t"] = float(err["t"].mean())
        self.logger.log(step, pose_m)
        if not self.debug:
            try:
                from upnerf_torch.utils.viz import get_pose_image

                n = min(20, len(refined))
                self.logger.log_image(step, "train/refine_pose",
                                      get_pose_image(aligned.numpy()[:n], gt_parsed.numpy()[:n]))
            except Exception as e:  # matplotlib may be missing; a broken panel should show
                warnings.warn(f"pose viz panel failed: {e!r}")
