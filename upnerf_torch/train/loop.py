"""Host training loop (upnerf/train/loop.py), on one device or data-parallel.

`Trainer(hparams, device)` builds the device-resident scene and ray store
(load_training_data) or, with `tpu.store_on_device` false, keeps the store on
the host behind a `data.prefetch.BatchPrefetcher` (seeded with `seed`; its
draws are not checkpointed, as in the JAX package), the two modules and their
optimizers, the train
step and the val renderer; `fit()` drives the step with the schedule phase
derived from progress, reads the metrics back only every `log_every` steps
(the steps queue on the device in between), renders the val images, logs the
pose errors, checkpoints with auto-resume and `resume_ckpt`, recovers from a
non-finite loss by restoring the latest checkpoint with a reseeded generator
(up to `train.max_nan_restarts` times), stops cleanly between steps on
SIGTERM / SIGINT, and with `train.profile_at` traces `train.profile_steps`
steps with torch.profiler (`utils/profiling.py:trace`, the program's spans
on). The GT-free pose-warp detector logs flagged images
and, with `pose.warp.mitigate` multistart or reset, adopts new poses for them
(train/warp.py): the se3 rows are written in place and their optimizer
moments zeroed, within the event budget and after each event a cooldown.

Data-parallel (`upnerf_torch.parallel`): in a process group every rank runs
this loop over the data mesh (`tpu.n_devices` and the group: rays sharded,
state replicated, each step's gradients and metrics all-reduced). Every rank
holds the same state, so each takes the same warp decisions, restores the
same checkpoints and sees the same metrics. Rank 0 alone writes the metric
log, images and checkpoints, each save followed by a barrier; every rank
restores. The host prefetcher of rank r draws batch_size / world rows with
seed `seed + r`. Val renders split each chunk's rays across the ranks. Each
rank traces into its own `profile-proc<rank>` directory. On SIGTERM every rank
saves between steps: the save's barrier needs each rank to get the signal, as
a scheduler's preemption delivers it (the JAX package's collective save has
the same contract). At the end of `fit` the ranks' parameters are held equal
bit for bit (`parallel.assert_replicated`).
"""

from __future__ import annotations

import contextlib
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
from upnerf_torch.data.prefetch import BatchPrefetcher
from upnerf_torch.evaluate.metrics import psnr as psnr_fn
from upnerf_torch.geometry import procrustes, se3
from upnerf_torch.parallel import DataMesh, assert_replicated, fetch, make_mesh, put_replicated, sync
from upnerf_torch.utils import profiling
from upnerf_torch.utils.ckpt import CheckpointManager
from upnerf_torch.utils.logging import MetricLogger
from upnerf_torch.utils.viz import get_pca_img, visualize_depth
from upnerf_torch.utils.weights import reference_payload

from . import warp as warp_mod
from .optim import learning_rate_at, make_optimizer
from .schedules import pe_progress, schedule_phase
from .state import TrainState, init_params, init_pose_params, make_ray_store, make_scene_constants, make_train_state
from .step import StepConfig, make_eval_render, make_train_step


class _NullLogger:
    """The metric sink of ranks other than 0: every rank runs the same steps,
    rank 0 alone writes."""

    def log(self, *a, **k):
        pass

    def log_image(self, *a, **k):
        pass

    def close(self):
        pass


class Trainer:
    def __init__(self, hparams: Dict[str, Any], device="cuda"):
        self.hp = hp = hparams
        self.device = torch.device(device)
        # the data mesh: this process alone, or every rank of the process group (`tpu.data_axis` is the old name)
        self.mesh = make_mesh(hp.get("tpu.n_devices", hp.get("tpu.data_axis", 0)), self.device)
        self.multiprocess = self.mesh.size > 1
        self.is_main = self.mesh.rank == 0
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
        self.store_on_device = bool(hp.get("tpu.store_on_device", True))
        self.store = self.store_np = self.prefetcher = None
        if self.store_on_device:
            self.store = make_ray_store(store_np["px"], store_np["py"], store_np["img_idx"], store_np["rgb"],
                                        store_np["inv_depth"], self.device)
        else:  # each rank draws its own rows of the batch from its own stream
            if self.cfg.batch_size % self.mesh.size:
                raise ValueError(f"train.batch_size {self.cfg.batch_size} does not split over {self.mesh.size} ranks")
            self.store_np = store_np
            self._open_prefetcher()
        self.n_rays = int(store_np["px"].shape[0])

        self.optimizer = make_optimizer(hp["optimizer.type"], hp["optimizer.lr"], hp["optimizer.scheduler.lr_end"],
                                        self.max_steps, hp["optimizer.scheduler.type"])
        self.pose_optimizer = make_optimizer(hp["optimizer_pose.type"], hp["optimizer_pose.lr"],
                                             hp["optimizer_pose.scheduler.lr_end"], self.max_steps,
                                             hp["optimizer_pose.scheduler.type"])
        params = init_params(self.cfg.nerf, self.cfg.transient, self.n_images,
                             generator=torch.Generator().manual_seed(self.seed))
        self.state: TrainState = make_train_state(params, init_pose_params(self.n_images), self.optimizer,
                                                  self.pose_optimizer, self.seed + 1, self.device)
        put_replicated([self.state.params, self.state.pose_params], self.mesh)
        self.step_fn, self.batch_step_fn = make_train_step(self.cfg, self.optimizer, self.pose_optimizer, self.mesh)
        # val renders split each chunk across the ranks where it divides; else every rank renders it all
        self.eval_render = make_eval_render(self.cfg, hp["val.chunk_size"],
                                            self.mesh if hp["val.chunk_size"] % self.mesh.size == 0 else DataMesh())

        self.save_dir = os.path.join(hp["out_dir"], hp["scene_name"], hp["exp_name"])
        os.makedirs(self.save_dir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(self.save_dir, "ckpts"))
        self.logger = MetricLogger(self.save_dir) if self.is_main else _NullLogger()

        # val cadence: a fraction of an epoch (Lightning's val_check_interval) or steps when >= 1
        li = hp["val.log_interval"]
        steps_per_epoch = max(1, self.n_rays // self.cfg.batch_size)
        self.val_interval = int(li) if li >= 1 else max(1, int(li * steps_per_epoch))
        self.ckpt_interval = hp.get("train.ckpt_interval", 10000)
        self.log_pose_interval = hp.get("train.log_pose_interval", 3000)

        # the GT-free pose-warp detector and its mitigation (train/warp.py)
        self.warp_cfg = warp_mod.WarpConfig.from_hparams(hp)
        if self.warp_cfg.mitigate == "multistart" and not self.cfg.nerf.encode_feat:
            warnings.warn("pose.warp.mitigate=multistart needs feature encoding (nerf.feat_dim > 0); mitigation"
                          " disabled")
            self.warp_cfg = self.warp_cfg._replace(mitigate="none")
        self._warp = warp_mod.WarpDetector(self.n_images, self.warp_cfg) \
            if self.warp_cfg.detect and self.cfg.pose_optimize else None
        self._warp_scorer = None
        self._warp_rng = np.random.RandomState(self.seed + 977)
        self.warp_adoptions = []  # (step, adopted rows) of each event that adopted any
        self.val_img_idx = list(hp.get("val.img_idx", (0,)))
        self._setup_val_scale()

    def _open_prefetcher(self) -> None:
        """The host store's prefetcher of this rank's rows (a fit() after a fit() starts a new one, from the seed)."""
        self.prefetcher = BatchPrefetcher(self.store_np, self.cfg.batch_size // self.mesh.size, self.device,
                                          seed=self.seed + self.mesh.rank)

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
        """Load a checkpoint payload into the state in place. A converted
        reference checkpoint (cli.convert_weights model) carries no optimizer
        or generator state: the optimizers start fresh, as the JAX package's
        converted runs do."""
        st = self.state
        sd = payload["state_dict"]
        pose_keys = set(st.pose_params.state_dict())
        st.params.load_state_dict({k: v for k, v in sd.items() if k not in pose_keys})
        st.pose_params.load_state_dict({k: v for k, v in sd.items() if k in pose_keys})
        for opt, o_sd, s_sd in zip((st.opt_state, st.pose_opt_state), payload.get("optimizer_states", ()),
                                   payload.get("lr_schedulers", ())):
            opt.optimizer.load_state_dict(o_sd)
            opt.scheduler.load_state_dict(s_sd)
        if "generator" in payload:
            st.generator.set_state(payload["generator"])
        self.state = st._replace(step=int(payload["global_step"]))

    def _save(self, step: int, metrics: Optional[dict] = None) -> None:
        """Rank 0 writes the checkpoint; every rank waits for it. The payload
        records the schedule's progress in the fields: every rank does, so
        the replicas stay equal."""
        self.state.params.set_progress(pe_progress(self.state.step, self.max_steps))
        if self.is_main:
            self.ckpt.save(step, self._payload(), metrics)
        sync("upnerf_torch:ckpt")

    def _log(self, msg: str) -> None:
        if self.is_main:
            print(msg, flush=True)

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
            self._log(f"[upnerf_torch] restarted from {resume_ckpt} at step {self.state.step}")
        elif resume and self.ckpt.latest_step() is not None:
            self._restore(self.ckpt.load())
            self._log(f"[upnerf_torch] resumed from step {self.state.step}")
        max_steps = max_steps or self.max_steps
        hp = self.hp
        if self.store_np is not None and self.prefetcher is None:
            self._open_prefetcher()

        t0 = time.time()
        window_rays = 0
        last_saved = None
        step = self.state.step
        restore_handlers = self._install_preemption_handlers()
        profile_at = int(self.hp.get("train.profile_at", 0) or 0)
        profile_steps = int(self.hp.get("train.profile_steps", 3))
        capture = None
        try:
            while step < max_steps:
                phase = schedule_phase(step / self.max_steps, self.cfg.candidate_schedule)
                if self.store_on_device:
                    self.state, metrics = self.step_fn(self.state, self.scene, self.store, phase)
                else:
                    self.state, metrics = self.batch_step_fn(self.state, self.scene, next(self.prefetcher), phase,
                                                             local=True)
                step += 1
                window_rays += self.cfg.batch_size

                if profile_at and step == profile_at:
                    capture = self._start_profile()
                if capture is not None and step >= profile_at + profile_steps:
                    self._stop_profile(capture, profile_steps, profile_at)
                    capture = None

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
                    m["lr"] = learning_rate_at(step, hp["optimizer.lr"], hp["optimizer.scheduler.lr_end"],
                                               self.max_steps, hp["optimizer.scheduler.type"])
                    m["lr_pose"] = learning_rate_at(step, hp["optimizer_pose.lr"],
                                                    hp["optimizer_pose.scheduler.lr_end"], self.max_steps,
                                                    hp["optimizer_pose.scheduler.type"])
                    m["phase"] = phase
                    self.logger.log(step, m)
                    if self._warp is not None and img_sum is not None:
                        self._warp_check(step, img_sum.cpu().numpy(), img_cnt.cpu().numpy())
                    t0, window_rays = time.time(), 0

                if self.log_pose_interval and step % self.log_pose_interval == 0:
                    self.log_pose(step)
                if step % self.val_interval == 0 or step == max_steps:
                    val_psnr = self.validate(step)
                    self._save(step, {"val_psnr": val_psnr})
                    last_saved = step
                elif step % self.ckpt_interval == 0:
                    self._save(step)
                    last_saved = step

                if self._preempted is not None:
                    # between steps the state is consistent: checkpoint it and leave
                    if last_saved != step:
                        self._save(step)
                        last_saved = step
                    self._log(f"[upnerf_torch] caught signal {self._preempted}; checkpointed step {step} and stopped"
                              " cleanly")
                    break
        finally:
            if capture is not None:  # fit ended mid-capture: the steps captured are written
                capture.close()
            for sig, old in restore_handlers.items():
                signal.signal(sig, old)
            if self.prefetcher is not None:
                self.prefetcher.close()
                self.prefetcher = None
        assert_replicated([self.state.params, self.state.pose_params], self.mesh, "parameters")
        return self.state

    def _profile_dir(self) -> str:
        return os.path.join(self.save_dir, "profile" + (f"-proc{self.mesh.rank}" if self.multiprocess else ""))

    def _start_profile(self) -> contextlib.ExitStack:
        """A `profiling.trace` into the profile directory with the program's
        spans on, so the trace shows each step's stages; closing it writes
        the trace."""
        self._sync()
        capture = contextlib.ExitStack()
        capture.enter_context(profiling.trace(self._profile_dir()))
        capture.enter_context(profiling.spans())
        return capture

    def _stop_profile(self, capture: contextlib.ExitStack, n: int, start: int) -> None:
        self._sync()
        capture.close()
        self._log(f"[upnerf_torch] trace of {n} steps from step {start} -> {self._profile_dir()}")

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
        """Feed one log point's per-image loss vectors to the warp detector;
        on flags, within the budget, run the configured mitigation."""
        flags = self._warp.update(img_sum, img_cnt, step / self.max_steps)
        # the worst EMA ratio, always: the audit trail for tuning pose.warp.ratio
        self.logger.log(step, {"train/warp_max_ratio": float(self._warp.ema.max())})
        if not flags.any():
            return
        self.logger.log(step, {"train/warp_flagged": float(flags.sum())})
        self._log(f"[upnerf_torch] warp detector: image(s) {np.nonzero(flags)[0].tolist()} stalled above"
                  f" {self.warp_cfg.ratio}x median loss at step {step}")
        if self.warp_cfg.mitigate == "none" or not self._warp.budget_left:
            return
        table = self.state.pose_params.se3_refine.weight
        se3_tab = table.detach().cpu().numpy()
        if self.warp_cfg.mitigate == "reset":
            # every flagged row back to its base pose, unscored: in a collective warp the field co-adapts to the
            # warped poses, so a scored comparison keeps the incumbent; the DINO targets re-align the reset rows
            new_tab = np.array(se3_tab)
            new_tab[flags] = 0.0
            adopted = np.nonzero(flags)[0]
        else:
            if self._warp_scorer is None:
                self._warp_scorer = warp_mod.make_pose_scorer(self.cfg, self.warp_cfg.score_rays,
                                                              self.warp_cfg.score_progress)
            new_tab, adopted = warp_mod.run_multistart(self._warp_scorer, self.state.params, self.scene, se3_tab,
                                                       flags, self.scene.wh.cpu().numpy(), self.warp_cfg,
                                                       self._warp_rng, log=self._log)
        self._warp.start_cooldown()
        if adopted.size == 0:
            return
        with torch.no_grad():
            table.copy_(torch.as_tensor(new_tab, device=table.device))
        warp_mod.reset_opt_rows(self.state.pose_opt_state, adopted, tuple(se3_tab.shape))
        self.warp_adoptions.append((step, adopted))
        self.logger.log(step, {"train/warp_event": float(adopted.size),
                               "train/warp_events_total": float(self._warp.events)})
        self._log(f"[upnerf_torch] warp {self.warp_cfg.mitigate} adopted new pose(s) for image(s) {adopted.tolist()}"
                  f" at step {step} (event {self._warp.events}/{self.warp_cfg.max_events})")

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
        self._log(f"[upnerf_torch] non-finite loss at step {step} ({bad}); restored step {restored}, retry"
                  f" {self._nan_restarts}/{budget}")
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

    def _store_rows(self, key: str, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of one store array, from the device store or the host one."""
        if self.store_np is not None:
            return np.asarray(self.store_np[key][lo:hi])
        return getattr(self.store, key)[lo:hi].cpu().numpy()

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
            px, py, invd = self._store_rows("px", lo, hi), self._store_rows("py", lo, hi), \
                self._store_rows("inv_depth", lo, hi)
            batch, n = self._pixels(px, py, invd.astype(np.float32), img_i)
            scene = self.scene
        step = self.state.step
        progress = pe_progress(step, self.max_steps)
        phase = schedule_phase(step / self.max_steps, self.cfg.candidate_schedule)
        out = self.eval_render(self.state.params, self.state.pose_params, scene, batch, progress, phase)
        out = {k: v[:n] for k, v in fetch(out).items()}  # every rank holds the whole render
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
                rgb_gt = self._store_rows("rgb", lo, hi).astype(np.float32) / 255.0
            # val PSNR on the transient-composited rgb where there is one
            typ = "fine" if self.cfg.loss.fine else "coarse"
            key = next((k for k in (f"rgb_{typ}", f"s_rgb_{typ}") if k in out), None)
            if key is not None:
                psnrs.append(float(psnr_fn(torch.from_numpy(out[key]), torch.from_numpy(rgb_gt))))
            if not self.debug and self.is_main:
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
        if self.meta.GT_poses_dict is None or not self.is_main:
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
