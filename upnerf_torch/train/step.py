"""The UP-NeRF train step and val renderer (upnerf/train/step.py).

One step: draw a ray batch from the device-resident store, build rays
through the refined per-image poses, gather DINO features bilinearly, apply
the depth prior, render coarse and fine (each pass through the fused render
kernels, forward and backward), composite the transient layer, form the
scheduled loss and update both Adam optimizers. The phase is an argument;
`sched_mult` and `progress` are host floats derived from `state.step`.

The step updates the state's modules and optimizers in place and returns a
TrainState with the step advanced. Metrics stay on the device; reading one
waits for the step.

A step is the span `train.step`, tiled by `train.batch` (indices, uniforms,
gather), `train.forward` (rays, features, render, loss, metrics),
`train.backward` (as the caller waits for it) and `train.opt` (both
zero_grads, the mesh's reduce, both optimizer steps, psnr); see
`utils/profiling.py`, whose spans are off unless a caller turns them on.

With a data mesh (`upnerf_torch.parallel`) each rank renders its rows of the
global batch and one all-reduce-mean combines the gradients and the raw
metrics before the optimizers step, as the JAX package's shard_map branch
does with pmean; the val renderer splits each chunk's rays across ranks.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from upnerf_torch.geometry import rays as ray_utils
from upnerf_torch.geometry import se3
from upnerf_torch.models.nerf import NeRFConfig
from upnerf_torch.models.transient import TransientConfig
from upnerf_torch.ops.interp import bilinear_gather
from upnerf_torch.parallel import DataMesh, all_gather_rows, all_reduce_grads, shard_batch
from upnerf_torch.render.render_rays import RenderConfig, render_rays
from upnerf_torch.utils.profiling import span

from .losses import LossConfig, compute_loss
from .schedules import pe_progress, schedule_mult
from .state import PoseTables, RayStore, SceneConstants, TrainState, UPNeRF


class StepConfig(NamedTuple):
    """Static configuration bundle for the train step."""

    nerf: NeRFConfig
    transient: Optional[TransientConfig]
    render: RenderConfig
    loss: LossConfig
    candidate_schedule: Tuple[float, float]
    max_steps: int
    pose_optimize: bool
    near: float  # global clamp bounds for the depth prior
    far: float
    batch_size: int
    feat_c2f: Optional[Tuple[float, float]] = None  # feature coarse-to-fine window, off by default

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any]) -> "StepConfig":
        return cls(
            nerf=NeRFConfig.from_hparams(hp),
            transient=TransientConfig.from_hparams(hp),
            render=RenderConfig.from_hparams(hp),
            loss=LossConfig.from_hparams(hp),
            candidate_schedule=tuple(hp["candidate_schedule"]),
            max_steps=hp["max_steps"],
            pose_optimize=hp["pose.optimize"],
            near=hp["nerf.near"],
            far=hp["nerf.far"],
            batch_size=hp["train.batch_size"],
            feat_c2f=tuple(hp["feat.c2f"]) if hp.get("feat.c2f") else None,
        )


def gather_batch(store: RayStore, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A compact ray batch by flat index, on the store's device."""
    return {
        "px": store.px[idx].float(),
        "py": store.py[idx].float(),
        "img_idx": store.img_idx[idx],
        "rgb": store.rgb[idx].float() / 255.0,
        "inv_depth": store.inv_depth[idx].float(),
    }


def build_rays(pose_params: PoseTables, scene: SceneConstants, batch: Dict[str, torch.Tensor],
               pose_optimize: bool) -> torch.Tensor:
    """Pixel coordinates -> world rays (B, 8) through the refined per-image
    pose. The se3 table starts at zero, where the exp map's gradient is
    finite (its Taylor series has no division)."""
    img_idx = batch["img_idx"]
    dirs = ray_utils.pixel_directions(batch["px"], batch["py"], scene.Ks[img_idx])
    pose = scene.poses[img_idx]
    if pose_optimize:
        pose = se3.compose([se3.se3_to_SE3(pose_params.se3_refine.weight[img_idx]), pose])
    rays_o, rays_d = ray_utils.get_rays(dirs, pose)
    return torch.cat([rays_o, rays_d, scene.near_far[img_idx]], dim=-1)


def depth_prior(pose_params: PoseTables, batch: Dict[str, torch.Tensor], near: float, far: float) -> torch.Tensor:
    """Per-image scale/shift on the DPT inverse depth, clamped; the clamps
    have zero gradient on the clamped side."""
    scale_shift = pose_params.depth_scale.weight[batch["img_idx"]]
    pred_inv = batch["inv_depth"] * torch.exp(scale_shift[:, 0]) + scale_shift[:, 1]
    pred_inv = torch.clamp(pred_inv, min=1.0 / far)
    return torch.clamp(1.0 / pred_inv, min=near)


def gather_feats(scene: SceneConstants, batch: Dict[str, torch.Tensor], feat_c2f=None,
                 progress: Optional[float] = None) -> Optional[torch.Tensor]:
    """Bilinear DINO features for the batch pixels; with `feat_c2f` and a
    coarse pyramid level, blended low-pass -> full resolution over the
    progress window."""
    if scene.feat_maps is None:
        return None
    img_idx = batch["img_idx"]
    wh = scene.wh[img_idx].float()
    u = batch["py"] / torch.clamp(wh[:, 1] - 1.0, min=1.0)
    v = batch["px"] / torch.clamp(wh[:, 0] - 1.0, min=1.0)
    fine = bilinear_gather(scene.feat_maps, img_idx, u, v)
    if feat_c2f is None or scene.feat_maps_coarse is None or progress is None:
        return fine
    s, e = feat_c2f
    w = min(max((progress - s) / max(e - s, 1e-8), 0.0), 1.0)
    coarse = bilinear_gather(scene.feat_maps_coarse, img_idx, u, v)
    return (1.0 - w) * coarse + w * fine


def forward(params: UPNeRF, pose_params: PoseTables, cfg: StepConfig, scene: SceneConstants,
            batch: Dict[str, torch.Tensor], *, phase: int, sched_mult: float, progress: float,
            noise: Optional[Dict[str, torch.Tensor]], det: bool = False):
    """Render + transient composite with the pre-drawn uniforms `noise`
    (det=True, noise None: the deterministic eval render). Returns (results,
    rays, feats)."""
    rays = build_rays(pose_params, scene, batch, cfg.pose_optimize)
    feats = gather_feats(scene, batch, cfg.feat_c2f, progress)
    results = render_rays(
        params.render_params(), cfg.render, rays, batch["img_idx"], phase=phase, sched_mult=sched_mult,
        progress=progress, det=det, noise=noise,
    )
    if phase > 0 and cfg.transient is not None and feats is not None:
        t = params.transient_net(feats, batch["img_idx"], precision=cfg.render.precision)
        t_alpha, t_rgb, t_beta = t["alpha"], t["rgb"], t["beta"]
        # the coarse composite detaches the transient entirely; the fine one does not
        a = t_alpha.detach()
        results["rgb_coarse"] = results["s_rgb_coarse"] * (1.0 - a)[:, None] + t_rgb.detach() * a[:, None]
        if "s_rgb_fine" in results:
            results["rgb_fine"] = results["s_rgb_fine"] * (1.0 - t_alpha)[:, None] + t_rgb * t_alpha[:, None]
        results["t_beta"] = t_beta
        results["t_alpha"] = t_alpha
        results["t_rgb"] = t_rgb
    elif phase > 0:
        results["rgb_coarse"] = results["s_rgb_coarse"]
    return results, rays, feats


def _loss_and_metrics(params: UPNeRF, pose_params: PoseTables, cfg: StepConfig, scene: SceneConstants,
                      batch: Dict[str, torch.Tensor], noise: Dict[str, torch.Tensor], phase: int, sched_mult: float,
                      progress: float):
    """Loss + raw metrics of one batch: the loss terms, mse, and the
    per-image loss sums and counts (the warp-detection signal)."""
    results, _, feats = forward(params, pose_params, cfg, scene, batch, phase=phase, sched_mult=sched_mult,
                                progress=progress, noise=noise)
    pred_depths = depth_prior(pose_params, batch, cfg.near, cfg.far)
    loss_d = compute_loss(cfg.loss, results, batch["rgb"], feats, pred_depths, sched_mult, phase)
    if cfg.loss.depth_scale_reg > 0:
        log_scale = pose_params.depth_scale.weight[:, 0]
        loss_d["l_dscale_reg"] = cfg.loss.depth_scale_reg * torch.var(log_scale, unbiased=False)
    loss = sum(loss_d.values())
    metrics = {f"loss/{k}": v for k, v in loss_d.items()}
    metrics["loss"] = loss
    typ = "fine" if cfg.loss.fine else "coarse"
    if phase > 0:
        metrics["mse"] = ((results[f"s_rgb_{typ}"] - batch["rgb"]) ** 2).mean()
    else:
        metrics["mse"] = torch.ones((), device=loss.device)
    if phase < 2 and cfg.loss.encode_feat:
        per_ray = ((results[f"feat_{typ}"] - feats) ** 2).mean(-1)
    elif phase == 0:  # the feature-less field composites no s_rgb in phase 0: its candidate rgb (ROADMAP.md §3)
        per_ray = ((results[f"c_rgb_{typ}"] - batch["rgb"]) ** 2).mean(-1)
    else:
        per_ray = ((results[f"s_rgb_{typ}"] - batch["rgb"]) ** 2).mean(-1)
    per_ray = per_ray.detach()
    n_img = scene.poses.shape[0]
    seg = batch["img_idx"]
    metrics["img_loss_sum"] = torch.zeros(n_img, device=per_ray.device).index_add_(0, seg, per_ray)
    metrics["img_loss_cnt"] = torch.zeros(n_img, device=per_ray.device).index_add_(0, seg, torch.ones_like(per_ray))
    return loss, metrics


def make_train_step(cfg: StepConfig, optimizer, pose_optimizer, mesh: DataMesh = DataMesh()):
    """(step, batch_step) of the train loop.

    step(state, scene, store, phase) draws the ray batch uniformly from the
    device-resident store (iid with replacement) and the render uniforms,
    both from state.generator. batch_step(state, scene, batch, phase,
    noise=None, local=False) takes the batch; `noise=None` draws the
    uniforms, a dict supplies them (an empty dict selects the deterministic
    sampling paths). Both return (state, metrics). `optimizer`/`pose_optimizer`
    are the specs the state's optimizer states were built from; with no pose
    optimizer, or pose_optimize off, the pose tables do not move.

    Over a `mesh` of several ranks (the state replicated on each) every rank
    draws the indices and uniforms at the global batch
    shape from its copy of the generator and keeps its rows (`shard_batch`),
    so the generators advance alike and each rank's rows are bit for bit the
    one-rank draw's. After the backward one all-reduce-mean covers every
    gradient of the optimizers' parameters (zero where the phase leaves one
    unused) and every raw metric; psnr is derived after it. Every metric is a
    mean over the batch, so the reduced values are the global batch's, but
    img_loss_sum / img_loss_cnt come out divided by the mesh's size, as
    JAX's pmean leaves them (their ratio is exact). batch_step slices a
    global batch the same way; `local=True` says the batch holds this rank's
    rows already (the host prefetcher's), and the uniforms are still drawn at
    the global shape."""
    if cfg.batch_size % mesh.size:
        raise ValueError(f"train.batch_size {cfg.batch_size} does not split over {mesh.size} ranks")

    def draw_noise(generator: torch.Generator, n_rays: int, device) -> Dict[str, torch.Tensor]:
        noise = {}
        if cfg.render.perturb > 0:
            noise["coarse"] = torch.rand((n_rays, cfg.render.N_samples), generator=generator, device=device)
        if cfg.render.N_importance > 0:
            noise["fine"] = torch.rand((n_rays, cfg.render.N_importance), generator=generator, device=device)
        return noise

    def reduce(state: TrainState, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The mesh's mean of the gradients (in place) and of the metrics."""
        opts = [state.opt_state] + ([state.pose_opt_state] if cfg.pose_optimize and pose_optimizer is not None
                                    else [])
        params = [p for opt in opts for g in opt.optimizer.param_groups for p in g["params"]]
        names = sorted(metrics)
        return dict(zip(names, all_reduce_grads(params, mesh, [metrics[k] for k in names])))

    def update(state: TrainState, scene, batch, noise, phase: int):
        progress = pe_progress(state.step, cfg.max_steps)
        sched = schedule_mult(progress, cfg.candidate_schedule)
        with span("train.opt"):
            state.opt_state.zero_grad()
            if state.pose_opt_state is not None:
                state.pose_opt_state.zero_grad()
        with span("train.forward"):
            loss, metrics = _loss_and_metrics(state.params, state.pose_params, cfg, scene, batch, noise, phase,
                                              sched, progress)
        with span("train.backward"):
            loss.backward()
        with span("train.opt"):
            metrics = reduce(state, {k: v.detach() for k, v in metrics.items()})
            state.opt_state.step()
            if cfg.pose_optimize and pose_optimizer is not None:
                state.pose_opt_state.step()
            metrics["psnr"] = -10.0 * torch.log10(metrics.pop("mse"))
        return state._replace(step=state.step + 1), metrics

    def step_fn(state: TrainState, scene: SceneConstants, store: RayStore, phase: int):
        with span("train.step"):
            with span("train.batch"):
                dev = store.px.device
                idx = torch.randint(0, store.n_rays, (cfg.batch_size,), generator=state.generator, device=dev)
                noise = draw_noise(state.generator, cfg.batch_size, dev)
                idx, noise = shard_batch(mesh, idx), shard_batch(mesh, noise)  # each rank gathers only its rows
                batch = gather_batch(store, idx)
            return update(state, scene, batch, noise, phase)

    def batch_step_fn(state: TrainState, scene: SceneConstants, batch: Dict[str, torch.Tensor], phase: int,
                      noise: Optional[Dict[str, torch.Tensor]] = None, local: bool = False):
        with span("train.step"):
            with span("train.batch"):
                local_noise = local
                if noise is None:  # drawn at the global batch shape
                    n_rays = batch["px"].shape[0] * (mesh.size if local else 1)
                    noise, local_noise = draw_noise(state.generator, n_rays, batch["px"].device), False
                noise = noise if local_noise else shard_batch(mesh, noise)
                batch = batch if local else shard_batch(mesh, batch)
            return update(state, scene, batch, noise, phase)

    return step_fn, batch_step_fn


def make_eval_render(cfg: StepConfig, chunk_size: int = 4096, mesh: DataMesh = DataMesh()):
    """Full-image renderer (upnerf/train/step.py:make_eval_render):
    deterministic renders of fixed-size chunks, each with the scaled DPT
    prior `pred_depth` and, where the scene has features, the gathered DINO
    targets `feats_gt`.

    render(params, pose_params, scene, batch, progress, phase) -> results,
    batch holding px, py, img_idx, inv_depth padded to a multiple of
    chunk_size; every result is concatenated over the chunks (the caller
    crops the padding). Over a `mesh` of several ranks each rank renders its part of every
    chunk (chunk_size / n rays) and the parts are gathered back into chunk
    order on every rank. Rays are independent and the render deterministic,
    so the result is bit for bit the unsharded render at chunk_size / n rays
    a call (against calls of chunk_size rays, products that block by a call's
    rows can move the last bits)."""
    if chunk_size % mesh.size:
        raise ValueError(f"val.chunk_size {chunk_size} does not split over {mesh.size} ranks")

    @torch.no_grad()
    def render_fn(params: UPNeRF, pose_params: PoseTables, scene: SceneConstants, batch: Dict[str, torch.Tensor],
                  progress: float, phase: int) -> Dict[str, torch.Tensor]:
        sched = schedule_mult(progress, cfg.candidate_schedule)
        n = batch["px"].shape[0]
        if n % chunk_size:
            raise ValueError(f"{n} pixels is not a multiple of the chunk size {chunk_size}: pad first")
        outs = []
        for c0 in range(0, n, chunk_size):
            b = shard_batch(mesh, {k: v[c0 : c0 + chunk_size] for k, v in batch.items()})
            results, _, feats = forward(params, pose_params, cfg, scene, b, phase=phase, sched_mult=sched,
                                        progress=progress, noise=None, det=True)
            if feats is not None:
                results["feats_gt"] = feats
            results["pred_depth"] = depth_prior(pose_params, b, cfg.near, cfg.far)
            outs.append(results)
        return {k: all_gather_rows(torch.cat([o[k] for o in outs]), mesh, len(outs)) for k in outs[0]}

    return render_fn
