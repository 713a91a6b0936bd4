"""Test-time optimization (TTO) of held-out test images (upnerf/evaluate/tto.py).

For each test image, with the trained model frozen and the candidate branch
off:
  phase A (pose): optimize a fresh fine appearance embedding (Adam 5e-3) and
    the test camera's se(3) (Adam 1e-4) on the whole image for 50 epochs,
    from the GT pose sim(3)-aligned into the learned frame; keep the
    best-PSNR pose.
  phase B (appearance): from that pose, optimize only the embedding (AdamW
    1e-1, weight decay 1e-4 as optax's adamw) on the left half for 20 epochs;
    report the best PSNR / SSIM / LPIPS on the right half.

Test images go in groups: per-image parameters are rows of (G, 48) / (G, 6)
tensors, each step renders G x B rays with per-image pixel sampling, and
Adam's elementwise updates make the group exactly G independent runs. Every
render is the fused render kernel's forward; every step's backward is its
frozen-model backward (RenderConfig.param_grads = False: no weight
gradients). Randomness comes from explicit torch.Generators; the step takes
pre-drawn pixels and uniforms, as the tests hand both packages the same
ones. With a data mesh (`upnerf_torch.parallel`) each rank renders its share
of every image's B rays (pixels and uniforms drawn at the global (G, B)
shape, then sliced on B) and one all-reduce-mean combines the loss and the
gradients; the eval render splits each chunk's rays across the ranks.

A step is the span `tto.step`, tiled by `tto.batch`, `tto.forward`,
`tto.backward` and `tto.opt` (`utils/profiling.py`; off by default).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from upnerf_torch.geometry import procrustes, se3
from upnerf_torch.geometry import rays as ray_utils
from upnerf_torch.models.nerf import NeRFConfig
from upnerf_torch.parallel import DataMesh, all_gather_rows, all_reduce_grads, shard_batch
from upnerf_torch.render.render_rays import RenderConfig, render_rays
from upnerf_torch.train.state import gaussian_1d
from upnerf_torch.utils.profiling import span

from .metrics import psnr as psnr_fn
from .metrics import ssim as ssim_fn

EVAL_CHUNK = 4096  # rays per image in one eval render call


def align_test_poses(
    se3_table: np.ndarray,  # (N_train, 6) trained refinement
    gt_train_poses: np.ndarray,  # (N_train, 3, 4)
    gt_test_poses: np.ndarray,  # (N_test, 3, 4)
    base_train_poses: Optional[np.ndarray] = None,  # (N_train, 3, 4); None = identity
    rot_from: str = "orientations",
) -> np.ndarray:
    """Initial test poses: the GT test cameras mapped into the learned frame by
    the train set's sim(3). The learned train pose is base o exp(se3). The
    gauge rotation comes from the cameras' orientations ("orientations", the
    JAX package's default) or from their centres alone ("centers", the
    reference's estimator); scale and translation always from the centres."""
    def f32(a):
        return torch.from_numpy(np.array(a, np.float32))

    n = len(se3_table)
    base = torch.eye(3, 4).expand(n, 3, 4) if base_train_poses is None else f32(base_train_poses)
    refine_parsed = procrustes.parse_raw_camera(se3.compose([se3.se3_to_SE3(f32(se3_table)), base]))
    gt_train_parsed = procrustes.parse_raw_camera(f32(gt_train_poses))
    _, sim3 = procrustes.prealign_cameras(refine_parsed, gt_train_parsed)
    if rot_from == "orientations":
        sim3 = sim3._replace(R=procrustes.gauge_rotation_from_orientations(refine_parsed, gt_train_parsed))
    elif rot_from != "centers":
        raise ValueError(f"rot_from must be orientations|centers: {rot_from}")
    gt_test_parsed = procrustes.parse_raw_camera(f32(gt_test_poses))
    center_GT = se3.cam2world(torch.zeros((1, 1, 3)), gt_test_parsed)[:, 0]
    # the inverse of the prealign mapping: GT frame -> learned frame
    center_aligned = (center_GT - sim3.t0) / sim3.s0 @ sim3.R * sim3.s1 + sim3.t1
    R_aligned = gt_test_parsed[..., :3] @ sim3.R
    t_aligned = (-R_aligned @ center_aligned[..., None])[..., 0]
    return procrustes.parse_raw_camera(se3.make_pose(R=R_aligned, t=t_aligned)).numpy()


class TTOGroup(NamedTuple):
    """A group of G test images on the render device, padded to the group's
    largest H x W."""

    Ks: torch.Tensor  # (G, 3, 3)
    base_poses: torch.Tensor  # (G, 3, 4) aligned GT init
    rgbs: torch.Tensor  # (G, Hm, Wm, 3) uint8, zero-padded
    wh: torch.Tensor  # (G, 2) true (W, H), int
    near_far: torch.Tensor  # (G, 2)


class TTOConfig(NamedTuple):
    nerf: NeRFConfig
    render: RenderConfig
    batch_size: int = 1024
    pose_epochs: int = 50
    appearance_epochs: int = 20
    lr_emb_pose_phase: float = 5e-3
    lr_se3: float = 1e-4
    lr_emb_appearance: float = 1e-1
    # Fraction of phase-A epochs that ramp the PE-anneal progress from
    # pose_anneal_start to 1 (coarse-to-fine for the test pose); 0 = full PE.
    pose_anneal: float = 0.0
    pose_anneal_start: float = 0.3
    # Phase A's first pose_blur_frac of the epochs fits Gaussian-blurred
    # copies of the target, one equal segment per sigma; () = sharp throughout.
    pose_blur: Tuple[float, ...] = ()
    pose_blur_frac: float = 0.5


def _eval_stride(eval_every) -> int:
    """0: the last epoch only; negatives clamp to every epoch."""
    return max(1, int(eval_every)) if eval_every else (1 << 30)


def _blur_group_rgbs(rgbs_u8: np.ndarray, wh: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian-blur each image's valid (h, w) region, edge-padded so the zero
    padding never bleeds in (host numpy, once per pyramid level and group)."""
    out = np.array(rgbs_u8)
    for g in range(len(out)):
        w, h = int(wh[g, 0]), int(wh[g, 1])
        img = out[g, :h, :w].astype(np.float64)
        img = gaussian_1d(gaussian_1d(img, sigma, 0), sigma, 1)
        out[g, :h, :w] = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return out


def _sample_pixels(generator: torch.Generator, wh: torch.Tensor, x_frac: Tuple[float, float], B: int):
    """Uniform pixel coordinates per image inside the width fraction x_frac:
    px, py each (G, B) float32. Both cut points are floored, so the left-half
    train region [0, w // 2) and the right-half eval region [w // 2, w) never
    overlap at odd widths."""
    G = wh.shape[0]
    w = wh[:, 0:1].float()
    h = wh[:, 1:2].float()
    ux = torch.rand((G, B), generator=generator, device=wh.device)
    uy = torch.rand((G, B), generator=generator, device=wh.device)
    x_lo = torch.floor(w * x_frac[0])
    x_hi = torch.floor(w * x_frac[1]) if x_frac[1] < 1.0 else w
    px = torch.minimum(torch.clamp(torch.floor(x_lo + ux * (x_hi - x_lo)), min=0), w - 1)
    py = torch.minimum(torch.clamp(torch.floor(uy * h), min=0), h - 1)
    return px, py


def _draw_render_noise(generator: torch.Generator, rcfg: RenderConfig, G: int, B: int,
                       device) -> Dict[str, torch.Tensor]:
    """The render's uniforms for G x B rays: {"coarse": (G, B, N_samples)} when
    perturbing, {"fine": (G, B, N_importance)} with importance samples."""
    noise = {}
    if rcfg.perturb > 0:
        noise["coarse"] = torch.rand((G, B, rcfg.N_samples), generator=generator, device=device)
    if rcfg.N_importance > 0:
        noise["fine"] = torch.rand((G, B, rcfg.N_importance), generator=generator, device=device)
    return noise


def _render_group_rays(
    frozen: Dict[str, Any],
    fine_a: torch.Tensor,  # (G, A)
    se3_delta: torch.Tensor,  # (G, 6)
    cfg: TTOConfig,
    group: TTOGroup,
    px: torch.Tensor,  # (G, B)
    py: torch.Tensor,  # (G, B)
    det: bool,
    noise: Optional[Dict[str, torch.Tensor]] = None,  # {coarse/fine: (G*B, N)}
    progress: float = 1.0,
):
    """Render G*B rays through the refined poses: (pred_rgb, gt_rgb), (G*B, 3).

    The fresh test table replaces fine_a; coarse_a's row 0 of the trained
    table stands in for the coarse pass, whose rgb the TTO loss does not read."""
    G, B = px.shape
    img_idx = torch.arange(G, device=px.device).repeat_interleave(B)
    dirs = ray_utils.pixel_directions(px.reshape(-1), py.reshape(-1), group.Ks[img_idx])
    poses = se3.compose([se3.se3_to_SE3(se3_delta), group.base_poses])[img_idx]
    rays_o, rays_d = ray_utils.get_rays(dirs, poses)
    rays = torch.cat([rays_o, rays_d, group.near_far[img_idx]], -1)
    emb = dict(frozen["embeddings"])
    emb["fine_a"] = fine_a
    emb["coarse_a"] = frozen["embeddings"]["coarse_a"][:1].expand(G, fine_a.shape[-1])
    params = {"nerf_coarse": frozen["nerf_coarse"], "nerf_fine": frozen["nerf_fine"], "embeddings": emb}
    out = render_rays(params, cfg.render, rays, img_idx, phase=2, progress=progress, encode_candidate=False,
                      det=det, noise=noise)
    gt = group.rgbs[img_idx, py.reshape(-1).long(), px.reshape(-1).long()].float() / 255.0
    return out["s_rgb_fine"], gt


def make_tto_step(frozen: Dict[str, Any], cfg: TTOConfig, *, optimize_pose: bool,
                  x_frac: Tuple[float, float], mesh: DataMesh = DataMesh()) -> Callable:
    """step(trainables, optimizer, group, generator, progress=1.0, px=None,
    py=None, noise=None) -> loss (a 0-d tensor, not synchronised).

    trainables = {"fine_a": (G, A)[, "se3": (G, 6)]} leaf tensors that require
    grad, updated in place by `optimizer`. The loss is the mean squared error
    over the G*B rays. px, py (G, B) and noise {coarse/fine: (G, B, N)} are
    drawn from `generator` unless given. Over a `mesh` they are the global
    batch: each rank renders its B / n columns, and the loss and the
    gradients of the optimizer's parameters are averaged over the ranks
    before it steps (the global batch's, up to the order of the sums)."""
    if cfg.batch_size % mesh.size:
        raise ValueError(f"the TTO batch {cfg.batch_size} does not split over {mesh.size} ranks")

    def step(trainables, optimizer, group: TTOGroup, generator=None, progress: float = 1.0, px=None, py=None,
             noise=None):
        with span("tto.step"):
            with span("tto.batch"):
                G = group.Ks.shape[0]
                if px is None:
                    px, py = _sample_pixels(generator, group.wh, x_frac, cfg.batch_size)
                if noise is None:
                    noise = _draw_render_noise(generator, cfg.render, G, px.shape[1], px.device)
                px, py = shard_batch(mesh, px, axis=1).contiguous(), shard_batch(mesh, py, axis=1).contiguous()
                noise = shard_batch(mesh, noise, axis=1)
                se3_delta = trainables["se3"] if optimize_pose else torch.zeros((G, 6), device=px.device)
                flat = {k: v.reshape(-1, v.shape[-1]) for k, v in noise.items()}
            with span("tto.forward"):
                pred, gt = _render_group_rays(frozen, trainables["fine_a"], se3_delta, cfg, group, px, py, det=False,
                                              noise=flat or None, progress=progress)
                loss = ((pred - gt) ** 2).mean()
            with span("tto.opt"):
                optimizer.zero_grad(set_to_none=True)
            with span("tto.backward"):
                loss.backward()
            with span("tto.opt"):
                (loss,) = all_reduce_grads([p for g in optimizer.param_groups for p in g["params"]], mesh,
                                           [loss.detach()])
                optimizer.step()
            return loss

    return step


def make_tto_eval(frozen: Dict[str, Any], cfg: TTOConfig, *, x_frac: Tuple[float, float],
                  chunk: int = EVAL_CHUNK, mesh: DataMesh = DataMesh()) -> Callable:
    """render_full(trainables, group, Hm, Wm) -> (pred, gt), each (G, Hm, Wm, 3):
    a deterministic render of each image's region on a padded grid, pixels
    clamped into each image's valid region (the metrics crop them out), in
    chunks of G x `chunk` rays. Over a `mesh` the grid is padded to whole
    chunks, each rank renders its chunk / n rays of every chunk and the parts
    are gathered back in order on every rank: rays are independent, so the
    result is bit for bit the unsharded render at chunk / n rays a call
    (against calls of chunk rays, products that block by a call's rows can
    move the last bits)."""
    if chunk % mesh.size:
        raise ValueError(f"the eval chunk {chunk} does not split over {mesh.size} ranks")

    @torch.no_grad()
    def render_full(trainables, group: TTOGroup, Hm: int, Wm: int):
        G = group.Ks.shape[0]
        dev = group.Ks.device
        jj, ii = torch.meshgrid(torch.arange(Hm, device=dev), torch.arange(Wm, device=dev), indexing="ij")
        w = group.wh[:, 0:1].float()
        h = group.wh[:, 1:2].float()
        px = torch.minimum(torch.clamp(ii.reshape(1, -1).float() + torch.floor(w * x_frac[0]), min=0), w - 1)
        py = torch.minimum(torch.clamp(jj.reshape(1, -1).float().expand(G, -1), min=0), h - 1)
        se3_delta = trainables.get("se3")
        if se3_delta is None:
            se3_delta = torch.zeros((G, 6), device=dev)
        n_px = Hm * Wm
        if mesh.size > 1:  # whole chunks: the last pixel repeated, cropped below
            pad = (-n_px) % chunk
            px, py = (torch.cat([v, v[:, -1:].expand(G, pad)], 1) for v in (px, py))
        outs = []
        for c0 in range(0, px.shape[1], chunk):
            px_c, py_c = (shard_batch(mesh, v[:, c0 : c0 + chunk], axis=1) for v in (px, py))
            pred, gt = _render_group_rays(frozen, trainables["fine_a"], se3_delta, cfg, group, px_c.contiguous(),
                                          py_c.contiguous(), det=True)
            outs.append(torch.cat([pred, gt], -1).reshape(G, -1, 6))
        out = torch.cat(outs, 1)  # (G, rays, pred | gt)
        out = all_gather_rows(out.transpose(0, 1), mesh, len(outs)).transpose(0, 1)[:, :n_px]
        return out[..., :3].reshape(G, Hm, Wm, 3), out[..., 3:].reshape(G, Hm, Wm, 3)

    return render_full


def tto_region_size(wh: np.ndarray, x_frac: Tuple[float, float], bucket: int = 64) -> Tuple[int, int]:
    """Largest (H, W_region) over a group for the padded eval grid, rounded up
    to multiples of `bucket`."""
    w, h = wh[:, 0], wh[:, 1]
    x_hi = np.floor(w * x_frac[1]) if x_frac[1] < 1.0 else w
    region_w = x_hi - np.floor(w * x_frac[0])

    def up(v):
        return int(-(-int(v) // bucket) * bucket)

    return up(h.max()), up(region_w.max())


def _region_bounds(wh, g, x_frac):
    w, h = int(wh[g, 0]), int(wh[g, 1])
    x_lo = int(np.floor(w * x_frac[0]))
    x_hi = int(np.floor(w * x_frac[1])) if x_frac[1] < 1.0 else w
    return x_lo, x_hi, h


def _crop(preds, gts, wh, g, x_frac):
    x_lo, x_hi, h = _region_bounds(wh, g, x_frac)
    ww = x_hi - x_lo
    return preds[g, :h, :ww], gts[g, :h, :ww], (h, ww)


def _masked_psnr(preds, gts, wh, x_frac) -> np.ndarray:
    """Per-image PSNR over each image's valid region."""
    out = np.zeros(preds.shape[0])
    for g in range(preds.shape[0]):
        p, t, _ = _crop(preds, gts, wh, g, x_frac)
        out[g] = float(psnr_fn(p, t))
    return out


class TTORunner:
    """Scene-level TTO: both phases' step and eval functions, built once."""

    def __init__(self, frozen: Dict[str, Any], cfg: TTOConfig, appearance_dim: int, region_A: Tuple[int, int],
                 region_B: Tuple[int, int], mesh: DataMesh = DataMesh()):
        self.frozen = frozen
        self.cfg = cfg
        self.appearance_dim = appearance_dim
        self.region_A = region_A
        self.region_B = region_B
        self.step_A = make_tto_step(frozen, cfg, optimize_pose=True, x_frac=(0.0, 1.0), mesh=mesh)
        self.step_B = make_tto_step(frozen, cfg, optimize_pose=False, x_frac=(0.0, 0.5), mesh=mesh)
        self.eval_A = make_tto_eval(frozen, cfg, x_frac=(0.0, 1.0), mesh=mesh)
        self.eval_B = make_tto_eval(frozen, cfg, x_frac=(0.5, 1.0), mesh=mesh)

    def opt_A(self, trainables) -> torch.optim.Optimizer:
        """optax.multi_transform of two Adams (eps 1e-8): the embedding at
        lr_emb_pose_phase, se3 at lr_se3."""
        return torch.optim.Adam([{"params": [trainables["fine_a"]], "lr": self.cfg.lr_emb_pose_phase},
                                 {"params": [trainables["se3"]], "lr": self.cfg.lr_se3}], eps=1e-8)

    def opt_B(self, trainables) -> torch.optim.Optimizer:
        """optax.adamw(lr_emb_appearance): weight decay 1e-4 (torch's AdamW
        defaults to 1e-2), eps 1e-8."""
        return torch.optim.AdamW([trainables["fine_a"]], lr=self.cfg.lr_emb_appearance, weight_decay=1e-4, eps=1e-8)

    def _fresh_embedding(self, G: int, generator: torch.Generator, device) -> torch.Tensor:
        return torch.randn((G, self.appearance_dim), generator=generator, device=device).requires_grad_(True)

    def run_group(self, group: TTOGroup, generator: torch.Generator, lpips=None, log=print,
                  eval_every: int = 1) -> Dict[str, np.ndarray]:
        """Both TTO phases for one group: per-image best metrics, refined
        poses and embeddings. eval_every: the best-metric eval render only
        every k-th epoch (always on the last)."""
        eval_every = _eval_stride(eval_every)
        cfg = self.cfg
        G = int(group.Ks.shape[0])
        dev = group.Ks.device
        wh = group.wh.cpu().numpy()
        epoch_steps_A = max(1, int(np.ceil((wh[:, 0] * wh[:, 1]).max() / cfg.batch_size)))
        epoch_steps_B = max(1, epoch_steps_A // 2)

        def refined(trainables):
            with torch.no_grad():
                return se3.compose([se3.se3_to_SE3(trainables["se3"]), group.base_poses]).cpu().numpy()

        # ---- phase A: pose + embedding on the whole image
        trainables = {"fine_a": self._fresh_embedding(G, generator, dev),
                      "se3": torch.zeros((G, 6), device=dev, requires_grad=True)}
        opt = self.opt_A(trainables)
        Hm, Wm = self.region_A
        best_psnr = np.full(G, -np.inf)
        best_pose = refined(trainables)
        blur_groups = []
        if cfg.pose_blur:
            rgbs_np = group.rgbs.cpu().numpy()
            blur_groups = [group._replace(rgbs=torch.from_numpy(_blur_group_rgbs(rgbs_np, wh, s)).to(dev))
                           for s in cfg.pose_blur]
        blur_epochs = cfg.pose_blur_frac * cfg.pose_epochs
        ramp_epochs = cfg.pose_anneal * cfg.pose_epochs
        for epoch in range(cfg.pose_epochs):
            progress = 1.0 if epoch >= ramp_epochs else (
                cfg.pose_anneal_start + (1.0 - cfg.pose_anneal_start) * epoch / ramp_epochs)
            group_e = group
            if blur_groups and epoch < blur_epochs:
                group_e = blur_groups[int(epoch / blur_epochs * len(blur_groups))]
            for _ in range(epoch_steps_A):
                loss = self.step_A(trainables, opt, group_e, generator, progress)
            if (epoch + 1) % eval_every and epoch + 1 < cfg.pose_epochs:
                continue
            preds, gts = self.eval_A(trainables, group, Hm, Wm)
            cur = _masked_psnr(preds, gts, wh, (0.0, 1.0))
            improved = cur > best_psnr
            if improved.any():
                best_pose[improved] = refined(trainables)[improved]
                best_psnr = np.maximum(best_psnr, cur)
            log(f"[tto A] epoch {epoch + 1}/{cfg.pose_epochs} loss={float(loss):.4f} psnr={cur.mean():.2f}")

        # ---- phase B: appearance only, left half, eval on the right half
        group_B = group._replace(base_poses=torch.from_numpy(best_pose).to(dev))
        trainables = {"fine_a": self._fresh_embedding(G, generator, dev)}
        opt = self.opt_B(trainables)
        Hm, Wm = self.region_B
        best = {"psnr": np.full(G, -np.inf), "ssim": np.zeros(G), "lpips": np.full(G, np.nan)}
        best_emb = np.zeros((G, self.appearance_dim), np.float32)
        for epoch in range(cfg.appearance_epochs):
            for _ in range(epoch_steps_B):
                loss = self.step_B(trainables, opt, group_B, generator)
            if (epoch + 1) % eval_every and epoch + 1 < cfg.appearance_epochs:
                continue
            preds, gts = self.eval_B(trainables, group_B, Hm, Wm)
            cur = _masked_psnr(preds, gts, wh, (0.5, 1.0))
            emb_now = trainables["fine_a"].detach().cpu().numpy()
            for g in range(G):
                if cur[g] > best["psnr"][g]:
                    best["psnr"][g] = cur[g]
                    best_emb[g] = emb_now[g]
                    pg, gg, _ = _crop(preds, gts, wh, g, (0.5, 1.0))
                    best["ssim"][g] = float(ssim_fn(pg, gg))
                    if lpips is not None:
                        best["lpips"][g] = lpips(pg, gg)
            log(f"[tto B] epoch {epoch + 1}/{cfg.appearance_epochs} loss={float(loss):.4f} psnr={cur.mean():.2f}")

        return {"psnr": best["psnr"], "ssim": best["ssim"], "lpips": best["lpips"], "pose": best_pose,
                "pose_psnr": best_psnr, "emb": best_emb}


def run_tto_group(frozen: Dict[str, Any], cfg: TTOConfig, group: TTOGroup, appearance_dim: int,
                  generator: torch.Generator, lpips=None, log=print) -> Dict[str, np.ndarray]:
    """One group with eval regions sized from the group alone."""
    wh = group.wh.cpu().numpy()
    runner = TTORunner(frozen, cfg, appearance_dim, region_A=tto_region_size(wh, (0.0, 1.0)),
                       region_B=tto_region_size(wh, (0.5, 1.0)))
    return runner.run_group(group, generator, lpips=lpips, log=log)
