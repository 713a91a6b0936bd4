"""The reference's three units of work, from the benchmark's inputs: a train
step (the ray draw, the forward, the scheduled loss, the gradients and both
Adam updates), a TTO step (the pixel draw, the forward, the loss, Adam on
the pose and the appearance rows) and a frame. Rays go through in blocks,
the gradients summed over the blocks, so that a step fits beside the
scene; a block's loss is its share of the batch's.

Draws repeat the timed path's: one generator seeded alike, the same calls
in the same order, on the same device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import model as M


def _progress(step: int, max_steps: int) -> float:
    return float(np.float32(step) / np.float32(max_steps))


def schedule_mult(progress: float, window) -> float:
    """The candidate schedule's cosine ramp, in float32."""
    s, e = (np.float32(v) for v in window)
    x = np.clip((np.float32(progress) - s) / (e - s), np.float32(0.0), np.float32(1.0))
    return float((np.float32(1.0) - np.cos(np.float32(np.pi) * x)) / np.float32(2.0))


def _norms(t: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in t.items()}


def train_steps(weights: Dict[str, torch.Tensor], pose: Dict[str, torch.Tensor], scene, store, hp: Dict,
                dims: Dict, *, draw_seed: int, start: int, phase: int, n_steps: int, precision: str,
                block: int = 512) -> Dict:
    """n_steps train steps from step `start`. Returns the losses, each
    leaf's gradient norm at the first step and each leaf's change after the
    last: {"loss": [...], "grad": {name: norm}, "change": {name: norm}}."""
    dev = store.px.device
    g = torch.Generator(device=dev).manual_seed(draw_seed)
    P = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    Q = {k: v.detach().clone().requires_grad_(True) for k, v in pose.items()}
    opt = M.Adam(P, {k: hp["optimizer.lr"] for k in P})
    opt_pose = M.Adam(Q, {k: hp["optimizer_pose.lr"] for k in Q})
    B, max_steps = hp["train.batch_size"], hp["max_steps"]
    c2f = tuple(hp["pose.c2f"]) if hp.get("pose.c2f") else None
    near, far = hp["nerf.near"], hp["nerf.far"]
    out = {"loss": []}
    for k in range(n_steps):
        t = start + k
        progress = _progress(t, max_steps)
        sched = schedule_mult(progress, hp["candidate_schedule"])
        idx = torch.randint(0, store.px.shape[0], (B,), generator=g, device=dev)
        u_c = torch.rand((B, dims["N_samples"]), generator=g, device=dev) * hp["nerf.perturb"]
        u_f = torch.rand((B, dims["N_importance"]), generator=g, device=dev)
        total = 0.0
        for r0 in range(0, B, block):
            b = idx[r0 : r0 + block]
            img = store.img_idx[b]
            px, py = store.px[b].float(), store.py[b].float()
            base = scene.poses[img]
            pose_r = M.compose(M.se3_exp(Q["se3_refine.weight"][img]), base)
            rays_ = M.rays(px, py, scene.Ks[img], pose_r, scene.near_far[img])
            wh = scene.wh[img].float()
            feats = M.bilinear(scene.feat_maps, img, py / torch.clamp(wh[:, 1] - 1.0, min=1.0),
                               px / torch.clamp(wh[:, 0] - 1.0, min=1.0))
            emb = {n: P[f"embedding_{n}.weight"][img] for n in ("coarse_a", "fine_a", "coarse_c", "fine_c")}
            res = M.render(P, dims, rays_, emb, phase=phase, sched=sched, progress=progress, c2f=c2f,
                           precision=precision, u_coarse=u_c[r0 : r0 + block], u_fine=u_f[r0 : r0 + block])
            tr = None
            if phase > 0:
                tr = M.transient(P, feats, P["transient_net.embedding_t.weight"][img], hp["t_net.beta_min"],
                                 precision)
            depth_t = M.depth_prior(Q["depth_scale.weight"], img, store.inv_depth[b].float(), near, far)
            terms = M.train_loss_sum(res, store.rgb[b].float() / 255.0, feats, depth_t, tr, phase=phase,
                                     sched=sched, depth_mult=hp["loss.depth_mult"], alpha_reg=hp["loss.alpha_reg"])
            loss = sum(terms.values()) / B
            loss.backward()
            total += float(loss.detach())
        out["loss"].append(total)
        grads = {k_: v.grad if v.grad is not None else torch.zeros_like(v) for k_, v in P.items()}
        pgrads = {k_: v.grad if v.grad is not None else torch.zeros_like(v) for k_, v in Q.items()}
        if k == 0:
            out["grad"] = _norms({**grads, **pgrads})
        with torch.no_grad():
            lr = M.exp_lr(hp["optimizer.lr"], hp["optimizer.scheduler.lr_end"], max_steps, t)
            lr_pose = M.exp_lr(hp["optimizer_pose.lr"], hp["optimizer_pose.scheduler.lr_end"], max_steps, t)
            opt.step(grads, {n: lr / hp["optimizer.lr"] for n in P})
            opt_pose.step(pgrads, {n: lr_pose / hp["optimizer_pose.lr"] for n in Q})
        for v in list(P.values()) + list(Q.values()):
            v.grad = None
    out["change"] = _norms({**{k: P[k].detach() - weights[k] for k in P}, **{k: Q[k].detach() - pose[k] for k in Q}})
    return out


def tto_steps(weights: Dict[str, torch.Tensor], group: Dict[str, torch.Tensor], trainables: Dict[str, torch.Tensor],
              dims: Dict, lrs: Dict[str, float], *, draw_seed: int, rays_per_image: int, n_steps: int,
              precision: str, perturb: float = 1.0, block: int = 1024) -> Dict:
    """n_steps TTO pose-phase steps of one group (Ks, base_poses, rgbs, wh,
    near_far; G views) from the trainables fine_a (G, A) and se3 (G, 6),
    the model frozen. Returns losses, the leaves' gradient norms at the
    first step and their changes after the last."""
    dev = group["Ks"].device
    g = torch.Generator(device=dev).manual_seed(draw_seed)
    T = {k: v.detach().clone().requires_grad_(True) for k, v in trainables.items()}
    opt = M.Adam(T, lrs)
    G, Bi = group["Ks"].shape[0], rays_per_image
    w, h = group["wh"][:, 0:1].float(), group["wh"][:, 1:2].float()
    out = {"loss": []}
    coarse_a = weights["embedding_coarse_a.weight"][:1]
    for k in range(n_steps):
        ux = torch.rand((G, Bi), generator=g, device=dev)
        uy = torch.rand((G, Bi), generator=g, device=dev)
        px = torch.minimum(torch.clamp(torch.floor(ux * w), min=0), w - 1).reshape(-1)
        py = torch.minimum(torch.clamp(torch.floor(uy * h), min=0), h - 1).reshape(-1)
        u_c = torch.rand((G, Bi, dims["N_samples"]), generator=g, device=dev).reshape(G * Bi, -1) * perturb
        u_f = torch.rand((G, Bi, dims["N_importance"]), generator=g, device=dev).reshape(G * Bi, -1)
        img = torch.arange(G, device=dev).repeat_interleave(Bi)
        n = G * Bi
        total = 0.0
        for r0 in range(0, n, block):
            sl = slice(r0, r0 + block)
            im = img[sl]
            pose_r = M.compose(M.se3_exp(T["se3"]), group["base_poses"])[im]
            rays_ = M.rays(px[sl], py[sl], group["Ks"][im], pose_r, group["near_far"][im])
            emb = {"fine_a": T["fine_a"][im], "coarse_a": coarse_a.expand(im.shape[0], -1)}
            res = M.render(weights, dims, rays_, emb, phase=2, sched=1.0, progress=1.0, c2f=None,
                           precision=precision, u_coarse=u_c[sl], u_fine=u_f[sl], use_cand=False)
            gt = group["rgbs"][im, py[sl].long(), px[sl].long()].float() / 255.0
            loss = ((res["fine"]["rgb"] - gt) ** 2).mean(-1).sum() / n
            loss.backward()
            total += float(loss.detach())
        out["loss"].append(total)
        grads = {k_: v.grad for k_, v in T.items()}
        if k == 0:
            out["grad"] = _norms(grads)
            out["grad_rows"] = {k_: v.cpu().tolist() for k_, v in grads.items()}
        with torch.no_grad():
            opt.step(grads, {})
        for v in T.values():
            v.grad = None
    out["change"] = _norms({k: T[k].detach() - trainables[k] for k in T})
    return out


def frame(weights: Dict[str, torch.Tensor], dims: Dict, K: torch.Tensor, pose: torch.Tensor, wh, near_far,
          a_idx: int, *, precision: str, block: int = 8192) -> Dict[str, np.ndarray]:
    """A deterministic frame (phase 2, full PE): rgb (H, W, 3), depth (H, W)."""
    w, h = int(wh[0]), int(wh[1])
    dev = K.device
    jj, ii = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    px, py = ii.reshape(-1).float(), jj.reshape(-1).float()
    rgb: List[torch.Tensor] = []
    depth: List[torch.Tensor] = []
    with torch.no_grad():
        for r0 in range(0, px.shape[0], block):
            n = px[r0 : r0 + block].shape[0]
            rays_ = M.rays(px[r0 : r0 + block], py[r0 : r0 + block], K.expand(n, 3, 3), pose.expand(n, 3, 4),
                           near_far.expand(n, 2))
            emb = {k: weights[f"embedding_{k}.weight"][a_idx].expand(n, -1) for k in ("coarse_a", "fine_a")}
            res = M.render(weights, dims, rays_, emb, phase=2, sched=1.0, progress=1.0, c2f=None,
                           precision=precision, use_cand=False)
            rgb.append(res["fine"]["rgb"])
            depth.append(res["fine"]["s_depth"])
    return {"rgb": torch.cat(rgb).reshape(h, w, 3).cpu().numpy(), "depth": torch.cat(depth).reshape(h, w).cpu().numpy()}
