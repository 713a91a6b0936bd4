"""Plain UP-NeRF in float32, TF32 off: the reference that decides `correct`.

Written from the method's equations, in plain PyTorch, with no kernel,
cache or batching; it imports nothing of the program. Parameters come as
one dict keyed by the upstream checkpoint's names (`param_spec`), linear
weights in (out, in) layout.

What it computes, as the timed paths must:
- rays through the refined poses: pixel directions (x right, y up, the
  camera looks down -z, no half-pixel offset), the se(3) exponential map by
  its 10-term Taylor series, base pose o exp(se3), unit directions;
- the bilinear DINO feature gather at u = row / (H - 1), v = col / (W - 1),
  the base texel clamped to size - 2;
- the depth prior: DPT inverse depth x exp(scale) + shift, clamped to
  [1 / far, ...], inverted, clamped to [near, ...];
- each pass: xyz = o + d z with z detached, the BARF-annealed PE (the raw
  coordinates, then per coordinate the sines and the cosines of 2^l pi x),
  the trunk (skip layers read [x0, h]), sigma from the trunk's last layer,
  xyz_final, the feature head, the rgb head on [feat, PE(dir), appearance]
  with dir detached, the candidate branch on [xyz_final, candidate
  embedding]; compositing with the last interval 1e2, the joint weights of
  the candidate branch;
- stratified coarse depths, the fine depths by inverse-CDF sampling of the
  coarse weights (the mixture (1 - m) c + m s in phase 1), merged and sorted;
- the transient net on the gathered features; the scheduled loss; Adam.

`precision="fp8"` is the control: every matrix product in float8 as a
hybrid fp8 recipe runs it, the forward's operands in e4m3 and the
backward's cotangents in e5m2, one scale a tensor (its amax to the type's
largest value), the products summed in float32; the rest as above.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

LAST_DELTA = 1e2


def param_spec(dims: Dict, n_images: int) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """name -> (shape, fan_in) of every trained parameter; fan_in 0 marks an
    embedding table."""
    W, F, A, C, T = dims["W"], dims["feat_dim"], dims["appearance_dim"], dims["candidate_dim"], dims["transient_dim"]
    x0, d0, HH = 3 + 6 * dims["xyz_L"], 3 + 6 * dims["dir_L"], W // 2
    spec = {}

    def lin(name, fan_in, fan_out):
        spec[f"{name}.weight"] = ((fan_out, fan_in), fan_in)
        spec[f"{name}.bias"] = ((fan_out,), fan_in)

    for field in ("nerf_coarse", "nerf_fine"):
        for i in range(dims["D"]):
            lin(f"{field}.xyz_encoding_{i + 1}.0", x0 if i == 0 else W + x0 if i in dims["skips"] else W, W)
        lin(f"{field}.xyz_encoding_final", W, W)
        lin(f"{field}.share_sigma.0", W, 1)
        lin(f"{field}.rgb_share_layer.0", F + d0 + A, HH)
        lin(f"{field}.rgb_share_layer.2", HH, 3)
        lin(f"{field}.feat_share_layer", W, F)
        lin(f"{field}.candidate_encoding.0", W + C, HH)
        lin(f"{field}.candidate_encoding.2", HH, HH)
        lin(f"{field}.candidate_sigma.0", HH, 1)
        lin(f"{field}.feat_candidate_layer", HH, F)
    spec["transient_net.embedding_t.weight"] = ((n_images, T), 0)
    for i in range(4):
        lin(f"transient_net.feat_encoder.{2 * i}", F if i == 0 else 256, 256)
    lin("transient_net.final_encoder", 256, 256)
    lin("transient_net.t_encoder.0", 256 + T, 128)
    lin("transient_net.alpha_layer.0", 256, 1)
    lin("transient_net.beta_layer.0", 128, 1)
    lin("transient_net.rgb_layer.0", 128, 3)
    for name, dim in (("coarse_a", A), ("fine_a", A), ("coarse_c", C), ("fine_c", C)):
        spec[f"embedding_{name}.weight"] = ((n_images, dim), 0)
    return spec


# --- products --------------------------------------------------------------------------------


def _round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to a float8 type under one scale for the tensor (its amax
    to the type's largest value), back in float32."""
    top = torch.finfo(dtype).max
    scale = top / x.abs().max().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


class _Fp8Linear(torch.autograd.Function):
    """x @ w.T with every product in float8 as a hybrid fp8 recipe runs it:
    the forward's operands in e4m3, the backward's output cotangent in e5m2
    against the forward's e4m3 operands; sums in float32."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _round_fp8(x, torch.float8_e4m3fn), _round_fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.t()

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _round_fp8(g, torch.float8_e5m2)
        return gq @ wq, gq.t() @ xq


def linear(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str, precision: str) -> torch.Tensor:
    w = p[f"{name}.weight"]
    if precision == "fp8":
        return _Fp8Linear.apply(x, w) + p[f"{name}.bias"]
    return x @ w.t() + p[f"{name}.bias"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


# --- geometry ----------------------------------------------------------------------------------


def _skew(w: torch.Tensor) -> torch.Tensor:
    o = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([o, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], o, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], o], -1)], -2)


def _taylor(x2: torch.Tensor, first: int) -> torch.Tensor:
    """sum_i (-1)^i x^(2i) / (2i + first)! for i = 0..10, from x^2: first = 1
    gives sin(x) / x, 2 gives (1 - cos x) / x^2, 3 gives (x - sin x) / x^3."""
    out, term = torch.zeros_like(x2), torch.ones_like(x2) / math.factorial(first)
    for i in range(11):
        out = out + term
        term = -term * x2 / ((2 * i + first + 1) * (2 * i + first + 2))
    return out


def se3_exp(wu: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 4): [R | V u] with R = I + A wx + B wx^2,
    V = I + B wx + C wx^2."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = _skew(w)
    t2 = (w**2).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=wu.dtype, device=wu.device)
    wx2 = wx @ wx
    A, B, C = _taylor(t2, 1), _taylor(t2, 2), _taylor(t2, 3)
    R = eye + A * wx + B * wx2
    V = eye + B * wx + C * wx2
    return torch.cat([R, V @ u[..., None]], -1)


def compose(inner: torch.Tensor, outer: torch.Tensor) -> torch.Tensor:
    """outer o inner for (..., 3, 4) poses."""
    R = outer[..., :3] @ inner[..., :3]
    t = outer[..., :3] @ inner[..., 3:] + outer[..., 3:]
    return torch.cat([R, t], -1)


def rays(px, py, K, pose, near_far) -> torch.Tensor:
    """(n, 8) rays: o, unit d, near, far; K (n, 3, 3), pose (n, 3, 4)."""
    px, py = px.float(), py.float()
    d_cam = torch.stack([(px - K[:, 0, 2]) / K[:, 0, 0], -(py - K[:, 1, 2]) / K[:, 1, 1], -torch.ones_like(px)], -1)
    d = (pose[:, :, :3] @ d_cam[..., None])[..., 0]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return torch.cat([pose[:, :, 3], d, near_far], -1)


def bilinear(maps: torch.Tensor, img, u, v) -> torch.Tensor:
    _, h, w, _ = maps.shape
    y, x = u.float() * (h - 1), v.float() * (w - 1)
    y0 = torch.clamp(torch.floor(y), 0, max(h - 2, 0)).long()
    x0 = torch.clamp(torch.floor(x), 0, max(w - 2, 0)).long()
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    fy, fx = (y - y0.float())[:, None], (x - x0.float())[:, None]
    gy, gx = (y1.float() - y)[:, None], (x1.float() - x)[:, None]
    return (gy * gx * maps[img, y0, x0].float() + gy * fx * maps[img, y0, x1].float()
            + fy * gx * maps[img, y1, x0].float() + fy * fx * maps[img, y1, x1].float())


def depth_prior(depth_scale, img, inv_depth, near: float, far: float) -> torch.Tensor:
    ss = depth_scale[img]
    inv = torch.clamp(inv_depth * torch.exp(ss[:, 0]) + ss[:, 1], min=1.0 / far)
    return torch.clamp(1.0 / inv, min=near)


# --- the field and the render ------------------------------------------------------------------


def band_weights(progress: float, L: int, c2f, device) -> torch.Tensor:
    """BARF's coarse-to-fine weights (1 - cos(pi clamp(alpha - k, 0, 1))) / 2
    with alpha = (progress - start) / (end - start) L in float32."""
    if c2f is None:
        return torch.ones(L, device=device)
    s, e = c2f
    alpha = ((torch.tensor(float(progress), dtype=torch.float32) - s) / (e - s) * L).item()
    k = torch.arange(L, dtype=torch.float32, device=device)
    return (1 - torch.cos(torch.clamp(alpha - k, 0.0, 1.0) * math.pi)) / 2


def encode(x: torch.Tensor, L: int, w: torch.Tensor) -> torch.Tensor:
    freq = 2.0 ** torch.arange(L, dtype=torch.float32, device=x.device) * math.pi
    s = x[..., None] * freq
    enc = torch.stack([torch.sin(s) * w, torch.cos(s) * w], -2)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], -1)


def field_pass(p, prefix: str, dims: Dict, rays_: torch.Tensor, z: torch.Tensor, a_emb, c_emb, *, use_cand: bool,
               use_rgb: bool, out_feat: bool, progress: float, c2f, precision: str) -> Dict[str, torch.Tensor]:
    """One pass over rays (R, 8) at depths z (R, S)."""
    R, S = z.shape
    o, d = rays_[:, 0:3], rays_[:, 3:6]
    xyz = o[:, None, :] + d[:, None, :] * z[..., None]
    x0 = encode(xyz, dims["xyz_L"], band_weights(progress, dims["xyz_L"], c2f, z.device)).reshape(R * S, -1)
    h = x0
    for i in range(dims["D"]):
        if i in dims["skips"] and i > 0:
            h = torch.cat([x0, h], -1)
        h = torch.relu(linear(h, p, f"{prefix}.xyz_encoding_{i + 1}.0", precision))
    xyzf = linear(h, p, f"{prefix}.xyz_encoding_final", precision)
    sig_s = softplus(linear(h, p, f"{prefix}.share_sigma.0", precision)).reshape(R, S)
    feat = linear(xyzf, p, f"{prefix}.feat_share_layer", precision)
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], LAST_DELTA)], -1)

    def weights(alpha):
        T = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1]], -1), -1)
        return T, alpha * T

    a_s = 1.0 - torch.exp(-delta * sig_s)
    _, w_s = weights(a_s)
    out = {"s_weights": w_s, "s_depth": (w_s * z).sum(-1)}
    if use_rgb:
        dir_pe = encode(d.detach(), dims["dir_L"], band_weights(progress, dims["dir_L"], c2f, z.device))
        per_ray = torch.cat([dir_pe, a_emb], -1)
        rgb_in = torch.cat([feat, per_ray[:, None, :].expand(R, S, per_ray.shape[-1]).reshape(R * S, -1)], -1)
        rgbh = torch.relu(linear(rgb_in, p, f"{prefix}.rgb_share_layer.0", precision))
        rgb = torch.sigmoid(linear(rgbh, p, f"{prefix}.rgb_share_layer.2", precision)).reshape(R, S, 3)
        out["rgb"] = (w_s[..., None] * rgb).sum(1)
    if use_cand:
        c_in = torch.cat([xyzf, c_emb[:, None, :].expand(R, S, c_emb.shape[-1]).reshape(R * S, -1)], -1)
        h1 = torch.relu(linear(c_in, p, f"{prefix}.candidate_encoding.0", precision))
        h2 = torch.relu(linear(h1, p, f"{prefix}.candidate_encoding.2", precision))
        sig_c = softplus(linear(h2, p, f"{prefix}.candidate_sigma.0", precision)).reshape(R, S)
        cfeat = linear(h2, p, f"{prefix}.feat_candidate_layer", precision).reshape(R, S, -1)
        a_c = 1.0 - torch.exp(-delta * sig_c)
        Tj, w_j = weights(1.0 - torch.exp(-delta * (sig_s + sig_c)))
        w_sj, w_c = a_s * Tj, a_c * Tj
        out["c_weights"] = w_j
        out["c_depth"] = (w_j * z).sum(-1)
        out["t_weight"] = w_c.sum(-1)
        if out_feat:
            out["feat"] = (w_sj[..., None] * feat.reshape(R, S, -1)).sum(1) + (w_c[..., None] * cfeat).sum(1)
    elif out_feat:
        out["feat"] = (w_s[..., None] * feat.reshape(R, S, -1)).sum(1)
    return out


def stratified(near, far, n: int, u: Optional[torch.Tensor]) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, n, device=near.device)
    z = (near * (1 - t) + far * t).expand(near.shape[0], n)
    if u is None:
        return z
    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    upper, lower = torch.cat([mid, z[:, -1:]], -1), torch.cat([z[:, :1], mid], -1)
    return lower + (upper - lower) * u


def inverse_cdf(bins, weights, n: int, u: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """Depths drawn from the piecewise-constant pdf of `weights` (+ eps) over
    the bins; u None: the deterministic grid linspace(0, 1, n)."""
    R, M = weights.shape
    pdf = (weights + eps) / (weights + eps).sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=bins.device).expand(R, n)
    u = u.contiguous()
    above_i = torch.searchsorted(cdf, u, right=True)
    lo, hi = torch.clamp(above_i - 1, min=0), torch.clamp(above_i, max=M)
    c0, c1 = torch.gather(cdf, 1, lo), torch.gather(cdf, 1, hi)
    b0, b1 = torch.gather(bins, 1, lo), torch.gather(bins, 1, hi)
    den = c1 - c0
    den = torch.where(den < eps, torch.ones_like(den), den)
    return b0 + (u - c0) / den * (b1 - b0)


def render(p, dims: Dict, rays_: torch.Tensor, emb: Dict[str, Optional[torch.Tensor]], *, phase: int,
           sched: float, progress: float, c2f, precision: str, u_coarse=None, u_fine=None,
           use_cand: bool = True) -> Dict[str, Dict[str, torch.Tensor]]:
    """Coarse and fine passes of rays (R, 8); emb holds the per-ray rows
    coarse_a, fine_a, coarse_c, fine_c. u_* None: the deterministic path."""
    use_cand = use_cand and phase < 2
    kw = dict(use_cand=use_cand, use_rgb=phase > 0, out_feat=phase < 2, progress=progress, c2f=c2f,
              precision=precision)
    near, far = rays_[:, 6:7].detach(), rays_[:, 7:8].detach()
    z = stratified(near, far, dims["N_samples"], u_coarse).detach()
    coarse = field_pass(p, "nerf_coarse", dims, rays_, z, emb.get("coarse_a"), emb.get("coarse_c"), **kw)
    if use_cand and phase == 0:
        w_src = coarse["c_weights"]
    elif use_cand and phase == 1:
        w_src = (1.0 - sched) * coarse["c_weights"] + sched * coarse["s_weights"]
    else:
        w_src = coarse["s_weights"]
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    z_imp = inverse_cdf(z_mid, w_src[:, 1:-1].detach(), dims["N_importance"], u_fine)
    z_fine = torch.sort(torch.cat([z, z_imp], -1), -1).values.detach()
    fine = field_pass(p, "nerf_fine", dims, rays_, z_fine, emb.get("fine_a"), emb.get("fine_c"), **kw)
    return {"coarse": coarse, "fine": fine}


def transient(p, feats, t_emb, beta_min: float, precision: str) -> Dict[str, torch.Tensor]:
    h = feats
    for i in range(4):
        h = torch.relu(linear(h, p, f"transient_net.feat_encoder.{2 * i}", precision))
    final = linear(h, p, "transient_net.final_encoder", precision)
    t = torch.relu(linear(torch.cat([final, t_emb], -1), p, "transient_net.t_encoder.0", precision))
    alpha = torch.sigmoid(linear(h, p, "transient_net.alpha_layer.0", precision))[:, 0]
    beta = softplus(linear(t, p, "transient_net.beta_layer.0", precision))[:, 0] * alpha + beta_min
    return {"alpha": alpha, "beta": beta}


def train_loss_sum(out, rgb, feats, depth_t, t, *, phase: int, sched: float, depth_mult: float,
                   alpha_reg: float) -> Dict[str, torch.Tensor]:
    """The scheduled loss terms of a block of rays as sums over its rays of
    each term's per-ray mean; divided by the batch they are the batch's
    terms."""
    terms = {}
    for typ in ("coarse", "fine"):
        o, c = out[typ], typ[0]
        if phase < 2:
            l1 = torch.abs(o["s_depth"] - depth_t)
            if "t_weight" in o:
                l1 = l1 * (1.0 - o["t_weight"].detach())
            terms[f"l_depth_{c}"] = l1.sum() * depth_mult * (1.0 - sched)
            terms[f"l_feat_{c}"] = ((o["feat"] - feats) ** 2).mean(-1).sum() * (1.0 - sched)
    if phase > 0:
        terms["l_rgb_c"] = ((out["coarse"]["rgb"] - rgb) ** 2).mean(-1).sum() * sched / 2.0
        beta = t["beta"]
        terms["l_rgb_f"] = (((out["fine"]["rgb"] - rgb) ** 2) / (2.0 * beta[:, None] ** 2)).mean(-1).sum() * sched
        terms["l_beta"] = torch.log(beta).sum() * sched
        terms["l_alpha"] = t["alpha"].sum() * alpha_reg * sched
    return terms


class Adam:
    """torch.optim.Adam's update (betas 0.9, 0.999; eps 1e-8), written out."""

    def __init__(self, params: Dict[str, torch.Tensor], lrs: Dict[str, float]):
        self.p, self.lrs = params, lrs
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: Dict[str, torch.Tensor], lr_mult: Dict[str, float]) -> None:
        self.t += 1
        b1, b2 = 0.9, 0.999
        c1, c2 = 1 - b1**self.t, 1 - b2**self.t
        for k, p in self.p.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + 1e-8
            p.sub_(self.lrs[k] * lr_mult.get(k, 1.0) / c1 * self.m[k] / denom)


def exp_lr(lr: float, lr_end: float, max_steps: int, t: int) -> float:
    """ExponentialLR's rate at update t, lr gamma^t with gamma = (lr_end /
    lr)^(1 / max_steps), in float32 as optax's exponential_decay computes
    it (gamma's rounding, raised to t ~ 1e5, moves the rate by ~1e-2)."""
    f32 = np.float32
    gamma = f32((lr_end / lr) ** (1.0 / max_steps))
    return float(f32(lr) * gamma ** f32(t))
