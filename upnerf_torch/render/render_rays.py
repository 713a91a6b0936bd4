"""Coarse + fine volume renderer (upnerf/render/render_rays.py), all phases.

The schedule phase is an argument: 0 (feature/candidate), 1 (blended), 2
(rgb). Each pass (coarse at N_samples, fine at N_samples + N_importance
merged samples) takes the JAX package's route for its configuration
(`_inference`, the same conditions, R % 8 == 0 included):
- a deterministic phase-2 pass without the candidate branch, with
  fused_render or fused_train on: the fused render of
  upnerf_torch.ops.render_train in its serving mode when fused_train is on,
  else the static render of upnerf_torch.ops.render (kernel 4, from the PE
  rows);
- otherwise, with fused_train on: the fused render of ops.render_train in the
  phase's mode (forward and backward kernels);
- otherwise the field, NeRFField.forward (trunk and heads through
  ops.heads.fused_trunk_heads with nerf's fused_trunk on; the feature-less
  field's trunk through ops.mlp.fused_trunk), and the compositing of
  volume.py; `remat` wraps the field in torch.utils.checkpoint.
Each emits the same result keys:
- phases 0/1 with the candidate branch: c_weights_* (the joint weights),
  c_depth_*, t_weight_*, feat_* (c_rgb_* for the feature-less field); without
  it s_weights_*, feat_*;
- phases 1/2: s_weights_*, s_rgb_*;
- always s_depth_*.

On the fused paths the per-ray rgb conditioning

    ray_cond = PE(dir) @ W_rgb1[F:F+27] + b_rgb1 + a_emb @ W_rgb1[F+27:]

is a small product outside the kernel; the kernel builds (or reads) the PE,
the trunk, the heads and the compositing. With grad mode on and a trainable
input the fused train pass goes through the autograd.Function
`RenderTrainRays` (forward and backward kernels); otherwise through the
forward alone.

Gradient stops, as in the JAX package: directions are detached as MLP
inputs, z is detached, the importance weights are detached. Fine samples in
phase 1 are drawn from the mixture CDF (1 - m) c_weights + m s_weights.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from upnerf_torch.models.nerf import NeRFField, band_weights, positional_encoding
from upnerf_torch.ops import render as static_render
from upnerf_torch.ops import render_train as rt
from upnerf_torch.ops.linear import canonical_precision

from . import volume
from .sampling import sample_pdf, stratified_z_vals


class RenderConfig(NamedTuple):
    """Static rendering hyperparameters. The tpu.fused_* switches pick the
    route of `_inference`; an omitted one is on, as the JAX package turns them
    on for its accelerator."""

    N_samples: int = 128
    N_importance: int = 128
    use_disp: bool = False
    perturb: float = 1.0
    precision: str = "float32"
    store_f32: bool = True
    # False: the fused backward computes no weight gradient (the frozen model of
    # test-time optimization); set by the caller, never read from hparams.
    param_grads: bool = True
    fused_render: bool = True  # deterministic phase-2 passes through a fused forward
    fused_train: bool = True  # every pass through ops.render_train, forward and backward
    save_chain: bool = True  # the fused backward reads the forward's walk chain
    remat: bool = False  # recompute the unfused field in the backward (torch.utils.checkpoint)

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any]) -> "RenderConfig":
        cfg = cls(
            N_samples=hp["nerf.N_samples"],
            N_importance=hp["nerf.N_importance"],
            use_disp=hp["nerf.use_disp"],
            perturb=hp["nerf.perturb"],
            precision=canonical_precision(hp.get("tpu.matmul_precision", "float32")),
            store_f32=hp.get("tpu.store_f32", True),
            fused_render=bool(hp.get("tpu.fused_render", True)),
            fused_train=bool(hp.get("tpu.fused_train", True)),
            save_chain=bool(hp.get("tpu.save_chain", True)),
            remat=bool(hp.get("tpu.remat", False)),
        )
        if cfg.fused_train and not cfg.save_chain:
            raise NotImplementedError("tpu.save_chain false (the fused backward's recompute mode) is not ported"
                                      " (ROADMAP.md, kernel 2)")
        return cfg


def field_weights(field: NeRFField):
    """(trunk, heads) of one field in the fused render's interface: (in,
    out) matrices as in the JAX package; the rgb1 bias goes into ray_cond.
    The heads cover every mode; a mode reads RTStatic.head_keys of them."""
    cfg = field.cfg
    trunk = [(lay.weight.t(), lay.bias) for lay in field.trunk_layers()]
    F = cfg.feat_dim
    heads = {
        "xyzf_w": field.xyz_encoding_final.weight.t(),
        "xyzf_b": field.xyz_encoding_final.bias,
        "sigma_w": field.share_sigma[0].weight.t(),
        "sigma_b": field.share_sigma[0].bias,
        "feat_w": field.feat_share_layer.weight.t(),
        "feat_b": field.feat_share_layer.bias,
        "rgb1_w": field.rgb_share_layer[0].weight[:, :F].t(),
        "rgb2_w": field.rgb_share_layer[2].weight.t(),
        "rgb2_b": field.rgb_share_layer[2].bias,
    }
    if cfg.encode_candidate:
        c1, c2 = field.candidate_encoding[0], field.candidate_encoding[2]
        heads.update(
            c1x_w=c1.weight[:, : cfg.W].t(), c1c_w=c1.weight[:, cfg.W :].t(), c1_b=c1.bias,
            c2_w=c2.weight.t(), c2_b=c2.bias,
            csig_w=field.candidate_sigma[0].weight.t(), csig_b=field.candidate_sigma[0].bias,
            cfeat_w=field.feat_candidate_layer.weight.t(), cfeat_b=field.feat_candidate_layer.bias,
        )
    return trunk, heads


def ray_conditioning(
    field: NeRFField, rays_d: torch.Tensor, a_emb: Optional[torch.Tensor], progress: float
) -> torch.Tensor:
    """(R, W/2) per-ray part of the rgb head's first layer, bias included:
    concat(feat, PE(dir), a) @ W == feat @ W0 + (PE(dir) @ W1 + b + a @ W2).
    Directions are detached: pose gradients flow only through the samples."""
    cfg = field.cfg
    rays_d = rays_d.detach()
    dir_pe = positional_encoding(rays_d, cfg.dir_L, band_weights(cfg, cfg.dir_L, progress, rays_d.device))
    rgb1 = field.rgb_share_layer[0]
    F, dd = cfg.feat_dim, dir_pe.shape[-1]
    ray_cond = dir_pe @ rgb1.weight[:, F : F + dd].t() + rgb1.bias
    if cfg.encode_appearance:
        ray_cond = ray_cond + a_emb @ rgb1.weight[:, F + dd :].t()
    return ray_cond.contiguous()


def _fused_train_path(results, field: NeRFField, typ, rays_o, rays_d, z_vals, a_emb, c_emb, *, phase, progress,
                      cfg: RenderConfig, use_cand: bool) -> None:
    """One pass through the fused render of ops.render_train (the JAX
    package's `_fused_train_path`)."""
    ncfg = field.cfg
    st = rt.RTStatic(
        D=ncfg.D, skips=tuple(ncfg.skips), xyz_L=ncfg.xyz_L, precision=cfg.precision, use_cand=use_cand,
        use_rgb=phase > 0, out_feat=phase < 2, store_f32=cfg.store_f32, save_chain=cfg.save_chain,
        param_grads=cfg.param_grads,
    )
    w_xyz = band_weights(ncfg, ncfg.xyz_L, progress, rays_o.device)
    ray_cond = ray_conditioning(field, rays_d, a_emb, progress) if st.use_rgb else None
    c_emb = c_emb.contiguous() if use_cand else None
    trunk, heads = field_weights(field)
    heads = {k: heads[k] for k in st.head_keys}
    args = (rays_o.contiguous(), rays_d.contiguous(), z_vals.contiguous(), w_xyz, ray_cond, trunk, heads, st)
    tensors = [rays_o, rays_d, ray_cond, c_emb, *heads.values()] + [t for wb in trunk for t in wb]
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        out = rt.render_train_rays(*args, c_emb=c_emb)
    else:
        out = rt.render_train_rays_fwd(*args, c_emb=c_emb)
    if phase < 2:
        if use_cand:
            results[f"c_weights_{typ}"] = out["j_weights"]
            results[f"c_depth_{typ}"] = out["c_depth"]
            results[f"t_weight_{typ}"] = out["t_weight"]
        else:
            results[f"s_weights_{typ}"] = out["s_weights"]
        results[f"feat_{typ}"] = out["feat_map"]
    if phase > 0:
        results[f"s_weights_{typ}"] = out["s_weights"]
        results[f"s_rgb_{typ}"] = out["rgb_map"]
    results[f"s_depth_{typ}"] = out["s_depth"]


def _fused_static_path(results, field: NeRFField, typ, rays_o, rays_d, z_vals, a_emb, *, progress,
                       cfg: RenderConfig) -> None:
    """A deterministic phase-2 pass through the static render of ops.render
    (the JAX package's `_fused_static_path`): the PE rows are built here."""
    ncfg = field.cfg
    R, S = z_vals.shape
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    x0 = positional_encoding(xyz, ncfg.xyz_L, band_weights(ncfg, ncfg.xyz_L, progress, xyz.device)).reshape(R * S, -1)
    trunk, heads = field_weights(field)
    head = {k: heads[k] for k in static_render.HEAD_KEYS}
    ray_cond = ray_conditioning(field, rays_d, a_emb, progress)
    rgb_map, depth, weights = static_render.fused_static_render(x0, z_vals, ray_cond, trunk, head, ncfg.skips,
                                                                cfg.precision)
    results[f"s_weights_{typ}"] = weights
    results[f"s_rgb_{typ}"] = rgb_map
    results[f"s_depth_{typ}"] = depth[:, 0]


def _field_path(results, field: NeRFField, typ, rays_o, rays_d, z_vals, a_emb, c_emb, *, phase, progress,
                cfg: RenderConfig, encode_candidate: bool) -> None:
    """One pass through NeRFField.forward and the compositing of volume.py
    (the JAX package's XLA path)."""
    ncfg = field.cfg
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    dirs = rays_d.detach()  # pose gradients flow only through the samples

    def apply(xyz_, a_, c_):
        return field(xyz_, dirs, a_, progress=progress, precision=cfg.precision, phase=phase, c_emb=c_,
                     encode_candidate=encode_candidate)

    if cfg.remat:
        out = torch.utils.checkpoint.checkpoint(apply, xyz, a_emb, c_emb, use_reentrant=False)
    else:
        out = apply(xyz, a_emb, c_emb)
    deltas = volume.deltas_from_z(z_vals)
    s_alphas = volume.alpha_from_sigma(out["s_sigma"], deltas)
    only_s = volume.composite_weights(s_alphas)
    if phase < 2:
        if "c_sigma" not in out:
            if not ncfg.encode_feat:
                raise NotImplementedError("feature-less candidate-free phase<2 has no reference path")
            results[f"s_weights_{typ}"] = only_s
            results[f"feat_{typ}"] = volume.weighted_sum(only_s, out["s_feat"])
        else:
            c_alphas = volume.alpha_from_sigma(out["c_sigma"], deltas)
            joint = volume.alpha_from_sigma(out["s_sigma"] + out["c_sigma"], deltas)
            trans = volume.transmittance_of(joint)
            s_w, c_w = s_alphas * trans, c_alphas * trans
            weights = joint * trans
            results[f"c_weights_{typ}"] = weights
            results[f"c_depth_{typ}"] = volume.depth_map(weights, z_vals)
            key, s_val, c_val = ("feat", "s_feat", "c_feat") if ncfg.encode_feat else ("c_rgb", "s_rgb", "c_rgb")
            results[f"{key}_{typ}"] = volume.weighted_sum(s_w, out[s_val]) + volume.weighted_sum(c_w, out[c_val])
            results[f"t_weight_{typ}"] = c_w.sum(-1)
    if phase > 0:
        results[f"s_weights_{typ}"] = only_s
        results[f"s_rgb_{typ}"] = volume.weighted_sum(only_s, out["s_rgb"])
    results[f"s_depth_{typ}"] = volume.depth_map(only_s, z_vals)


def _inference(
    results: Dict[str, torch.Tensor],
    field: NeRFField,
    typ: str,
    rays_o: torch.Tensor,  # (R, 3)
    rays_d: torch.Tensor,  # (R, 3)
    z_vals: torch.Tensor,  # (R, S)
    a_emb: Optional[torch.Tensor],  # (R, A)
    c_emb: Optional[torch.Tensor],  # (R, C)
    *,
    phase: int,
    progress: float,
    cfg: RenderConfig,
    encode_candidate: bool,
    det: bool,
) -> None:
    """One pass, by the JAX package's route for the configuration
    (render_rays.py:132-243); adds its result keys with the suffix `typ`
    ('coarse' | 'fine') to `results`."""
    ncfg = field.cfg
    R = z_vals.shape[0]
    use_cand = ncfg.encode_candidate and encode_candidate and phase < 2
    kw = dict(progress=progress, cfg=cfg)
    if (phase == 2 and det and not use_cand and ncfg.encode_feat and ncfg.encode_appearance
            and (cfg.fused_render or cfg.fused_train) and R % 8 == 0):
        if cfg.fused_train:
            _fused_train_path(results, field, typ, rays_o, rays_d, z_vals, a_emb, c_emb, phase=phase, use_cand=False,
                              **kw)
        else:
            _fused_static_path(results, field, typ, rays_o, rays_d, z_vals, a_emb, **kw)
        return
    if cfg.fused_train and ncfg.encode_feat and R % 8 == 0:
        _fused_train_path(results, field, typ, rays_o, rays_d, z_vals, a_emb, c_emb, phase=phase, use_cand=use_cand,
                          **kw)
        return
    _field_path(results, field, typ, rays_o, rays_d, z_vals, a_emb, c_emb, phase=phase,
                encode_candidate=encode_candidate, **kw)


def render_rays(
    params: Dict[str, Any],
    cfg: RenderConfig,
    rays: torch.Tensor,  # (R, 8): o, d, near, far
    img_idx: torch.Tensor,  # (R,) int
    *,
    phase: int = 2,
    sched_mult: float = 1.0,
    progress: float = 1.0,
    encode_candidate: bool = True,
    det: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Render a ray batch at a schedule phase.

    params: {"nerf_coarse": NeRFField, "nerf_fine": NeRFField,
    "embeddings": {"coarse_a", "fine_a", "coarse_c", "fine_c": (N_images,
    dim)}}; embedding rows are gathered by img_idx. det=True, or no generator
    and no noise, gives the deterministic eval path. `noise` supplies
    pre-drawn uniforms {"coarse": (R, N_samples), "fine": (R, N_importance)}.
    `sched_mult` (a host float) weights the phase-1 mixture CDF."""
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7].detach(), rays[:, 7:8].detach()
    emb = params["embeddings"]
    if generator is None and noise is None:
        det = True
    noise = noise or {}

    def emb_for(prefix: str, name: str):
        table = emb.get(f"{prefix}_{name}")
        return None if table is None else table[img_idx]

    z_vals = stratified_z_vals(
        near, far, cfg.N_samples, use_disp=cfg.use_disp, perturb=0.0 if det else cfg.perturb,
        generator=generator, u=noise.get("coarse"),
    ).detach()
    results: Dict[str, torch.Tensor] = {}
    kw = dict(phase=phase, progress=progress, cfg=cfg, encode_candidate=encode_candidate, det=det)
    _inference(results, params["nerf_coarse"], "coarse", rays_o, rays_d, z_vals, emb_for("coarse", "a"),
               emb_for("coarse", "c"), **kw)
    if cfg.N_importance > 0:
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        use_cand = params["nerf_coarse"].cfg.encode_candidate and encode_candidate
        if use_cand and phase == 0:
            w_src = results["c_weights_coarse"]
        elif use_cand and phase == 1:
            w_src = (1.0 - sched_mult) * results["c_weights_coarse"] + sched_mult * results["s_weights_coarse"]
        else:
            w_src = results["s_weights_coarse"]
        z_samples = sample_pdf(
            z_mid, w_src[:, 1:-1].detach(), cfg.N_importance, det=det, generator=generator, u=noise.get("fine"),
        )
        z_fine = volume.merge_sorted_z(z_vals, z_samples).detach()
        _inference(results, params["nerf_fine"], "fine", rays_o, rays_d, z_fine, emb_for("fine", "a"),
                   emb_for("fine", "c"), **kw)
    return results
