"""Fused render of one NeRF pass, forward and backward
(upnerf/ops/pallas_render_train.py), from rays or from pre-built PE rows.

Per ray: xyz = o + d z and the annealed PE (the rays frontend; the x0
frontend reads the PE rows x0 (R*S, in0) instead), the D-layer trunk, the
sigma / xyz_final / feat / rgb heads, the candidate branch (h1 = relu(xyzf @
c1x_w + c_emb @ c1c_w + c1_b), h2, c_sigma, c_feat) and both compositing
branches (s-only and joint). RTStatic selects the mode, as in the JAX kernel:
phase 0 (use_cand, out_feat), phase 1 (use_cand, use_rgb, out_feat), phase 2
(use_rgb). Outputs, in RTStatic.out_keys: s_weights (R, S), s_depth (R,),
rgb_map (R, 3), feat_map (R, F), j_weights (R, S), c_depth (R,), t_weight (R,).

- `render_train_plain` is the plain PyTorch forward from x0 (the JAX
  package's XLA twin `xla_render_train`, compositing by cumprod), and
  `render_train_rays_plain` the same behind the PE of the rays
  (`xla_render_train_rays`). With `save_res=True` they also return the
  residuals the backward reads, in RTStatic.res_keys: the sigmas (f32), the
  per-sample rgb and, with save_chain, the walk chain (trunk activations,
  xyzf, rgbh, h1, h2) in the compute dtype; without it (the recompute mode)
  the per-sample feat and c_feat in the store dtype instead.
- `render_train_bwd_plain` is the plain backward down to d_x0 (R*S, in0):
  `_bwd_kernel` step by step, with its division-free compositing formulas and
  its roundings (in bf16 mode every product rounds both operands, the
  cotangent included). In the recompute mode it rebuilds the walk chain from
  x0, with rgbh from the stored feat. `render_train_rays_bwd_plain` is it on
  the PE rows followed by the PE backward (`_pe_bwd`) down to d_rays_o /
  d_rays_d.
- `render_train_bwd_dw_plain` / `render_train_rays_bwd_dw_plain` are the
  backward as its CUDA route splits it: per slab of rays, the walk fills the
  dW operand buffers of `dw_layout`, then the plain dW
  (`dw_gemm.dw_gemm_plain`) adds the slab's weight and bias gradients; in
  the recompute mode each slab's chain is first rebuilt by the plain
  forward with save_chain on (`render_train_bwd_rec_plain` /
  `render_train_rays_bwd_rec_plain`).
- `render_train_rays_fwd` / `render_train_rays_bwd` and `render_train_fwd` /
  `render_train_bwd` are the wrappers of the two frontends: on CPU tensors
  they run the plain versions; on CUDA tensors they launch the hand-written
  kernels (`csrc/render_train_fwd.cu`, `csrc/render_train_bwd.cu`; the x0
  frontend is their X0_IN mode, any in0 <= 64; the bf16 train backward also
  `csrc/dw_gemm.cu`, counted in `dw_gemm.dw_launches`; the recompute
  backward also the forward kernel, which rebuilds each slab's chain,
  counted in `rebuild_launches`) or raise. The rays frontend counts its
  launches in `launches`, `bwd_launches` and (the backward's frozen-model
  mode) `frozen_bwd_launches`; in the recompute mode, the forward with
  residuals and both backward modes (one a call) in `recompute_launches`,
  `recompute_bwd_launches` and `recompute_frozen_bwd_launches` instead. The
  x0 frontend counts every mode's in `x0_launches` and `x0_bwd_launches`.
- `RenderTrainRays` and `RenderTrain` are the autograd.Functions of the two
  frontends (the JAX kernel's custom VJPs): the forward runs the forward with
  residuals, the backward the backward. They return gradients for rays_o and
  rays_d, or x0, and for ray_cond, c_emb and every weight, and None for z_vals
  and pe_w (neither has a trainable ancestor in training). With
  RTStatic.param_grads = False (the frozen-model mode that test-time
  optimization runs) the backward computes the data cotangents only and
  returns None for every weight; a weight that requires grad is refused.

Weights come in the JAX kernel's interface: `trunk` is a sequence of
(W (in, out), b (out,)) pairs and `heads` holds xyzf_w/b, sigma_w/b,
feat_w/b, rgb1_w (F, HH; its bias is folded into ray_cond), rgb2_w/b and
c1x_w, c1c_w, c1_b, c2_w/b, csig_w/b, cfeat_w/b, as RTStatic.head_keys says.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from upnerf_torch.ops import dw_gemm
from upnerf_torch.ops.linear import canonical_precision, matmul

LAST_DELTA = 1e2  # the last interval is quasi-infinite, as in render/volume.py

HEAD_BASE = ("xyzf_w", "xyzf_b", "sigma_w", "sigma_b")
HEAD_FEAT = ("feat_w", "feat_b")
HEAD_RGB = ("rgb1_w", "rgb2_w", "rgb2_b")
HEAD_CAND = ("c1x_w", "c1c_w", "c1_b", "c2_w", "c2_b", "csig_w", "csig_b", "cfeat_w", "cfeat_b")
HEAD_KEYS = HEAD_BASE + HEAD_FEAT + HEAD_RGB + HEAD_CAND  # the kernels' pointer order
RES_ORDER = ("sig_s", "sig_c", "rgb", "chain", "feat", "cfeat")  # the kernels' residual pointer order
X0_PAD = 64  # the kernels' x0 width: in0 (3 + 6L from rays) padded to a multiple of 16
# The widths the CUDA kernels take (configs/brandenburg_gate.yaml, configs/validation/),
# and the feature widths they are built for (render_common.cuh:feat_pad).
KERNEL_WIDTHS = {"W": 256, "HH": 128, "HC": 128}
KERNEL_F = (32, 64, 384)
MAX_C = 32  # candidate embedding width the kernels take

# Kernel launches made in this process by render_train_rays_fwd / _bwd
# (the backward's frozen-model mode, and the recompute mode's launches, counted
# on their own).
launches = 0
bwd_launches = 0
frozen_bwd_launches = 0
recompute_launches = 0
recompute_bwd_launches = 0
recompute_frozen_bwd_launches = 0
# Forward launches of the recompute mode's backward, each rebuilding one slab's chain.
rebuild_launches = 0
# Kernel launches made by render_train_fwd / render_train_bwd (the x0 frontend), in every mode.
x0_launches = 0
x0_bwd_launches = 0
# Kernel launches of the bf16 backward's Hopper walk, in every mode and frontend (BwdLaunch, per slab of rays):
# the compositing pre-pass, the walk, the finishing pass.
walk_pre_launches = 0
walk_launches = 0
walk_finish_launches = 0


class RTStatic(NamedTuple):
    """Static configuration: trunk depth, skip layers, PE bands of xyz, the
    matmul precision ('bfloat16' or 'float32'), the mode (use_cand, use_rgb,
    out_feat), store_f32 (per-sample rgb/feat kept in f32; False rounds them
    to bf16 in bf16 mode), save_chain (True: the forward saves the walk chain
    and the backward reads it; False, the recompute mode: the forward saves
    the per-sample feat / c_feat and the backward recomputes the chain) and
    param_grads (False: the backward skips every weight gradient, for a
    frozen model)."""

    D: int
    skips: Tuple[int, ...]
    xyz_L: int
    precision: str = "float32"
    use_cand: bool = False
    use_rgb: bool = True
    out_feat: bool = False
    store_f32: bool = True
    save_chain: bool = True
    param_grads: bool = True

    @property
    def use_feat(self) -> bool:
        return self.out_feat or self.use_rgb

    @property
    def head_keys(self) -> Tuple[str, ...]:
        keys = list(HEAD_BASE)
        if self.use_feat:
            keys += HEAD_FEAT
        if self.use_rgb:
            keys += HEAD_RGB
        if self.use_cand:
            keys += HEAD_CAND
        return tuple(keys)

    @property
    def out_keys(self) -> Tuple[str, ...]:
        keys = ["s_weights", "s_depth"]
        if self.use_rgb:
            keys.append("rgb_map")
        if self.out_feat:
            keys.append("feat_map")
        if self.use_cand:
            keys += ["j_weights", "c_depth", "t_weight"]
        return tuple(keys)

    @property
    def res_keys(self) -> Tuple[str, ...]:
        """The forward's residuals (pallas_render_train.py:184-204): with
        save_chain the chain stands in for feat / c_feat."""
        keys = ["sig_s"] + (["sig_c"] if self.use_cand else [])
        if not self.save_chain:
            keys += (["feat"] if self.use_feat else []) + (["cfeat"] if self.out_feat and self.use_cand else [])
        keys += ["rgb"] if self.use_rgb else []
        return tuple(keys + (["chain"] if self.save_chain else []))

    def chain_cols(self, W: int, HH: int, HC: int) -> Tuple[Tuple[str, int], ...]:
        """(name, width) segments of the saved walk chain, concatenated along
        the columns of one (R*S, total) tensor (the JAX kernel's layout)."""
        segs = [(f"act{i}", W) for i in range(self.D)] + [("xyzf", W)]
        if self.use_rgb:
            segs.append(("rgbh", HH))
        if self.use_cand:
            segs += [("h1", HC), ("h2", HC)]
        return tuple(segs)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Stable softplus max(x, 0) + log1p(exp(-|x|)), with no threshold
    (torch.nn.functional.softplus switches to x above 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _cdt(st: RTStatic) -> torch.dtype:
    return torch.bfloat16 if canonical_precision(st.precision) == "bfloat16" else torch.float32


def _store_dtype(st: RTStatic) -> torch.dtype:
    """dtype of the per-sample feat / c_feat residuals (the JAX kernel's
    _store_dtype): bf16 only in bf16 mode with store_f32 off."""
    return torch.bfloat16 if _cdt(st) == torch.bfloat16 and not st.store_f32 else torch.float32


def _stored(x: torch.Tensor, st: RTStatic) -> torch.Tensor:
    """Per-sample rgb/feat as the kernel keeps them, in f32: rounded to the store dtype."""
    return x.to(_store_dtype(st)).float()


def _pe(rays_o, rays_d, z_vals, pe_w, L):
    """x0 (R*S, 3 + 6L) and xyz (R*S, 3), as xla_render_train_rays builds them."""
    R, S = z_vals.shape
    xyz = (rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]).reshape(R * S, 3)
    freq = 2.0 ** torch.arange(L, dtype=torch.float32, device=xyz.device) * math.pi
    sp = xyz[:, :, None] * freq  # (M, 3, L)
    enc = torch.stack([torch.sin(sp) * pe_w, torch.cos(sp) * pe_w], dim=-2)
    return torch.cat([xyz, enc.reshape(R * S, 6 * L)], dim=-1), xyz


def _deltas(z_vals: torch.Tensor) -> torch.Tensor:
    return torch.cat([z_vals[:, 1:] - z_vals[:, :-1], torch.full_like(z_vals[:, :1], LAST_DELTA)], -1)


def _cumprod_weights(alphas: torch.Tensor):
    """(transmittance, weights) by exclusive cumprod, as render/volume.py."""
    T = torch.cumprod(torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas[:, :-1]], -1), -1)
    return T, alphas * T


def render_train_plain(
    x0: torch.Tensor,  # (R*S, in0) PE rows, ray-major
    z_vals: torch.Tensor,  # (R, S)
    ray_cond: Optional[torch.Tensor],  # (R, HH) per-ray rgb conditioning incl. bias (use_rgb)
    trunk: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    heads: Dict[str, torch.Tensor],
    st: RTStatic,
    c_emb: Optional[torch.Tensor] = None,  # (R, C) candidate embedding (use_cand)
    save_res: bool = False,
):
    """Plain PyTorch forward from pre-built PE rows (xla_render_train; st.xyz_L
    is not read). Returns the outputs, and with save_res the residuals as a
    second dict."""
    prec = canonical_precision(st.precision)
    R, S = z_vals.shape
    ch = _walk_chain(x0, R, trunk, heads, st, ray_cond, c_emb)
    h = ch[f"act{st.D - 1}"]
    sig_s = softplus(matmul(h, heads["sigma_w"], prec) + heads["sigma_b"]).reshape(R, S)
    feat, rgb, sig_c, cfeat = ch.get("feat"), None, None, None
    if st.use_rgb:
        rgb = _stored(torch.sigmoid(matmul(ch["rgbh"], heads["rgb2_w"], prec) + heads["rgb2_b"]), st)
    if st.use_cand:
        sig_c = softplus(matmul(ch["h2"], heads["csig_w"], prec) + heads["csig_b"]).reshape(R, S)
        cfeat = matmul(ch["h2"], heads["cfeat_w"], prec) + heads["cfeat_b"]

    delta = _deltas(z_vals)
    a_s = 1.0 - torch.exp(-delta * sig_s)
    _, ow = _cumprod_weights(a_s)
    out = {"s_weights": ow, "s_depth": (ow * z_vals).sum(-1)}
    if st.use_rgb:
        out["rgb_map"] = (ow[..., None] * rgb.reshape(R, S, 3)).sum(1)
    if st.use_cand:
        a_c = 1.0 - torch.exp(-delta * sig_c)
        Tj, jw = _cumprod_weights(1.0 - torch.exp(-delta * (sig_s + sig_c)))
        sw, cw = a_s * Tj, a_c * Tj
        out["j_weights"] = jw
        out["c_depth"] = (jw * z_vals).sum(-1)
        out["t_weight"] = cw.sum(-1)
        if st.out_feat:
            fm = (sw[..., None] * _stored(feat, st).reshape(R, S, -1)).sum(1)
            out["feat_map"] = fm + (cw[..., None] * _stored(cfeat, st).reshape(R, S, -1)).sum(1)
    elif st.out_feat:
        out["feat_map"] = (ow[..., None] * _stored(feat, st).reshape(R, S, -1)).sum(1)
    out = {k: out[k] for k in st.out_keys}
    if not save_res:
        return out
    res = {"sig_s": sig_s, "sig_c": sig_c, "feat": feat, "cfeat": cfeat, "rgb": rgb}
    if st.save_chain:
        res["chain"] = torch.cat([ch[name] for name, _ in st.chain_cols(0, 0, 0)], dim=-1).to(_cdt(st))
    return out, {k: res[k].to(_store_dtype(st)) if k in ("feat", "cfeat") else res[k] for k in st.res_keys}


def render_train_rays_plain(
    rays_o: torch.Tensor,  # (R, 3)
    rays_d: torch.Tensor,  # (R, 3)
    z_vals: torch.Tensor,  # (R, S)
    pe_w: torch.Tensor,  # (L,) annealed band weights
    ray_cond: Optional[torch.Tensor],
    trunk: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    heads: Dict[str, torch.Tensor],
    st: RTStatic,
    c_emb: Optional[torch.Tensor] = None,
    save_res: bool = False,
):
    """Plain PyTorch forward from rays (xla_render_train_rays): the PE rows,
    then render_train_plain."""
    x0, _ = _pe(rays_o, rays_d, z_vals, pe_w, st.xyz_L)
    return render_train_plain(x0, z_vals, ray_cond, trunk, heads, st, c_emb=c_emb, save_res=save_res)


def _walk_chain(x0, R: int, trunk, heads, st: RTStatic, ray_cond, c_emb, feat=None) -> Dict[str, torch.Tensor]:
    """The forward's per-sample chain in f32, by the names of st.chain_cols:
    act0..act{D-1}, xyzf, rgbh (use_rgb), h1, h2 (use_cand), and feat
    (use_feat). feat: the stored residual that rgbh is rebuilt from (the
    recompute backward, pallas_render_train.py:468-490); None computes it
    from xyzf."""
    prec = canonical_precision(st.precision)
    h, ch = x0, {}
    for i, (w, b) in enumerate(trunk):
        if i in st.skips and i > 0:
            h = torch.cat([x0, h], dim=-1)
        h = torch.relu(matmul(h, w, prec) + b)
        ch[f"act{i}"] = h
    xyzf = ch["xyzf"] = matmul(h, heads["xyzf_w"], prec) + heads["xyzf_b"]
    if st.use_feat:
        ch["feat"] = matmul(xyzf, heads["feat_w"], prec) + heads["feat_b"] if feat is None else feat
    if st.use_rgb:
        pre = matmul(ch["feat"], heads["rgb1_w"], prec).reshape(R, -1, ray_cond.shape[1])
        ch["rgbh"] = torch.relu(pre + ray_cond[:, None, :]).reshape(xyzf.shape[0], -1)
    if st.use_cand:
        ray1 = matmul(c_emb, heads["c1c_w"], prec) + heads["c1_b"]
        pre1 = matmul(xyzf, heads["c1x_w"], prec).reshape(R, -1, ray1.shape[1])
        ch["h1"] = torch.relu(pre1 + ray1[:, None, :]).reshape(xyzf.shape[0], -1)
        ch["h2"] = torch.relu(matmul(ch["h1"], heads["c2_w"], prec) + heads["c2_b"])
    return ch


def _excl_prefix(x: torch.Tensor) -> torch.Tensor:
    """out[:, s] = sum_{t<s} x[:, t]."""
    return torch.cat([torch.zeros_like(x[:, :1]), torch.cumsum(x, -1)[:, :-1]], -1)


def _excl_suffix(x: torch.Tensor) -> torch.Tensor:
    """out[:, s] = sum_{t>s} x[:, t]."""
    return torch.flip(_excl_prefix(torch.flip(x, [-1])), [-1])


def composite_bwd_plain(z_vals, res: Dict[str, torch.Tensor], st: RTStatic, p, q, rr,
                        cots: Dict[str, Optional[torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The backward's compositing step, division-free (the JAX kernel's
    _composite; csrc/render_train_bwd.cu:pre_kernel): from the residual
    sigmas and the per-sample inner products p = <feat, g_feat>, q = <c_feat,
    g_feat> (out_feat; q with use_cand) and rr = <rgb, g_rgb_map> (use_rgb),
    None where the mode has none, the per-sample coefficients of the walk:
    g_spre (M, 1), g_cpre (M, 1; use_cand), the weights ow (the s-only
    branch's), cf and cg (R, S) that scale g_feat into feat's and c_feat's
    cotangents (out_feat; cg with use_cand), None where the mode has none."""
    R, S = z_vals.shape
    M = R * S
    f32 = z_vals.dtype

    def cot(k, shape):
        g = cots.get(k)
        return torch.zeros(shape, dtype=f32, device=z_vals.device) if g is None else g.to(f32)

    sig_s = res["sig_s"]
    delta = _deltas(z_vals)
    ds = delta * sig_s
    Ts = torch.exp(-_excl_prefix(ds))
    a_s = 1.0 - torch.exp(-ds)
    ow = a_s * Ts
    g_ow = cot("s_weights", (R, S)) + cot("s_depth", (R,))[:, None] * z_vals
    if st.use_rgb:
        g_ow = g_ow + rr
    if st.out_feat and not st.use_cand:
        g_ow = g_ow + p
    e_s = torch.exp(-ds)
    gsig_s = delta * (e_s * Ts * g_ow - _excl_suffix(g_ow * ow))
    cf = cg = g_cpre = None
    if st.use_cand:
        sig_c = res["sig_c"]
        dc = delta * sig_c
        Tj = torch.exp(-_excl_prefix(ds + dc))
        a_c = 1.0 - torch.exp(-dc)
        a_j = 1.0 - torch.exp(-(ds + dc))
        sw, cw, jw = a_s * Tj, a_c * Tj, a_j * Tj
        zero = torch.zeros_like(g_ow)
        g_sw = p if st.out_feat else zero
        g_cw = (q if st.out_feat else zero) + cot("t_weight", (R,))[:, None]
        g_jw = cot("j_weights", (R, S)) + cot("c_depth", (R,))[:, None] * z_vals
        sfx = _excl_suffix(g_sw * sw + g_cw * cw + g_jw * jw)
        e_c = torch.exp(-dc)
        e_j = e_s * e_c
        gsig_s = gsig_s + delta * (e_s * Tj * g_sw + e_j * Tj * g_jw - sfx)
        gsig_c = delta * (e_c * Tj * g_cw + e_j * Tj * g_jw - sfx)
        g_cpre = (gsig_c * (1.0 - torch.exp(-sig_c))).reshape(M, 1)
        if st.out_feat:
            cf, cg = sw, cw
    elif st.out_feat:
        cf = ow
    g_spre = (gsig_s * (1.0 - torch.exp(-sig_s))).reshape(M, 1)
    return {"g_spre": g_spre, "g_cpre": g_cpre, "ow": ow, "cf": cf, "cg": cg}


def _walk_setup(x0, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb, res, cots):
    """The walk's set-up: its chain by name (read from res, or rebuilt), feat
    (None where the walk reads none), the cotangents g_feat (out_feat) and
    g_rgb_map (use_rgb), and the compositing coefficients
    (composite_bwd_plain)."""
    R, S = z_vals.shape
    W = trunk[0][1].shape[0]
    HH = heads["rgb1_w"].shape[1] if st.use_rgb else 0
    HC = heads["c2_w"].shape[1] if st.use_cand else 0
    f32 = z_vals.dtype

    def dot(a, b):
        return matmul(a, b, canonical_precision(st.precision))

    def cot(k, shape):
        g = cots.get(k)
        return torch.zeros(shape, dtype=f32, device=z_vals.device) if g is None else g.to(f32)

    pg = st.param_grads
    cuts, col = {}, 0
    if "chain" in res:
        for name, w in st.chain_cols(W, HH, HC):
            cuts[name] = res["chain"][:, col : col + w].to(f32)
            col += w
    if st.save_chain:
        # feat feeds the feat_map inner products and rgb1's dW: without either, skip it
        need_feat = st.out_feat or (st.use_rgb and pg)
        feat = dot(cuts["xyzf"], heads["feat_w"]) + heads["feat_b"] if need_feat else None
        if st.out_feat and st.use_cand:
            cfeat = dot(cuts["h2"], heads["cfeat_w"]) + heads["cfeat_b"]
    else:
        feat = res["feat"].to(f32)
        if not cuts:
            cuts = _walk_chain(x0, R, trunk, heads, st, ray_cond, c_emb, feat=feat)
        if st.out_feat and st.use_cand:
            cfeat = res["cfeat"].to(f32)

    g_feat = cot("feat_map", (R, heads["feat_b"].shape[0])) if st.out_feat else None
    g_rgbm = cot("rgb_map", (R, 3)) if st.use_rgb else None
    p = q = rr = None
    if st.out_feat:
        p = (feat.reshape(R, S, -1) * g_feat[:, None, :]).sum(-1)
        if st.use_cand:
            q = (cfeat.reshape(R, S, -1) * g_feat[:, None, :]).sum(-1)
    if st.use_rgb:
        rr = (res["rgb"].reshape(R, S, 3) * g_rgbm[:, None, :]).sum(-1)
    return cuts, feat, g_feat, g_rgbm, composite_bwd_plain(z_vals, res, st, p, q, rr, cots)


def _bwd_walk_plain(
    x0, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb, res: Dict[str, torch.Tensor],
    cots: Dict[str, Optional[torch.Tensor]],
):
    """The backward's walk (render_train_bwd_plain without its weight
    gradients). In the recompute mode it reads the chain from res where res
    holds one (the recompute route's rebuilt chain), else it rebuilds it; p,
    q and rgb1's dW operand come from the stored feat / c_feat either way.
    Returns (d_x0, d_ray_cond or None, d_c_emb or None, ops):
    with st.param_grads, ops holds by name every operand of the weight
    gradients (dw_products, dw_biases), unrounded in the working float dtype:
    the X operands x0, act{i}, xyzf, rgbh, h1, h2, feat, c_emb and the
    cotangents g_act{i}, g_xyzf, g_spre, g_feat, g_rgbh, g_u, g_cfeat, g_cpre,
    g_h2, g_h1 (rows: samples) and ray_g1 (rows: rays); None in the frozen
    mode."""
    prec = canonical_precision(st.precision)
    R, S = z_vals.shape
    in0 = x0.shape[1]
    W = trunk[0][1].shape[0]
    M = R * S
    f32 = z_vals.dtype  # float32; float64 where the plain version serves as a float64 witness

    def dot(a, b):
        return matmul(a, b, prec)

    cuts, feat, g_feat, g_rgbm, comp = _walk_setup(x0, z_vals, ray_cond, trunk, heads, st, c_emb, res, cots)
    g_spre, g_cpre, ow, cf, cg = (comp[k] for k in ("g_spre", "g_cpre", "ow", "cf", "cg"))

    # reverse walk over the chain
    ops: Dict[str, torch.Tensor] = {"x0": x0, "feat": feat, "c_emb": c_emb, **cuts}
    g_xyzf = torch.zeros((M, W), dtype=f32, device=z_vals.device)
    g_f = None
    if st.out_feat:
        g_f = (cf[..., None] * g_feat[:, None, :]).reshape(M, -1)
    d_cond = d_cemb = None
    if st.use_rgb:
        g_rgb = (ow[..., None] * g_rgbm[:, None, :]).reshape(M, 3)
        rgb = res["rgb"]
        g_u = g_rgb * rgb * (1.0 - rgb)
        rgbh = cuts["rgbh"]
        g_rgbh = dot(g_u, heads["rgb2_w"].t()) * (rgbh > 0)
        ops.update(g_u=g_u, g_rgbh=g_rgbh)
        d_cond = g_rgbh.reshape(R, S, -1).sum(1)
        g_from_rgb = dot(g_rgbh, heads["rgb1_w"].t())
        g_f = g_from_rgb if g_f is None else g_f + g_from_rgb
    if st.use_feat:
        ops["g_feat"] = g_f
        g_xyzf = g_xyzf + dot(g_f, heads["feat_w"].t())
    if st.use_cand:
        h1, h2 = cuts["h1"], cuts["h2"]
        F = heads["cfeat_w"].shape[1]
        if st.out_feat:
            g_cf = (cg[..., None] * g_feat[:, None, :]).reshape(M, -1)
        else:
            g_cf = torch.zeros((M, F), dtype=f32, device=z_vals.device)
        g_h2 = dot(g_cf, heads["cfeat_w"].t())
        g_h2 = (g_h2 + g_cpre * heads["csig_w"].reshape(1, -1)) * (h2 > 0)
        g_h1 = dot(g_h2, heads["c2_w"].t()) * (h1 > 0)
        ray_g1 = g_h1.reshape(R, S, -1).sum(1)
        ops.update(g_cfeat=g_cf, g_cpre=g_cpre, g_h2=g_h2, g_h1=g_h1, ray_g1=ray_g1)
        d_cemb = dot(ray_g1, heads["c1c_w"].t())
        g_xyzf = g_xyzf + dot(g_h1, heads["c1x_w"].t())
    ops.update(g_spre=g_spre, g_xyzf=g_xyzf)
    g = g_spre * heads["sigma_w"].reshape(1, -1) + dot(g_xyzf, heads["xyzf_w"].t())

    dx0 = torch.zeros((M, in0), dtype=f32, device=z_vals.device)
    for i in reversed(range(st.D)):
        g = g * (cuts[f"act{i}"] > 0)
        ops[f"g_act{i}"] = g
        g_in = dot(g, trunk[i][0].t())
        if i in st.skips and i > 0:
            dx0 = dx0 + g_in[:, :in0]
            g = g_in[:, in0:]
        elif i == 0:
            dx0 = dx0 + g_in
        else:
            g = g_in

    return dx0, d_cond, d_cemb, ops if st.param_grads else None


# The Hopper walk of the bf16 backward (csrc/render_train_bwd.cu: pre_kernel, walk_kernel, finish_kernel).
WALK_TILE = 64  # samples a tile (wk::ROWS): a tile never spans two rays, a ray's last is ragged
WALK_COEF_W = 8  # a sample's coefficient row (wk::COEF_W): g_spre, g_cpre, cfw, cgw, g_u (3), 0
WALK_PART_W = 128 + 128 + 8  # a tile's partial sums (wk::PART_W): d_ray_cond, rayg1, d_rays_o, d_rays_d
WALK_MAX_CHUNKS = 256  # K-strips a tile streams at most (wk::MAX_CHUNKS)


def walk_coef_plain(x0, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb, res, cots) -> torch.Tensor:
    """The coefficient rows the Hopper walk's pre-pass writes, in plain
    PyTorch: (R*S, WALK_COEF_W) f32 of g_spre, g_cpre, cfw (g_feat's weight in
    feat's cotangent), cgw (in c_feat's), g_u = ow g_rgb_map rgb (1 - rgb)
    and a zero, each 0 where the mode has none."""
    R, S = z_vals.shape
    M = R * S
    _, _, _, g_rgbm, comp = _walk_setup(x0, z_vals, ray_cond, trunk, heads, st, c_emb, res, cots)
    out = torch.zeros((M, WALK_COEF_W), dtype=z_vals.dtype, device=z_vals.device)
    out[:, 0:1] = comp["g_spre"]
    if comp["g_cpre"] is not None:
        out[:, 1:2] = comp["g_cpre"]
    for col, k in ((2, "cf"), (3, "cg")):
        if comp[k] is not None:
            out[:, col] = comp[k].reshape(M)
    if st.use_rgb:
        rgb = res["rgb"]
        out[:, 4:7] = (comp["ow"][..., None] * g_rgbm[:, None, :]).reshape(M, 3) * rgb * (1.0 - rgb)
    return out


def walk_mask_plain(chain: torch.Tensor) -> torch.Tensor:
    """The ReLU mask words the Hopper walk's pre-pass packs from a chain (M,
    cw), in plain PyTorch: (M, cw / 32) int32, bit b of word w set where
    chain[:, 32 w + b] > 0."""
    bits = (chain.float() > 0).reshape(chain.shape[0], -1, 32).to(torch.int64)
    words = (bits << torch.arange(32, device=chain.device)).sum(-1)
    return (words - (words >= 2**31).to(torch.int64) * 2**32).to(torch.int32)


def walk_part_plain(ops: Dict[str, torch.Tensor], dx0, xyz, z_vals, pe_w, st: RTStatic) -> torch.Tensor:
    """The partial sums the Hopper walk writes a tile, in plain PyTorch, from
    _bwd_walk_plain's operands (the train mode's) and d_x0: (R ceil(S /
    WALK_TILE), WALK_PART_W) of the tile's sums of g_rgbh (d_ray_cond's),
    g_h1 (rayg1's) and, with the rays frontend, of the PE backward's d xyz
    and d xyz z (d_rays_o's, d_rays_d's), zero where the mode has none."""
    S = z_vals.shape[1]
    HH, HC = KERNEL_WIDTHS["HH"], KERNEL_WIDTHS["HC"]  # the row's sections (the kernel's widths)
    rows = torch.zeros((dx0.shape[0], WALK_PART_W), dtype=dx0.dtype, device=dx0.device)
    if st.use_rgb:
        rows[:, : ops["g_rgbh"].shape[1]] = ops["g_rgbh"]
    if st.use_cand:
        rows[:, HH : HH + ops["g_h1"].shape[1]] = ops["g_h1"]
    if xyz is not None:
        dxyz = _pe_bwd_rows(dx0, xyz, pe_w, st.xyz_L)
        rows[:, HH + HC : HH + HC + 3] = dxyz
        rows[:, HH + HC + 3 : HH + HC + 6] = dxyz * z_vals.reshape(-1, 1)
    return tile_sums_plain(rows, S)


def tile_sums_plain(x: torch.Tensor, S: int, tile: int = WALK_TILE) -> torch.Tensor:
    """(R*S, n) per-sample rows -> (R * ceil(S / tile), n): each tile's rows
    summed in sample order. A tile never spans two rays; a ray's last tile
    holds its remaining S mod tile samples."""
    R = x.shape[0] // S
    tpr = -(-S // tile)
    pad = torch.zeros((R, tpr * tile - S, x.shape[1]), dtype=x.dtype, device=x.device)
    return torch.cat([x.reshape(R, S, -1), pad], 1).reshape(R * tpr, tile, -1).sum(1)


def ray_sums_plain(rows: torch.Tensor, tpr: int) -> torch.Tensor:
    """(R * tpr, n) per-tile rows -> (R, n): each ray's tiles summed in tile
    order (the finishing pass, csrc/render_train_bwd.cu:finish_kernel)."""
    out = rows[0::tpr].clone()
    for k in range(1, tpr):
        out = out + rows[k::tpr]
    return out


def dw_products(st: RTStatic) -> Tuple[Tuple[str, Tuple[str, ...], str], ...]:
    """The backward's weight gradients as (name, X operands, G operand): the
    gradient is X^T G over the operands' rows (_bwd_walk_plain's names; the
    rows are samples, rays for c1c_w), with a skip layer's X [x0, act] side
    by side. In _dot's precision: bf16 operands, f32 sums."""
    out = []
    for i in range(st.D):
        xs = ("x0",) if i == 0 else (("x0", f"act{i - 1}") if i in st.skips else (f"act{i - 1}",))
        out.append((f"trunk{i}_w", xs, f"g_act{i}"))
    h = f"act{st.D - 1}"
    out += [("xyzf_w", (h,), "g_xyzf"), ("sigma_w", (h,), "g_spre")]
    if st.use_feat:
        out.append(("feat_w", ("xyzf",), "g_feat"))
    if st.use_rgb:
        out += [("rgb1_w", ("feat",), "g_rgbh"), ("rgb2_w", ("rgbh",), "g_u")]
    if st.use_cand:
        out += [("cfeat_w", ("h2",), "g_cfeat"), ("csig_w", ("h2",), "g_cpre"), ("c2_w", ("h1",), "g_h2"),
                ("c1x_w", ("xyzf",), "g_h1"), ("c1c_w", ("c_emb",), "ray_g1")]
    return tuple(out)


def dw_biases(st: RTStatic) -> Tuple[Tuple[str, str], ...]:
    """The backward's bias gradients as (name, G operand): the column sums of
    G over the samples, in f32 (unrounded)."""
    out = [(f"trunk{i}_b", f"g_act{i}") for i in range(st.D)] + [("xyzf_b", "g_xyzf"), ("sigma_b", "g_spre")]
    if st.use_feat:
        out.append(("feat_b", "g_feat"))
    if st.use_rgb:
        out.append(("rgb2_b", "g_u"))
    if st.use_cand:
        out += [("cfeat_b", "g_cfeat"), ("csig_b", "g_cpre"), ("c2_b", "g_h2"), ("c1_b", "g_h1")]
    return tuple(out)


def _split_grads(grads: Dict[str, torch.Tensor], st: RTStatic):
    """{name: grad} -> ([(dW, db)] per trunk layer, {head key: grad})."""
    dtrunk = [(grads[f"trunk{i}_w"], grads[f"trunk{i}_b"]) for i in range(st.D)]
    return dtrunk, {k: grads[k] for k in st.head_keys}


def render_train_bwd_plain(
    x0, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb, res: Dict[str, torch.Tensor],
    cots: Dict[str, Optional[torch.Tensor]],
):
    """Plain backward from pre-built PE rows x0 (R*S, in0):
    upnerf/ops/pallas_render_train.py:_bwd_kernel, written out step by step.
    With st.save_chain it reads the walk chain from res; without (the
    recompute mode, :883-890) it rebuilds the chain from x0, rgbh from the
    stored feat, and takes feat, c_feat and rgb from res.

    cots: a cotangent for each of st.out_keys (None means zero). Returns
    (d_x0 (R*S, in0), d_ray_cond or None, d_c_emb or None, [(dW, db)] per
    trunk layer, {head key: grad}), as _vjp_bwd (:1372); with st.param_grads
    off the weight gradients are not computed and the last two are None. In
    bf16 mode every product rounds both operands to bf16 and accumulates in
    f32, as the kernel's `_dot` does (x0 included); bias sums and the rank-1
    sigma terms stay f32."""
    dx0, d_cond, d_cemb, ops = _bwd_walk_plain(x0, z_vals, ray_cond, trunk, heads, st, c_emb, res, cots)
    if ops is None:
        return dx0, d_cond, d_cemb, None, None
    prec = canonical_precision(st.precision)
    grads = {}
    for name, xs, g in dw_products(st):
        x = ops[xs[0]] if len(xs) == 1 else torch.cat([ops[k] for k in xs], -1)
        grads[name] = matmul(x.t(), ops[g], prec)
    for name, g in dw_biases(st):
        grads[name] = ops[g].sum(0)
    return (dx0, d_cond, d_cemb, *_split_grads(grads, st))


def _pe_bwd_rows(dx0, xyz, pe_w, L: int):
    """The PE backward of each sample: d_x0 (M, 3 + 6L) -> d xyz (M, 3), with
    d sin(x f) = cos(x f) f dx and d cos(x f) = -sin(x f) f dx."""
    M = dx0.shape[0]
    freq = 2.0 ** torch.arange(L, dtype=dx0.dtype, device=dx0.device) * math.pi
    sp = xyz[:, :, None] * freq  # (M, 3, L)
    denc = dx0[:, 3:].reshape(M, 3, 2, L) * pe_w
    return dx0[:, :3] + (denc[:, :, 0] * torch.cos(sp) * freq - denc[:, :, 1] * torch.sin(sp) * freq).sum(-1)


def _pe_bwd(dx0, xyz, z_vals, pe_w, L: int):
    """The PE backward (pallas_render_train.py:_pe_backward, :1024-1031): d_x0
    (R*S, 3 + 6L) -> (d_rays_o, d_rays_d) (R, 3)."""
    R, S = z_vals.shape
    dxyz = _pe_bwd_rows(dx0, xyz, pe_w, L).reshape(R, S, 3)
    return dxyz.sum(1), (dxyz * z_vals[..., None]).sum(1)


def render_train_rays_bwd_plain(
    rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st: RTStatic, c_emb, res: Dict[str, torch.Tensor],
    cots: Dict[str, Optional[torch.Tensor]],
):
    """Plain backward from rays: render_train_bwd_plain on the PE rows, then
    the PE backward. Returns (d_rays_o, d_rays_d, d_ray_cond or None, d_c_emb
    or None, [(dW, db)] per trunk layer or None, {head key: grad} or None)."""
    x0, xyz = _pe(rays_o, rays_d, z_vals, pe_w, st.xyz_L)
    dx0, d_cond, d_cemb, dtrunk, dh = render_train_bwd_plain(x0, z_vals, ray_cond, trunk, heads, st, c_emb, res, cots)
    d_o, d_d = _pe_bwd(dx0, xyz, z_vals, pe_w, st.xyz_L)
    return d_o, d_d, d_cond, d_cemb, dtrunk, dh


# ---------------------------------------------------------------------------
# The bf16 train backward as two kernels: the walk stores the operands of the
# weight gradients into buffers laid out by dw_layout, then csrc/dw_gemm.cu
# (ops/dw_gemm.py) computes every dW = X^T G and db = sum G from them and the
# chain, per slab of rays, adding the slabs in order. In the recompute mode each
# slab's chain is first rebuilt by the forward kernel in its saved-chain mode.

SRC_CHAIN, SRC_OPS, SRC_RAY = 0, 1, 2  # dw_gemm's sources: the chain, the operand buffer, the per-ray operands
DW_BUFFER_BYTES = 1 << 30  # the operand buffers of one slab of rays, at most
REC_BUFFER_BYTES = 1 << 29  # the recompute mode: one slab's rebuilt chain and operand buffers, at most
MAX_D = 16  # trunk layers the kernels take
# The walk's layout slots (csrc/render_train_bwd.cu:Lay), in order: the buffers' row
# widths and the bias count; each operand's column in the operand buffer or the
# per-ray operands; each bias's offset in a ray's bias row; then per trunk layer
# (MAX_D of them) its cotangent's column, then its bias's offset. -1: not in the mode.
WALK_LAYOUT = ("ops_w", "ray_w", "nb", "x0", "feat", "g_u", "g_rgbh", "g_feat", "g_cfeat", "g_cpre", "g_h2", "g_h1",
               "g_spre", "g_xyzf", "ray_g1", "c_emb", "rgb2_b", "feat_b", "cfeat_b", "csig_b", "c2_b", "c1_b",
               "sigma_b", "xyzf_b")
NARROW = {"g_u": 0, "g_spre": 3, "g_cpre": 4}  # the 1- and 3-column cotangents share one column block


class DwLayout(NamedTuple):
    """The buffers the walk fills for dw_gemm (dw_layout) and the jobs that read them."""

    ops: Dict[str, int]  # operand -> its first column in the operand buffer (rows: samples)
    ops_w: int
    ray: Dict[str, int]  # operand -> its first column in the per-ray operands (rows: rays)
    ray_w: int
    bias: Dict[str, Tuple[int, int]]  # bias -> (offset, width) of its sum in a ray's f32 bias row
    nb: int
    outs: Dict[str, Tuple[int, Tuple[int, int]]]  # weight gradient -> (offset, padded shape) in the flat result
    n_dw: int  # weight floats of the flat result; the bias sums follow in bias-row order
    jobs: Tuple[dw_gemm.DwJob, ...]


def dw_layout(st: RTStatic, W: int, FP: int, HH: int, HC: int, C: int) -> DwLayout:
    """The column layout of the bf16 saved-chain train backward's dW operands
    for mode st (trunk width W, padded feature width FP, head widths HH, HC,
    candidate embedding width C), defined here once and passed to both
    kernels. The operand buffer holds, per sample, the X operands that are not
    in the saved chain (x0 at X0_PAD columns, feat at FP) and every cotangent
    G of dw_products, each at whole 64-column blocks (dw_gemm.BLOCK); g_u,
    g_spre and g_cpre share one block (NARROW). The per-ray operands hold
    ray_g1 and c_emb (zero-padded to a block); a ray's bias row the f32 sums
    over its samples of each bias's cotangent (dw_biases). The flat result
    holds each weight gradient in the kernels' padded layout (trunk x0 rows
    at X0_PAD, features at FP), then the biases."""
    blk = dw_gemm.BLOCK
    up = lambda n: -(-n // blk) * blk  # noqa: E731
    widths = {"x0": X0_PAD, "feat": FP, "g_xyzf": W, "g_feat": FP, "g_rgbh": HH, "g_cfeat": FP, "g_h2": HC,
              "g_h1": HC, "ray_g1": HC, "c_emb": C, "g_u": 3, "g_spre": 1, "g_cpre": 1,
              **{f"g_act{i}": W for i in range(st.D)}}
    names = ["x0"] + (["feat", "g_rgbh"] if st.use_rgb else []) + (["g_feat"] if st.use_feat else [])
    names += (["g_cfeat", "g_h2", "g_h1"] if st.use_cand else []) + ["g_xyzf"] + [f"g_act{i}" for i in range(st.D)]
    ops, col = {}, 0
    for name in names:
        ops[name] = col
        col += up(widths[name])
    present = {"g_u": st.use_rgb, "g_spre": True, "g_cpre": st.use_cand}
    ops.update({k: col + c for k, c in NARROW.items() if present[k]})
    ops_w = col + blk
    ray = {"ray_g1": 0, "c_emb": up(HC)} if st.use_cand else {}
    ray_w = up(HC) + blk if st.use_cand else 0
    bias, nb = {}, 0
    for name, g in dw_biases(st):
        bias[name] = (nb, widths[g])
        nb += widths[g]
    shapes = _head_shapes(W, FP, HH, HC, C)
    outs, n_dw = {}, 0
    for name, xs, _ in dw_products(st):
        if name.startswith("trunk"):
            shape = (X0_PAD * ("x0" in xs) + W * (len(xs) - ("x0" in xs)), W)
        else:
            shape = shapes[name]
        outs[name] = (n_dw, shape)
        n_dw += shape[0] * shape[1]
    chain, col = {}, 0
    for name, w in st.chain_cols(W, HH, HC):
        chain[name] = (SRC_CHAIN, col, w)
        col += w
    where = {**chain, "x0": (SRC_OPS, ops["x0"], X0_PAD), "c_emb": (SRC_RAY, ray.get("c_emb"), C)}
    if st.use_rgb:
        where["feat"] = (SRC_OPS, ops["feat"], FP)
    jobs = []
    for name, xs, g in dw_products(st):
        off, (_, ldo) = outs[name]
        if g in NARROW:
            g_src, g_col, g_cols, g0 = SRC_OPS, ops[g] - NARROW[g], blk, NARROW[g]
        else:
            g_src, g_col, g_cols, g0 = (SRC_RAY, ray[g], up(HC), 0) if g == "ray_g1" else (SRC_OPS, ops[g],
                                                                                         up(widths[g]), 0)
        row0 = 0
        for x in xs:
            x_src, x_col, x_w = where[x]
            jobs.append(dw_gemm.DwJob(x_src, x_col, up(x_w), g_src, g_col, g_cols, g0, widths[g], x_w,
                                      off + row0 * ldo, ldo))
            row0 += x_w
    return DwLayout(ops, ops_w, ray, ray_w, bias, nb, outs, n_dw, tuple(jobs))


def walk_layout(lay: DwLayout, st: RTStatic) -> list:
    """The walk's layout slots (WALK_LAYOUT, then the trunk's) of lay."""
    cols = {"ops_w": lay.ops_w, "ray_w": lay.ray_w, "nb": lay.nb, **lay.ops, **lay.ray,
            **{k: off for k, (off, _) in lay.bias.items()}}
    trunk_g = [lay.ops.get(f"g_act{i}", -1) for i in range(MAX_D)]
    trunk_b = [lay.bias[f"trunk{i}_b"][0] if i < st.D else -1 for i in range(MAX_D)]
    return [cols.get(k, -1) for k in WALK_LAYOUT] + trunk_g + trunk_b


def dw_slab_rays(lay: Optional[DwLayout], S: int, n_sm: int = 0, chain_bytes: int = 0, esize: int = 2) -> int:
    """Rays a slab of the backward, with operands of esize bytes (2 in
    bfloat16 mode, 4 in float32 mode). The saved chain's two-kernel train
    backward (chain_bytes 0): as many as keep the buffers of lay (operands,
    per-ray operands, bias rows) within DW_BUFFER_BYTES, rounded down to a
    multiple of n_sm (the card's SMs: the walk runs a block a ray) where that
    leaves one. The recompute mode (chain_bytes: the rebuilt chain's bytes a
    sample; lay None in the modes that store no operands): as many as keep the
    slab's chain and lay's buffers within REC_BUFFER_BYTES, rounded down to a
    multiple of n_sm, and to an even count (the forward pairs two rays in a
    tile at S <= 64), where that leaves one."""
    ops = 0 if lay is None else (S * lay.ops_w + lay.ray_w) * esize + lay.nb * 4
    if not chain_bytes:
        rays = max(1, DW_BUFFER_BYTES // ops)
        return rays - rays % n_sm if n_sm and rays >= n_sm else rays
    rays = max(1, REC_BUFFER_BYTES // (S * chain_bytes + ops))
    for step in (n_sm * (1 + n_sm % 2), 2):  # an even multiple of n_sm, else an even count
        if step and rays >= step:
            return rays - rays % step
    return rays


def dw_operands_plain(ops: Dict[str, torch.Tensor], lay: DwLayout, st: RTStatic, n: int, S: int, dtype,
                      tile: Optional[int] = None):
    """The walk's stores for n rays of S samples, in plain PyTorch: from
    _bwd_walk_plain's operands, the operand buffer (n S, lay.ops_w) and the
    per-ray operands (n, lay.ray_w) rounded to dtype (zero where no operand
    lies), and the f32 bias rows (n, lay.nb), or with tile a row a tile of
    that many samples (n ceil(S / tile), lay.nb: the Hopper walk's,
    tile_sums_plain)."""
    dev = ops["x0"].device
    buf = torch.zeros((n * S, lay.ops_w), dtype=dtype, device=dev)
    for name, col in lay.ops.items():
        buf[:, col : col + ops[name].shape[1]] = ops[name].to(dtype)
    ray = torch.zeros((n, lay.ray_w), dtype=dtype, device=dev) if lay.ray_w else None
    for name, col in lay.ray.items():
        ray[:, col : col + ops[name].shape[1]] = ops[name].to(dtype)
    rows = torch.zeros((n * (1 if tile is None else -(-S // tile)), lay.nb), dtype=torch.float32, device=dev)
    for name, g in dw_biases(st):
        off = lay.bias[name][0]
        sums = ops[g].reshape(n, S, -1).sum(1) if tile is None else tile_sums_plain(ops[g], S, tile)
        rows[:, off : off + ops[g].shape[1]] = sums
    return buf, ray, rows


def dw_result(flat: torch.Tensor, lay: DwLayout, st: RTStatic, in0: int, F: int):
    """The flat result of the two-kernel backward -> ([(dW, db)] per trunk
    layer, {head key: grad}) at the layer's and the heads' own widths (views)."""
    grads = {k: flat[off : off + r * c].view(r, c) for k, (off, (r, c)) in lay.outs.items()}
    grads.update({k: flat[lay.n_dw + off : lay.n_dw + off + w] for k, (off, w) in lay.bias.items()})
    grads.update({f"trunk{i}_w": unpad_trunk_grad(grads[f"trunk{i}_w"], i, st.skips, in0) for i in range(st.D)})
    dtrunk, dh = _split_grads(grads, st)
    return dtrunk, unpad_feat(dh, F)


def render_train_bwd_dw_plain(x0, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb, res, cots,
                              slab_rays: Optional[int] = None, flat_out: bool = False):
    """The backward as the CUDA route splits it, in plain PyTorch: per slab
    of slab_rays rays (dw_slab_rays by default), in the recompute mode
    (st.save_chain off) first the slab's chain rebuilt by the plain forward
    with save_chain on (render_train_plain); then the walk (_bwd_walk_plain,
    which in the recompute mode reads the stored feat / c_feat beside that
    chain); then, with st.param_grads, its stores into the operand buffers of
    dw_layout (dw_operands_plain; in bf16 mode a bias row a WALK_TILE-sample
    tile, as the Hopper walk writes them) and dw_gemm.dw_gemm_plain, which writes the
    slab's weight gradients and bias sums into a flat result, or adds them to
    it after the first slab. Returns as render_train_bwd_plain; with
    flat_out, also the flat result and the layout (None in the frozen mode)."""
    R, S = z_vals.shape
    dtype = _cdt(st)
    W, F = trunk[0][1].shape[0], heads["feat_b"].shape[0]
    HH = heads["rgb1_w"].shape[1] if st.use_rgb else 0
    HC = heads["c2_w"].shape[1] if st.use_cand else 0
    C = c_emb.shape[1] if st.use_cand else 0
    pg = st.param_grads
    lay = dw_layout(st, W, feat_pad(F, dtype == torch.bfloat16), HH, HC, C)
    chain_bytes = 0 if st.save_chain else sum(w for _, w in st.chain_cols(W, HH, HC)) * dtype.itemsize
    slab = slab_rays or (R if not (pg or chain_bytes) else dw_slab_rays(lay if pg else None, S, 0, chain_bytes,
                                                                        dtype.itemsize))
    flat = torch.empty((lay.n_dw + lay.nb,), dtype=torch.float32, device=z_vals.device) if pg else None
    dx0, d_cond, d_cemb = [], [], []
    for r0 in range(0, R, slab):
        r1 = min(R, r0 + slab)
        cut = lambda t, per=1: None if t is None else t[r0 * per : r1 * per]  # noqa: E731
        sres = {k: cut(v, S if k in ("rgb", "chain", "feat", "cfeat") else 1) for k, v in res.items()}
        if not st.save_chain:
            sres["chain"] = render_train_plain(cut(x0, S), cut(z_vals), cut(ray_cond), trunk, heads,
                                               st._replace(save_chain=True), c_emb=cut(c_emb), save_res=True)[1]["chain"]
        d, dc, de, ops = _bwd_walk_plain(cut(x0, S), cut(z_vals), cut(ray_cond), trunk, heads, st, cut(c_emb), sres,
                                         {k: cut(v) for k, v in cots.items()})
        if pg:
            buf, ray, rows = dw_operands_plain(ops, lay, st, r1 - r0, S, dtype,
                                               WALK_TILE if dtype == torch.bfloat16 else None)
            dw_gemm.dw_gemm_plain([sres["chain"], buf, ray], lay.jobs, flat, lay.n_dw, rows, r0 > 0)
        dx0.append(d)
        d_cond.append(dc)
        d_cemb.append(de)
    cat = lambda ts: None if ts[0] is None else torch.cat(ts)  # noqa: E731
    grads = dw_result(flat, lay, st, x0.shape[1], F) if pg else (None, None)
    out = (cat(dx0), cat(d_cond), cat(d_cemb), *grads)
    return (*out, flat, lay if pg else None) if flat_out else out


def render_train_rays_bwd_dw_plain(rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st: RTStatic, c_emb, res,
                                   cots, slab_rays: Optional[int] = None):
    """render_train_bwd_dw_plain behind the PE of the rays: returns as
    render_train_rays_bwd_plain."""
    x0, xyz = _pe(rays_o, rays_d, z_vals, pe_w, st.xyz_L)
    dx0, d_cond, d_cemb, dtrunk, dh = render_train_bwd_dw_plain(x0, z_vals, ray_cond, trunk, heads, st, c_emb, res,
                                                                cots, slab_rays)
    d_o, d_d = _pe_bwd(dx0, xyz, z_vals, pe_w, st.xyz_L)
    return d_o, d_d, d_cond, d_cemb, dtrunk, dh


def _require_recompute(st: RTStatic) -> None:
    if st.save_chain:
        raise ValueError("the recompute route runs with st.save_chain off")


def render_train_bwd_rec_plain(x0, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb, res, cots,
                               slab_rays: Optional[int] = None):
    """The recompute mode's backward (st.save_chain off; train or frozen) as
    its CUDA route runs it, in plain PyTorch: per slab, the chain rebuilt by
    the forward with save_chain on, the walk on it with the stored feat /
    c_feat, then the train mode's operand stores and dW sums
    (render_train_bwd_dw_plain). Returns as render_train_bwd_plain."""
    _require_recompute(st)
    return render_train_bwd_dw_plain(x0, z_vals, ray_cond, trunk, heads, st, c_emb, res, cots, slab_rays)


def render_train_rays_bwd_rec_plain(rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st: RTStatic, c_emb, res,
                                    cots, slab_rays: Optional[int] = None):
    """render_train_bwd_rec_plain behind the PE of the rays: returns as
    render_train_rays_bwd_plain."""
    _require_recompute(st)
    return render_train_rays_bwd_dw_plain(rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st, c_emb, res, cots,
                                          slab_rays)


# ---------------------------------------------------------------------------
# CUDA wrappers


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...], device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """(K, N) weight -> bf16 in the order mma.sync m16n8k16 reads B: per
    8-column tile nt and 16-deep k-step ks, lane g*4 + t holds
    W[ks*16 + 2t + {0, 1}, nt*8 + g] then W[ks*16 + 8 + 2t + {0, 1}, nt*8 + g],
    so one warp's fragment pair is 256 contiguous bytes."""
    K, N = w.shape
    wt = w.t().to(torch.bfloat16)  # (N, K): e indexes adjacent k
    return wt.reshape(N // 8, 8, K // 16, 2, 4, 2).permute(0, 2, 1, 4, 3, 5).contiguous()


def _pad_x0_rows(w: torch.Tensor, in0: int) -> torch.Tensor:
    """Zero rows after the in0 x0 rows of a layer-0 or skip weight, up to X0_PAD."""
    return torch.cat([w[:in0], w.new_zeros(X0_PAD - in0, w.shape[1]), w[in0:]], 0)


def unpad_trunk_grad(dw: torch.Tensor, i: int, skips, in0: int) -> torch.Tensor:
    """A trunk layer's weight gradient in the kernels' padded layout (x0 rows up
    to X0_PAD at layer 0 and the skip layers) -> the layer's (in, W)."""
    if i == 0:
        return dw[:in0]
    if i in skips:
        return torch.cat([dw[:in0], dw[X0_PAD:]], 0)
    return dw


def check_feat_width(F: int) -> None:
    if F not in KERNEL_F:
        raise ValueError(f"the CUDA kernels are built for feature widths {KERNEL_F}; got F = {F}")


def feat_pad(F: int, bf16: bool) -> int:
    """The kernels' width of the feature products for feature width F
    (render_common.cuh:feat_pad): F rounded up to 64 in bfloat16 mode (the
    tensor cores' column groups and k segments), to 128 in float32 mode (the
    SIMT lanes' column stride)."""
    m = 64 if bf16 else 128
    return -(-F // m) * m


# The feature dimension of each weight that has one, zero-padded to feat_pad.
FEAT_DIMS = {"feat_w": 1, "feat_b": 0, "rgb1_w": 0, "cfeat_w": 1, "cfeat_b": 0}


def pad_feat(heads: Dict[str, torch.Tensor], FP: int) -> Dict[str, torch.Tensor]:
    """heads with their feature dimension (FEAT_DIMS) zero-padded to FP."""
    out = {}
    for k, v in heads.items():
        d = FEAT_DIMS.get(k)
        if d is not None and v.shape[d] < FP:
            shape = list(v.shape)
            shape[d] = FP - v.shape[d]
            v = torch.cat([v, v.new_zeros(shape)], d)
        out[k] = v
    return out


def unpad_feat(grads: Dict[str, torch.Tensor], F: int) -> Dict[str, torch.Tensor]:
    """Weight gradients at the padded feature width -> F (views)."""
    return {k: v.narrow(FEAT_DIMS[k], 0, F) if k in FEAT_DIMS else v for k, v in grads.items()}


def pack_trunk_weight(w: torch.Tensor, in0: Optional[int]) -> torch.Tensor:
    """A trunk layer's (in, out) weight in the forward kernels' bf16 layout
    (the render's and the trunk kernel's): x0 rows padded to X0_PAD (in0
    given: layer 0 and the skip layers), packed by _pack_fragments."""
    return _pack_fragments(w if in0 is None else _pad_x0_rows(w, in0))


def _kernel_weights(trunk, heads: Dict[str, torch.Tensor], st: RTStatic, in0: Optional[int] = None):
    """Weights in the layout the forward kernel reads, each its own contiguous
    (so 16-byte aligned) tensor; the callers zero-pad the feature dimension
    to feat_pad first (pad_feat). float32 mode: every matrix (in, out), f32.
    bfloat16 mode: the trunk, xyzf, feat, rgb1, c1x, c2 and cfeat matrices
    packed by _pack_fragments, with the in0 x0 rows (3 + 6 st.xyz_L unless
    given) of layer 0 and of the skip layers zero-padded to X0_PAD; sigma,
    rgb2, csig and c1c (in, out) in bf16. Biases f32."""
    bf16 = canonical_precision(st.precision) == "bfloat16"
    if not bf16:
        return [(w.contiguous(), b.contiguous()) for w, b in trunk], {k: v.contiguous() for k, v in heads.items()}
    in0 = 3 + 6 * st.xyz_L if in0 is None else in0
    out = [(pack_trunk_weight(w, in0 if i == 0 or i in st.skips else None), b.contiguous())
           for i, (w, b) in enumerate(trunk)]
    kheads = {}
    for k, v in heads.items():
        if k in ("xyzf_w", "feat_w", "rgb1_w", "c1x_w", "c2_w", "cfeat_w"):
            v = _pack_fragments(v)
        elif k in ("sigma_w", "rgb2_w", "csig_w", "c1c_w"):
            v = v.to(torch.bfloat16)
        kheads[k] = v.contiguous()
    return out, kheads


# The Hopper forward (csrc/render_train_fwd.cu:wg_kernel): its tile and weight stream.
WG_NARROW = 8  # the narrow heads' columns (sigma, c_sigma, rgb), zero-padded: wgmma's smallest N
# Feature columns a pass of the feat / c_feat layers: the pass's accumulators and bf16
# columns fit the registers beside rgb1's, so F = 384 runs 6 passes, F = 32, 64 one.
WG_FEAT_BLOCK = 64
WG_HEADS = ("sigma_w", "csig_w", "rgb2_w")  # resident in each block, in this order, 256 x 8 then 128 x 8 twice
FWD_DESIGNS = ("wgmma", "mma_sync")
# The library of each forward design: the route's, and the timing variant of the design it replaced
# (_build.VARIANTS).
FWD_LIBS = {"wgmma": "render_train_fwd", "mma_sync": "render_train_fwd_mma_sync"}


def pack_wgmma(w: torch.Tensor, nb: int) -> torch.Tensor:
    """(K, N) weight, K a multiple of 64 and N of nb -> the flat K-strips (in w's
    dtype) that wgmma reads as a K-major B operand through a 128-byte-swizzle
    descriptor once they are bf16: for each block b of nb output columns (outer)
    and each 64-row K-strip ks (inner), the (nb, 64) transpose W[64 ks : 64 ks +
    64, nb b : nb b + nb]^T as nb rows of 64 elements (128 bytes), the 8-element
    (16-byte) chunk c of row n (its k = 8 c .. 8 c + 7) stored at chunk position
    c ^ (n % 8). Strip (b, ks) starts at element (b K / 64 + ks) 64 nb."""
    K, N = w.shape
    t = w.reshape(K // 64, 64, N // nb, nb).permute(2, 0, 3, 1)  # (b, ks, n, k)
    t = t.reshape(N // nb, K // 64, nb, 8, 8)  # k = 8 chunk + e
    n = torch.arange(nb, device=w.device)
    chunk = torch.arange(8, device=w.device)[None, :] ^ (n[:, None] % 8)  # position p holds chunk p ^ (n % 8)
    return t[:, :, n[:, None], chunk].reshape(-1).contiguous()


def _wgmma_matrices(st: RTStatic):
    """The matrices of the Hopper forward's stream, in order: (name, nb), where
    a name is ("trunk", i) or a head key."""
    FB = WG_FEAT_BLOCK
    mats = [(("trunk", i), 128) for i in range(st.D)] + [("xyzf_w", 128)]
    if st.use_cand:
        mats += [("c1x_w", 128), ("c2_w", 128)] + ([("cfeat_w", FB)] if st.out_feat else [])
    mats += [("feat_w", FB)] + ([("rgb1_w", 128)] if st.use_rgb else [])
    return mats


@functools.lru_cache(maxsize=64)
def _wgmma_plan(st: RTStatic, in0: int, shapes: Tuple[Tuple[str, Tuple[int, int]], ...]):
    """The gather that packs a mode's weights, and its schedule (wgmma_weights),
    from the matrices' shapes alone: (index, sched). index (int64, CPU) maps
    each packed element to its source in the flat concatenation [0, matrix of
    _wgmma_matrices ..., the narrow heads present ...] (0: a padded zero)."""
    W = KERNEL_WIDTHS["W"]
    shape = dict(shapes)
    src = {}  # name -> (K, N) tensor of source positions (1-based)
    at = 1
    for name, _ in shapes:
        K, N = shape[name]
        src[name] = torch.arange(at, at + K * N, dtype=torch.int64).reshape(K, N)
        at += K * N
    parts, sched = [], []
    size = 0  # elements so far

    def add(idx, nb) -> int:
        nonlocal size
        parts.append(pack_wgmma(idx, nb))
        size += parts[-1].numel()
        return size - parts[-1].numel()

    def strips(start, K, nb, blocks, kss):
        return [(2 * (start + (b * (K // 64) + ks) * 64 * nb), 128 * nb) for b in blocks for ks in kss]

    starts = {}
    for name, nb in _wgmma_matrices(st):
        idx = src[str(name)]
        if isinstance(name, tuple) and (name[1] == 0 or name[1] in st.skips):
            idx = _pad_x0_rows(idx, in0)
        starts[name] = (add(idx, nb), idx.shape[0], nb)
    FP = shape["feat_w"][1]
    FB = WG_FEAT_BLOCK
    for name, _ in _wgmma_matrices(st):
        start, K, nb = starts[name]
        if name in ("cfeat_w", "feat_w", "rgb1_w"):
            continue
        sched += strips(start, K, nb, range(shape[str(name)][1] // nb), range(K // 64))
        if name == "c2_w" and st.out_feat:
            start, K, nb = starts["cfeat_w"]
            sched += strips(start, K, nb, range(FP // FB), range(K // 64))
    for b in range(FP // FB):  # feat's pass b, then rgb1's K-strips of the pass's columns
        start, K, nb = starts["feat_w"]
        sched += strips(start, K, nb, [b], range(K // 64))
        if st.use_rgb:
            start, K, nb = starts["rgb1_w"]
            sched += strips(start, K, nb, [0], range(b * FB // 64, (b + 1) * FB // 64))
    narrow = []
    for k, K in zip(WG_HEADS, (W, 128, 128)):
        idx = src[k] if k in src else torch.zeros((K, 1), dtype=torch.int64)
        narrow.append(pack_wgmma(torch.cat([idx, idx.new_zeros(K, WG_NARROW - idx.shape[1])], 1), WG_NARROW))
    heads_off = 2 * size
    index = torch.cat(parts + narrow)
    return index, tuple(sched) + ((heads_off, 2 * sum(t.numel() for t in narrow)),)


_WG_INDEX: Dict[tuple, torch.Tensor] = {}  # _wgmma_plan's index on each device


def wgmma_weights(trunk, heads: Dict[str, torch.Tensor], st: RTStatic, in0: int):
    """The bf16 weights of the Hopper forward as one flat tensor, and the stream
    its producer copies for every tile. heads come zero-padded to FP (pad_feat).
    Every matrix is laid out by pack_wgmma, with the x0 rows of layer 0 and of
    the skip layers padded to X0_PAD: the trunk's, xyzf, c1x, c2 and rgb1 in
    blocks of 128 columns (a W-wide layer runs as two halves), feat and cfeat of
    WG_FEAT_BLOCK (a block is a pass), sigma, csig and rgb2 (WG_HEADS)
    zero-padded to WG_NARROW columns. Returns (flat, sched): sched lists (byte
    offset, bytes) of each K-strip (at most 16 KB) in the order a tile
    consumes it (one strip a stage of the kernel's ring): the trunk's layers
    and xyzf, each half by half, then with use_cand c1x, c2 and (out_feat)
    cfeat's passes, then feat's passes, each followed by rgb1's K-strips of the
    pass's columns (use_rgb); and last the 8 KB of the narrow heads, which every
    block keeps resident (absent heads as zeros). The layout is a gather planned
    once per mode and shapes (_wgmma_plan), so a call runs one concatenation,
    one gather and one rounding on the device."""
    tensors = {("trunk", i): w for i, (w, _) in enumerate(trunk)}
    tensors.update(heads)
    names = [name for name, _ in _wgmma_matrices(st)] + [k for k in WG_HEADS if k in heads]
    shapes = tuple((str(n), tuple(tensors[n].shape)) for n in names)
    index, sched = _wgmma_plan(st, in0, shapes)
    dev = heads["xyzf_w"].device
    key = (st, in0, shapes, dev)
    if key not in _WG_INDEX:
        _WG_INDEX[key] = index.to(dev)
    flat = torch.cat([heads["xyzf_w"].new_zeros(1)] + [tensors[n].reshape(-1) for n in names])
    return flat[_WG_INDEX[key]].to(torch.bfloat16), list(sched)


# The backward kernel's weight pointers, in order. "^T" marks a transpose; "rm" a
# row-major copy the kernel reads outside its products.
BWD_WEIGHTS = ("xyzf_w^T", "feat_w", "feat_w^T", "rgb1_w^T", "rgb2_w^T", "c1x_w^T", "c1c_w", "c2_w^T", "cfeat_w^T",
               "sigma_w", "csig_w", "feat_b", "cfeat_b", "feat_w rm", "cfeat_w^T rm")
_BWD_PRODUCT_WEIGHTS = ("xyzf_w^T", "feat_w", "feat_w^T", "rgb1_w^T", "c1x_w^T", "c2_w^T", "cfeat_w^T")


def _bwd_weights(trunk, heads: Dict[str, torch.Tensor], st: RTStatic, in0: int, design: str):
    """Weights in the layout the backward kernel reads: the trunk's
    transposes (out, in) with x0 padded to X0_PAD columns, BWD_WEIGHTS
    (None where the mode has no such head), their feature dimension
    zero-padded to feat_pad but for the "rm" copies. float32 mode: every
    matrix f32, row-major. bfloat16 mode: the matrices the walk's products
    read (the trunk's, and _BWD_PRODUCT_WEIGHTS) packed in fragment order for
    the tensor cores (the mma.sync design; None in the "wgmma" design, which
    streams them from _walk_wgmma_weights); rgb2_w^T, c1c_w and the "rm"
    copies row-major bf16. sigma_w and csig_w are f32 columns (the JAX kernel
    keeps them f32: they enter rank-1 terms, not products), the biases f32."""
    cdt = _cdt(st)
    packed = cdt == torch.bfloat16
    streamed = packed and design == "wgmma"
    padded = pad_feat(heads, feat_pad(heads["feat_b"].shape[0], packed))
    ptrunk = [_pad_x0_rows(w, in0) if i == 0 or i in st.skips else w for i, (w, _) in enumerate(trunk)]
    kt = [None if streamed else _pack_fragments(w.t()) if packed else w.t().contiguous() for w in ptrunk]
    out = []
    for name in BWD_WEIGHTS:
        key = name.split(" ")[0].removesuffix("^T")
        v = (heads if name.endswith(" rm") else padded).get(key) if key in st.head_keys else None
        if (name == "feat_w" and not st.param_grads) or (streamed and name in _BWD_PRODUCT_WEIGHTS):
            v = None  # feat_w: read only to re-derive feat for rgb1's dW
        if v is not None:
            if key in ("sigma_w", "csig_w"):
                v = v.reshape(-1)
            elif "_b" not in key:
                v = v.t() if "^T" in name else v
                v = _pack_fragments(v) if packed and name in _BWD_PRODUCT_WEIGHTS else v.to(cdt)
            v = v.contiguous()
        out.append(v)
    return kt, out


# The backward's bf16 designs: the route's Hopper walk, and for timing only the mma.sync walk it replaced
# (_build.VARIANTS), each in its library.
BWD_DESIGNS = ("wgmma", "mma_sync")
BWD_LIBS = {"wgmma": "render_train_bwd", "mma_sync": "render_train_bwd_mma_sync"}


@functools.lru_cache(maxsize=64)
def _walk_wgmma_plan(D: int, skips: Tuple[int, ...], in0: int, F: int, FP: int, rgb: bool, cand: bool,
                     feat_op: bool):
    """The gather that packs the Hopper walk's weights (bf16), its schedule
    and each K-strip's label, from the shapes alone: (index, sched, labels).
    index (int64, CPU) maps each packed element to its source in the flat
    concatenation [0, the trunk's weights, xyzf_w, feat_w, then rgb1_w
    (rgb), c1x_w, c2_w, cfeat_w (cand)] (0: a padded zero). Every product's
    B operand (K x N, the product g (64 x K) B) is laid out by pack_wgmma in
    blocks of nb columns. sched: (byte offset, bytes) of each K-strip in the
    order a consumer reads them (csrc/render_train_bwd.cu:wk_consume):
    feat_w in blocks of min(FP, 128) (feat_op: the train mode's re-derived
    feat, with the saved chain); rgb1_w^T in blocks of min(FP, 128) (rgb);
    cfeat_w^T and c2_w^T (cand); per half of W, feat_w^T and c1x_w^T
    (cand); xyzf_w^T by halves; then the trunk, last layer first, each layer's
    x0 columns (layer 0 and the skip layers, 64) before its other columns by
    halves. labels: (matrix, block, K-strip) of each sched entry."""
    W, HH, HC = KERNEL_WIDTHS["W"], KERNEL_WIDTHS["HH"], KERNEL_WIDTHS["HC"]
    sizes = [(f"t{i}", (in0 if i == 0 else (in0 + W if i in skips else W), W)) for i in range(D)]
    sizes += [("xyzf_w", (W, W)), ("feat_w", (W, F))]
    if rgb:
        sizes.append(("rgb1_w", (F, HH)))
    if cand:
        sizes += [("c1x_w", (W, HC)), ("c2_w", (HC, HC)), ("cfeat_w", (HC, F))]
    src, at = {}, 1
    for name, (k, n) in sizes:
        src[name] = torch.arange(at, at + k * n, dtype=torch.int64).reshape(k, n)
        at += k * n
    cols = lambda t, n: torch.cat([t, t.new_zeros(t.shape[0], n - t.shape[1])], 1)  # noqa: E731
    NB = min(FP, 128)
    mats = {}
    if feat_op:
        mats["feat_w"] = (cols(src["feat_w"], FP), NB)
    if cand:
        mats["cfeat_w^T"] = (cols(src["cfeat_w"], FP).t(), 128)
        mats["c2_w^T"] = (src["c2_w"].t(), 128)
    if rgb:
        mats["rgb1_w^T"] = (cols(src["rgb1_w"].t(), FP), NB)
    mats["feat_w^T"] = (cols(src["feat_w"], FP).t(), 128)
    if cand:
        mats["c1x_w^T"] = (src["c1x_w"].t(), 128)
    mats["xyzf_w^T"] = (src["xyzf_w"].t(), 128)
    for i in range(D):
        wt = (_pad_x0_rows(src[f"t{i}"], in0) if i == 0 or i in skips else src[f"t{i}"]).t()  # (W, in_pad)
        if i == 0 or i in skips:
            mats[f"trunk{i}_x0^T"] = (wt[:, :X0_PAD], 64)
        if i > 0:
            mats[f"trunk{i}^T"] = (wt[:, X0_PAD:] if i in skips else wt, 128)
    parts, start, size = [], {}, 0
    for name, (idx, nb) in mats.items():
        parts.append(pack_wgmma(idx.contiguous(), nb))
        start[name] = size
        size += parts[-1].numel()
    sched, labels = [], []

    def strips(name, blocks=None):
        idx, nb = mats[name]
        K = idx.shape[0]
        for b in range(idx.shape[1] // nb) if blocks is None else blocks:
            for ks in range(K // 64):
                sched.append((2 * (start[name] + (b * (K // 64) + ks) * 64 * nb), 128 * nb))
                labels.append((name, b, ks))

    for name in ("feat_w", "rgb1_w^T", "cfeat_w^T", "c2_w^T"):
        if name in mats:
            strips(name)
    for half in range(W // 128):
        strips("feat_w^T", [half])
        if cand:
            strips("c1x_w^T", [half])
    strips("xyzf_w^T")
    for i in reversed(range(D)):
        if i == 0 or i in skips:
            strips(f"trunk{i}_x0^T")
        if i > 0:
            strips(f"trunk{i}^T")
    return torch.cat(parts), tuple(sched), tuple(labels)


_WALK_INDEX: Dict[tuple, torch.Tensor] = {}  # _walk_wgmma_plan's index on each device


def _walk_wgmma_weights(trunk, heads: Dict[str, torch.Tensor], st: RTStatic, in0: int):
    """The bf16 weights of the Hopper walk for mode st as one flat tensor, and
    the schedule of K-strips its producer streams for every tile
    (_walk_wgmma_plan). A call runs one concatenation, one gather and one
    rounding on the device."""
    F = heads["feat_b"].shape[0]
    skips = tuple(i for i in st.skips if 0 < i < st.D)
    feat_op = st.param_grads and st.use_rgb and st.save_chain
    key = (st.D, skips, in0, F, feat_pad(F, True), st.use_rgb, st.use_cand, feat_op)
    index, sched, _ = _walk_wgmma_plan(*key)
    mats = [w for w, _ in trunk] + [heads["xyzf_w"], heads["feat_w"]]
    mats += [heads["rgb1_w"]] if st.use_rgb else []
    mats += [heads[k] for k in ("c1x_w", "c2_w", "cfeat_w")] if st.use_cand else []
    dev = heads["xyzf_w"].device
    if (key, dev) not in _WALK_INDEX:
        _WALK_INDEX[(key, dev)] = index.to(dev)
    flat = torch.cat([mats[0].new_zeros(1)] + [m.reshape(-1) for m in mats])
    return flat[_WALK_INDEX[(key, dev)]].to(torch.bfloat16), list(sched)


def _head_shapes(W, F, HH, HC, C):
    return {
        "xyzf_w": (W, W), "xyzf_b": (W,), "sigma_w": (W, 1), "sigma_b": (1,), "feat_w": (W, F), "feat_b": (F,),
        "rgb1_w": (F, HH), "rgb2_w": (HH, 3), "rgb2_b": (3,), "c1x_w": (W, HC), "c1c_w": (C, HC), "c1_b": (HC,),
        "c2_w": (HC, HC), "c2_b": (HC,), "csig_w": (HC, 1), "csig_b": (1,), "cfeat_w": (HC, F), "cfeat_b": (F,),
    }


def _check_kernel_args(front, in0: int, z_vals, ray_cond, c_emb, trunk, heads, st: RTStatic):
    """Device, dtype and shape checks of everything a kernel reads; front:
    {name: (tensor, shape)} of the frontend's inputs (the rays or x0), in0 the
    trunk's x0 width. Returns (R, S, C). Raises on what the kernels do not take."""
    dev = z_vals.device
    R, S = z_vals.shape
    D = len(trunk)
    if D != st.D:
        raise ValueError(f"trunk has {D} layers, st.D is {st.D}")
    if not st.use_feat:
        raise ValueError("the CUDA kernels need use_rgb or out_feat")
    W, HH, HC = KERNEL_WIDTHS["W"], KERNEL_WIDTHS["HH"], KERNEL_WIDTHS["HC"]
    F = heads["feat_b"].shape[0]
    check_feat_width(F)
    got = (trunk[0][1].shape[0], ray_cond.shape[1] if st.use_rgb else HH, heads["c2_b"].shape[0] if st.use_cand else HC)
    C = c_emb.shape[1] if st.use_cand else 0
    if got != (W, HH, HC) or not 0 < in0 <= X0_PAD or D > 16 or C > MAX_C:
        raise ValueError(
            f"the CUDA kernels take W=256, HH=128, HC=128, an x0 width of 1..64 (3 + 6L from rays), D <= 16,"
            f" C <= {MAX_C}; got {(*got, in0, D, C)}"
        )
    for name, (t, shape) in front.items():
        _check(name, t, shape, dev)
    _check("z_vals", z_vals, (R, S), dev)
    if st.use_rgb:
        _check("ray_cond", ray_cond, (R, HH), dev)
    if st.use_cand:
        _check("c_emb", c_emb, (R, C), dev)
    for i, (w, b) in enumerate(trunk):
        fan_in = in0 if i == 0 else (in0 + W if i in st.skips else W)
        _check(f"trunk[{i}].w", w, (fan_in, W), dev)
        _check(f"trunk[{i}].b", b, (W,), dev)
    shapes = _head_shapes(W, F, HH, HC, C)
    for k in st.head_keys:
        _check(k, heads[k], shapes[k], dev)
    return R, S, C


def _ptrs(ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(*[0 if t is None else t.data_ptr() for t in ts])


X0_IN = 128  # render_common.cuh:Flag: the kernels read pre-built PE rows x0 in place of building them
RECOMPUTE = 256  # render_common.cuh:Flag: the residuals without a chain, and the backward that recomputes it


def _flags(st: RTStatic, save_res: bool) -> int:
    bf16 = canonical_precision(st.precision) == "bfloat16"
    bits = (bf16, st.use_rgb, st.out_feat, st.use_cand, save_res, st.store_f32, not st.param_grads)
    return sum(int(b) << i for i, b in enumerate(bits)) + (RECOMPUTE if save_res and not st.save_chain else 0)


def _res_specs(st: RTStatic, R: int, S: int, F: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each residual in st.res_keys, as the kernels read and write them."""
    W, HH, HC = KERNEL_WIDTHS["W"], KERNEL_WIDTHS["HH"], KERNEL_WIDTHS["HC"]
    specs = {"sig_s": ((R, S), torch.float32), "sig_c": ((R, S), torch.float32), "rgb": ((R * S, 3), torch.float32),
             "feat": ((R * S, F), _store_dtype(st)), "cfeat": ((R * S, F), _store_dtype(st)),
             "chain": ((R * S, sum(w for _, w in st.chain_cols(W, HH, HC))), _cdt(st))}
    return {k: specs[k] for k in st.res_keys}


def _raise_on(code: int, name: str, lib) -> None:
    if code != 0:
        raise RuntimeError(f"{name} kernel failed ({code}): {lib.upnerf_error_string(code).decode()}")


def _refuse_grad(tensors, entry: str) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"the CUDA render kernel is forward-only: run it under torch.no_grad() or train through"
                           f" {entry}")


def _fwd_weights(trunk, heads, st: RTStatic, in0: int, design: str = "wgmma"):
    """The forward kernel's weights for mode st, packed once for any number
    of launches: (the packed stream or None, its schedule as the C ints and
    their pair count, the trunk's (W, b) pointers' tensors, the heads by
    key). design, one of FWD_DESIGNS, picks the bfloat16 kernel: "wgmma" (the
    route's), or, for timing only, the mma.sync design it replaced
    (_build.VARIANTS; the float32 kernel is the same in both)."""
    if design not in FWD_DESIGNS:
        raise ValueError(f"design must be one of {FWD_DESIGNS}, got {design!r}")
    bf16 = canonical_precision(st.precision) == "bfloat16"
    padded = pad_feat({k: heads[k] for k in st.head_keys}, feat_pad(heads["feat_b"].shape[0], bf16))
    wpack, sched = None, []
    if bf16 and design != "mma_sync":
        # the matrices in one packed stream; the kernel reads the biases and c1c (in, out) beside it
        wpack, sched = wgmma_weights(trunk, padded, st, in0)
        ktrunk = [(None, b.contiguous()) for _, b in trunk]
        kheads = {k: (v.to(torch.bfloat16) if k == "c1c_w" else v).contiguous() for k, v in padded.items()
                  if k == "c1c_w" or "_b" in k}
    else:
        ktrunk, kheads = _kernel_weights(trunk, padded, st, in0)
    sched_c = (ctypes.c_int * (2 * len(sched)))(*[v for pair in sched for v in pair])
    return wpack, sched_c, max(len(sched) - 1, 0), ktrunk, kheads


def _launch_fwd(ins, in0: int, L: int, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb, save_res: bool,
                x0_mode: bool, design: str = "wgmma", weights=None, chain: Optional[torch.Tensor] = None):
    """One launch of csrc/render_train_fwd.cu on checked arguments. ins:
    rays_o, rays_d, z_vals, pe_w, ray_cond, c_emb, x0 (None where the frontend
    has none). design: as _fwd_weights'; weights: _fwd_weights' result for
    this mode and design, packed here when None. chain: the tensor the chain
    residual is written into (st.save_chain; allocated here when None).
    Returns (outputs, residuals)."""
    from upnerf_torch.ops import _build

    R, S = z_vals.shape
    dev = z_vals.device
    C = c_emb.shape[1] if st.use_cand else 0
    ins = [t.contiguous() if t is not None else None for t in ins]
    F = heads["feat_b"].shape[0]
    wpack, sched_c, n_sched, ktrunk, kheads = weights or _fwd_weights(trunk, heads, st, in0, design)
    scratch = [None, None]
    if wpack is not None:
        # its x0 rows in bf16 from a scratch its first pass writes, and each sample's sigma, c_sigma and rgb in a
        # second (one spare ray: the second of the last pair where two rays share a tile and R is odd)
        scratch = [torch.empty((R * S, X0_PAD), dtype=torch.bfloat16, device=dev),
                   torch.empty((R + 1, 5 * S), dtype=torch.float32, device=dev)]
    f32 = dict(dtype=torch.float32, device=dev)
    out = {"s_weights": torch.empty((R, S), **f32), "s_depth": torch.empty((R,), **f32)}
    if st.use_rgb:
        out["rgb_map"] = torch.empty((R, 3), **f32)
    if st.out_feat:
        out["feat_map"] = torch.empty((R, F), **f32)
    if st.use_cand:
        out["j_weights"] = torch.empty((R, S), **f32)
        out["c_depth"] = torch.empty((R,), **f32)
        out["t_weight"] = torch.empty((R,), **f32)
    res = {}
    if save_res:
        res = {k: chain if k == "chain" and chain is not None else torch.empty(shape, dtype=dt, device=dev)
               for k, (shape, dt) in _res_specs(st, R, S, F).items()}
    out_order = ("s_weights", "s_depth", "rgb_map", "feat_map", "j_weights", "c_depth", "t_weight")
    outs = [out.get(k) for k in out_order] + [res.get(k) for k in RES_ORDER]
    lib = _build.library(FWD_LIBS[design])
    skip_mask = sum(1 << i for i in st.skips if 0 < i < st.D)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.upnerf_render_train_fwd(
            _ptrs(ins + scratch), _ptrs([w for w, _ in ktrunk]), _ptrs([b for _, b in ktrunk]), st.D, skip_mask,
            _ptrs([kheads.get(k) for k in HEAD_KEYS]), _ptrs(outs), R, S, L, in0, C, F,
            _flags(st, save_res) | (X0_IN if x0_mode else 0), None if wpack is None else wpack.data_ptr(), sched_c,
            n_sched, stream,
        )
    _raise_on(code, "render_train_fwd (x0 mode)" if x0_mode else "render_train_fwd", lib)
    return out, res


def render_train_rays_fwd(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: torch.Tensor,
    pe_w: torch.Tensor,
    ray_cond: Optional[torch.Tensor],
    trunk: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    heads: Dict[str, torch.Tensor],
    st: RTStatic,
    c_emb: Optional[torch.Tensor] = None,
    save_res: bool = False,
):
    """Forward render: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors; the same arguments either way, all f32. Returns the
    outputs, and with save_res the residuals the backward reads.

    The CUDA kernel takes the repo models' widths (W=256, F in KERNEL_F,
    HH=128, HC=128), 3 + 6L <= 64 and D <= 16. It computes no gradient: inputs that
    require grad are refused while grad mode is on (the training path goes
    through RenderTrainRays)."""
    if rays_o.device.type == "cpu":
        return render_train_rays_plain(rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st,
                                       c_emb=c_emb, save_res=save_res)
    if rays_o.device.type != "cuda":
        raise ValueError(f"no render kernel for device {rays_o.device}")
    global launches, recompute_launches
    R, S = z_vals.shape
    L = st.xyz_L
    front = {"rays_o": (rays_o, (R, 3)), "rays_d": (rays_d, (R, 3)), "pe_w": (pe_w, (L,))}
    _check_kernel_args(front, 3 + 6 * L, z_vals, ray_cond, c_emb, trunk, heads, st)
    _refuse_grad([rays_o, rays_d, z_vals, pe_w, ray_cond, c_emb, *heads.values()] + [t for wb in trunk for t in wb],
                 "RenderTrainRays")
    out, res = _launch_fwd([rays_o, rays_d, z_vals, pe_w, ray_cond, c_emb, None], 3 + 6 * L, L, z_vals, ray_cond,
                           trunk, heads, st, c_emb, save_res, False)
    if save_res and not st.save_chain:
        recompute_launches += 1
    else:
        launches += 1
    return (out, res) if save_res else out


def render_train_fwd(
    x0: torch.Tensor,
    z_vals: torch.Tensor,
    ray_cond: Optional[torch.Tensor],
    trunk: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    heads: Dict[str, torch.Tensor],
    st: RTStatic,
    c_emb: Optional[torch.Tensor] = None,
    save_res: bool = False,
):
    """Forward render from pre-built PE rows x0 (R*S, in0), every mode (the
    JAX package's fused_render_train): `render_train_plain` for CPU tensors,
    the X0_IN mode of the CUDA kernel for CUDA tensors (in0 <= 64, the widths
    of render_train_rays_fwd; st.xyz_L is not read). Counts its launches in
    `x0_launches`."""
    if x0.device.type == "cpu":
        return render_train_plain(x0, z_vals, ray_cond, trunk, heads, st, c_emb=c_emb, save_res=save_res)
    if x0.device.type != "cuda":
        raise ValueError(f"no render kernel for device {x0.device}")
    global x0_launches
    R, S = z_vals.shape
    in0 = x0.shape[1]
    _check_kernel_args({"x0": (x0, (R * S, in0))}, in0, z_vals, ray_cond, c_emb, trunk, heads, st)
    _refuse_grad([x0, z_vals, ray_cond, c_emb, *heads.values()] + [t for wb in trunk for t in wb], "RenderTrain")
    out, res = _launch_fwd([None, None, z_vals, None, ray_cond, c_emb, x0], in0, 0, z_vals, ray_cond, trunk, heads,
                           st, c_emb, save_res, True)
    x0_launches += 1
    return (out, res) if save_res else out


DW_OPS = 512  # render_common.cuh:Flag: the walk stores the weight gradients' operands for dw_gemm.cu
# Per-ray (1) or per-sample (S) rows of the backward's pointer lists, for cutting them into slabs of rays; None:
# not cut. ins (the backward's order: rays_o, rays_d, z_vals, pe_w, c_emb, ray_cond, x0), cots (all per ray),
# res (RES_ORDER), outs (d_rays_o, d_rays_d, d_ray_cond, d_c_emb, d_x0). _INS_ROWS also cuts the forward's ins.
_INS_ROWS = (1, 1, 1, None, 1, 1, "S")
_RES_ROWS = (1, 1, "S", "S", "S", "S")
_OUT_ROWS = (1, 1, 1, 1, "S")


def _cut(ts, rows, r0: int, r1: int, S: int) -> list:
    """The rows of rays [r0, r1) of each tensor of ts (rows as _INS_ROWS)."""
    return [t if t is None or per is None else t[r0 * (S if per == "S" else 1) : r1 * (S if per == "S" else 1)]
            for t, per in zip(ts, rows)]


class BwdLaunch:
    """One backward call of csrc/render_train_bwd.cu on checked arguments,
    prepared (weights, outputs, buffers) but not launched; `run()` launches
    it. ins as _launch_fwd's.

    The call runs per slab of `slab` rays. In the recompute mode (st.save_chain
    off) `rebuild(r0, r1)` first writes the slab's chain into a slab buffer
    with the forward kernel in its saved-chain residual mode (its weights
    packed once a call; counted in `rebuild_launches`), and the walk reads
    that chain with the stored feat / c_feat. `walk(r0, r1)` then walks the
    slab: in bfloat16 mode (design "wgmma", the route's) three launches, the
    compositing pre-pass, the Hopper walk over the packed weight stream
    (_walk_wgmma_weights, packed once a call) and the finishing pass of the
    per-ray sums (`pre`, `walk_tiles`, `finish`; counted in
    `walk_pre_launches`, `walk_launches`, `walk_finish_launches`); in float32
    mode, and in the mma.sync design that the Hopper walk replaced (design
    "mma_sync", a timing variant, _build.VARIANTS), one launch of the SIMT /
    mma.sync walk. In the train mode the walk (DW_OPS) stores the weight
    gradients' operands (dw_layout, in the compute dtype; bias rows a tile of
    WALK_TILE samples in the Hopper walk, a ray otherwise) and adds none, then
    `dw(r0, r1)` (dw_gemm) writes (first slab) or adds the slab's weight and
    bias gradients in a fixed order: no weight gradient is added with
    atomics, and two calls give the same bits. Slabs: with the saved chain,
    dw_slab_rays under DW_BUFFER_BYTES in the train mode and one slab in the
    frozen mode; in the recompute mode, dw_slab_rays of the rebuilt chain and
    the operand buffers under REC_BUFFER_BYTES. The frozen mode runs no dW
    kernel."""

    def __init__(self, ins, in0: int, L: int, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb, res, cots,
                 x0_mode: bool, design: str = "wgmma"):
        from upnerf_torch.ops import _build

        if design not in BWD_DESIGNS:
            raise ValueError(f"design must be one of {BWD_DESIGNS}, got {design!r}")
        R, S = z_vals.shape
        dev = z_vals.device
        C = c_emb.shape[1] if st.use_cand else 0
        W, HH, HC = (KERNEL_WIDTHS[k] for k in ("W", "HH", "HC"))
        F = heads["feat_b"].shape[0]
        cdt = _cdt(st)
        bf16 = cdt == torch.bfloat16
        self.wg = bf16 and design == "wgmma"
        FP = feat_pad(F, bf16)
        f32 = dict(dtype=torch.float32, device=dev)
        fwd_ins = [t.contiguous() if t is not None else None for t in ins]
        ins = [fwd_ins[i] for i in (0, 1, 2, 3, 5, 4, 6)]  # the backward reads c_emb before ray_cond
        cot_shapes = {"s_weights": (R, S), "s_depth": (R,), "rgb_map": (R, 3), "feat_map": (R, F),
                      "j_weights": (R, S), "c_depth": (R,), "t_weight": (R,)}
        cot_order = ("s_weights", "s_depth", "rgb_map", "feat_map", "j_weights", "c_depth", "t_weight")
        cot_list = []
        for k in cot_order:
            g = cots.get(k) if k in st.out_keys else None
            if g is not None:
                _check(f"cotangent {k}", g, cot_shapes[k], dev)
                g = g.contiguous()
            cot_list.append(g)
        for k, (shape, dt) in _res_specs(st, R, S, F).items():
            t = res[k]
            if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
                raise ValueError(f"residual {k}: {t.device} {t.dtype} {tuple(t.shape)}; st needs {dev} {dt} {shape}")
        res_list = [res[k].contiguous() if k in st.res_keys else None for k in RES_ORDER]
        kt, kw = _bwd_weights(trunk, heads, st, in0, design)
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        d_front = [torch.empty((R * S, in0), **f32)] if x0_mode else [torch.empty((R, 3), **f32),
                                                                      torch.empty((R, 3), **f32)]
        d_cond = torch.empty((R, HH), **f32) if st.use_rgb else None
        d_cemb = torch.empty((R, C), **f32) if st.use_cand else None
        self.rec = not st.save_chain
        self.stores = st.param_grads
        self.lay, layout, self.bufs = None, None, None
        if self.stores:
            self.lay = dw_layout(st, W, FP, HH, HC, C)
            layout = (ctypes.c_int * (len(WALK_LAYOUT) + 2 * MAX_D))(*walk_layout(self.lay, st))
        chain_w = sum(w for _, w in st.chain_cols(W, HH, HC))
        if self.rec:
            self.slab = min(R, dw_slab_rays(self.lay, S, n_sm, chain_w * cdt.itemsize, cdt.itemsize))
            # the rebuild: the forward in the saved-chain residual mode, its weights packed once, into a slab buffer
            self.fwd_st = st._replace(save_chain=True)
            self.fwd_w = _fwd_weights(trunk, heads, self.fwd_st, in0)
            self.chain = torch.empty((self.slab * S, chain_w), dtype=cdt, device=dev)
            self._fwd = (fwd_ins, trunk, heads)
        else:
            self.slab = min(R, dw_slab_rays(self.lay, S, n_sm, esize=cdt.itemsize)) if self.stores else R
        self.tpr = -(-S // WALK_TILE)
        tiles = self.slab * self.tpr + self.slab * self.tpr % 2  # the walk's work items are pairs of tiles
        if self.stores:
            n = self.slab
            self.bufs = (torch.empty((n * S, self.lay.ops_w), dtype=cdt, device=dev),
                         torch.empty((n, self.lay.ray_w), dtype=cdt, device=dev) if self.lay.ray_w else None,
                         torch.empty((tiles if self.wg else n, self.lay.nb), **f32))
            self.flat = torch.empty((self.lay.n_dw + self.lay.nb,), **f32)
        self.scratch, self.wpack, self.sched, self.n_sched = None, None, None, 0
        if self.wg:
            # the coefficient rows, the chain's mask words and the tiles' partial sums of one slab; the d h1 rows of
            # each block's two tiles (a block an SM)
            self.scratch = (torch.empty((self.slab * S, WALK_COEF_W), **f32),
                            torch.empty((self.slab * S, chain_w // 32), dtype=torch.int32, device=dev),
                            torch.empty((tiles, WALK_PART_W), **f32),
                            torch.empty((n_sm * 2 * WALK_TILE, HC), dtype=torch.bfloat16, device=dev))
            self.wpack, sched = _walk_wgmma_weights(trunk, heads, st, in0)
            self.sched = (ctypes.c_int * (2 * len(sched)))(*[v for pair in sched for v in pair])
            self.n_sched = len(sched)
        outs = [None, None, d_cond, d_cemb, d_front[0]] if x0_mode else [*d_front, d_cond, d_cemb, None]
        self.lib = _build.library(BWD_LIBS[design] if bf16 else "render_train_bwd")
        self.name = "render_train_bwd (x0 mode)" if x0_mode else "render_train_bwd"
        self.flags = _flags(st, True) | (X0_IN if x0_mode else 0) | (DW_OPS if self.stores else 0)
        self.skip_mask = sum(1 << i for i in st.skips if 0 < i < st.D)
        self._lists = (ins, cot_list, res_list, outs)
        self._slab_args = {}
        self._weights = (_ptrs(kt), _ptrs(kw))
        self._bufs = None if self.bufs is None else _ptrs(self.bufs)
        self._scratch = None if self.scratch is None else _ptrs(self.scratch)
        self._keep = (kt, kw)  # what the pointers point at
        self.layout = layout
        self.R, self.S, self.L, self.C, self.dev, self.st, self.in0, self.F = R, S, L, C, dev, st, in0, F
        self.x0_mode = x0_mode
        self.result = (d_front, d_cond, d_cemb)

    def rebuild(self, r0: int, r1: int) -> None:
        """The recompute mode: the chain of rays [r0, r1) into the slab
        buffer, by the forward kernel in its saved-chain residual mode (one
        launch; its outputs and other residuals are dropped)."""
        global rebuild_launches
        fwd_ins, trunk, heads = self._fwd
        ins = _cut(fwd_ins, _INS_ROWS, r0, r1, self.S)
        _launch_fwd(ins, self.in0, self.L, ins[2], ins[4], trunk, heads, self.fwd_st, ins[5], True, self.x0_mode,
                    weights=self.fwd_w, chain=self.chain[: (r1 - r0) * self.S])
        rebuild_launches += 1

    def _chain(self, r0: int, r1: int) -> torch.Tensor:
        """The chain of rays [r0, r1): the slab buffer's (the recompute mode), or the saved one's rows."""
        S = self.S
        return self.chain[: (r1 - r0) * S] if self.rec else self._lists[2][RES_ORDER.index("chain")][r0 * S : r1 * S]

    def _args(self, r0: int, r1: int):
        """The C pointer lists of rays [r0, r1), built once a slab (the Hopper design launches three kernels on
        them)."""
        if (r0, r1) not in self._slab_args:
            S = self.S
            ins, cot_list, res_list, outs = self._lists
            res = _cut(res_list, _RES_ROWS, r0, r1, S)
            res[RES_ORDER.index("chain")] = self._chain(r0, r1)
            self._slab_args[(r0, r1)] = (_ptrs(_cut(ins, _INS_ROWS, r0, r1, S)),
                                         _ptrs(_cut(cot_list, (1,) * 7, r0, r1, S)), _ptrs(res),
                                         _ptrs(_cut(outs, _OUT_ROWS, r0, r1, S)))
        return self._slab_args[(r0, r1)]

    def _wg(self, r0: int, r1: int, stage: int) -> None:
        """One launch of the Hopper design over rays [r0, r1): stage 0 the
        pre-pass, 1 the walk, 2 the finishing pass."""
        ins, cots, res, outs = self._args(r0, r1)
        stream = torch.cuda.current_stream(self.dev).cuda_stream
        with torch.cuda.device(self.dev):
            code = self.lib.upnerf_render_train_bwd_wg(
                ins, cots, res, self.st.D, self.skip_mask, self._weights[1], outs, self._bufs, self.layout,
                self._scratch, self.wpack.data_ptr(), self.sched, self.n_sched, r1 - r0, self.S, self.L, self.in0,
                self.C, self.F, self.flags, stage, stream,
            )
        _raise_on(code, f"{self.name} {('pre-pass', 'walk', 'finishing pass')[stage]}", self.lib)

    def pre(self, r0: int, r1: int) -> None:
        """The Hopper design's compositing pre-pass over rays [r0, r1): one launch."""
        global walk_pre_launches
        self._wg(r0, r1, 0)
        walk_pre_launches += 1

    def walk_tiles(self, r0: int, r1: int) -> None:
        """The Hopper walk over the tiles of rays [r0, r1): one launch (after `pre`)."""
        global walk_launches
        self._wg(r0, r1, 1)
        walk_launches += 1

    def finish(self, r0: int, r1: int) -> None:
        """The Hopper design's finishing pass over rays [r0, r1): one launch (after `walk_tiles`)."""
        global walk_finish_launches
        self._wg(r0, r1, 2)
        walk_finish_launches += 1

    def walk(self, r0: int, r1: int) -> None:
        """The walk over rays [r0, r1): the Hopper design's three launches, or one."""
        if self.wg:
            self.pre(r0, r1)
            self.walk_tiles(r0, r1)
            self.finish(r0, r1)
            return
        ins, cots, res, outs = self._args(r0, r1)
        stream = torch.cuda.current_stream(self.dev).cuda_stream
        with torch.cuda.device(self.dev):
            code = self.lib.upnerf_render_train_bwd(
                ins, cots, res, self._weights[0], self.st.D, self.skip_mask, self._weights[1], outs, self._bufs,
                self.layout, r1 - r0, self.S, self.L, self.in0, self.C, self.F, self.flags, stream,
            )
        _raise_on(code, self.name, self.lib)

    def dw(self, r0: int, r1: int) -> None:
        """dw_gemm on the operands the walk over rays [r0, r1) stored and on
        their chain: the slab's weight and bias gradients written into the
        flat result (r0 = 0) or added to it."""
        S, (ops, ray, rows) = self.S, self.bufs
        n = r1 - r0
        dw_gemm.dw_gemm([self._chain(r0, r1), ops[: n * S], None if ray is None else ray[:n]], self.lay.jobs,
                        self.flat, self.lay.n_dw, rows[: n * self.tpr if self.wg else n], r0 > 0)

    def run(self):
        """The whole call. Returns (d_front, d_ray_cond, d_c_emb, dtrunk,
        dheads): d_front is [d_x0] in the x0 mode, [d_rays_o, d_rays_d]
        otherwise; the last two None in the frozen mode."""
        for r0 in range(0, self.R, self.slab):
            r1 = min(self.R, r0 + self.slab)
            if self.rec:
                self.rebuild(r0, r1)
            self.walk(r0, r1)
            if self.stores:
                self.dw(r0, r1)
        d_front, d_cond, d_cemb = self.result
        if not self.st.param_grads:
            return d_front, d_cond, d_cemb, None, None
        return (d_front, d_cond, d_cemb, *dw_result(self.flat, self.lay, self.st, self.in0, self.F))


def _launch_bwd(ins, in0: int, L: int, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb, res, cots,
                x0_mode: bool):
    """One backward call of csrc/render_train_bwd.cu (and, in the recompute
    mode, csrc/render_train_fwd.cu's rebuilds; in the bf16 train mode
    csrc/dw_gemm.cu) on checked arguments: BwdLaunch's run()."""
    return BwdLaunch(ins, in0, L, z_vals, ray_cond, trunk, heads, st, c_emb, res, cots, x0_mode).run()


def render_train_rays_bwd_launch(rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st: RTStatic, c_emb, res,
                                 cots, design: str = "wgmma") -> BwdLaunch:
    """render_train_rays_bwd's CUDA call, checked and prepared but not
    launched: to time its pieces and, in bfloat16 mode, the two designs of
    BWD_DESIGNS (chip_smoke.py phases 9 and 12). Counts no call (its pieces
    count their own launches)."""
    R, S = z_vals.shape
    L = st.xyz_L
    front = {"rays_o": (rays_o, (R, 3)), "rays_d": (rays_d, (R, 3)), "pe_w": (pe_w, (L,))}
    _check_kernel_args(front, 3 + 6 * L, z_vals, ray_cond, c_emb, trunk, heads, st)
    return BwdLaunch([rays_o, rays_d, z_vals, pe_w, ray_cond, c_emb, None], 3 + 6 * L, L, z_vals, ray_cond, trunk,
                     heads, st, c_emb, res, cots, False, design)


def render_train_rays_bwd(rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st: RTStatic, c_emb, res, cots):
    """Backward render: `render_train_rays_bwd_plain` for CPU tensors, the
    CUDA kernels for CUDA tensors, with the same arguments and results.

    In the train mode, in both precisions, the call runs, per slab of rays
    (dw_slab_rays), the walk, which stores the weight gradients' operands
    (dw_layout), then the dW kernel (ops/dw_gemm.py), which sums them in a
    fixed order: two calls on the same inputs give the same bits. With
    st.param_grads off it computes the data cotangents only (the same bits as
    the train mode's) and returns None for the weight gradients. In the
    recompute mode (st.save_chain off) the forward kernel first rebuilds
    each slab's chain into a slab buffer (the slab's chain and operand
    buffers within REC_BUFFER_BYTES), and the walk reads it."""
    if rays_o.device.type == "cpu":
        return render_train_rays_bwd_plain(rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st, c_emb, res,
                                           cots)
    if rays_o.device.type != "cuda":
        raise ValueError(f"no render kernel for device {rays_o.device}")
    global bwd_launches, frozen_bwd_launches, recompute_bwd_launches, recompute_frozen_bwd_launches
    R, S = z_vals.shape
    L = st.xyz_L
    front = {"rays_o": (rays_o, (R, 3)), "rays_d": (rays_d, (R, 3)), "pe_w": (pe_w, (L,))}
    _check_kernel_args(front, 3 + 6 * L, z_vals, ray_cond, c_emb, trunk, heads, st)
    (d_o, d_d), d_cond, d_cemb, dtrunk, dh = _launch_bwd(
        [rays_o, rays_d, z_vals, pe_w, ray_cond, c_emb, None], 3 + 6 * L, L, z_vals, ray_cond, trunk, heads, st,
        c_emb, res, cots, False)
    if st.save_chain and st.param_grads:
        bwd_launches += 1
    elif st.save_chain:
        frozen_bwd_launches += 1
    elif st.param_grads:
        recompute_bwd_launches += 1
    else:
        recompute_frozen_bwd_launches += 1
    return d_o, d_d, d_cond, d_cemb, dtrunk, dh


def render_train_bwd(x0, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb, res, cots):
    """Backward render from pre-built PE rows (the JAX package's _vjp_bwd):
    `render_train_bwd_plain` for CPU tensors, the X0_IN mode of the CUDA
    kernel for CUDA tensors, in every mode of render_train_rays_bwd. Returns
    (d_x0 (R*S, in0), d_ray_cond, d_c_emb, dtrunk, dheads); the kernel writes
    each tile's d_x0 rows where the rays frontend runs the PE backward.
    Counts its launches in `x0_bwd_launches`."""
    if x0.device.type == "cpu":
        return render_train_bwd_plain(x0, z_vals, ray_cond, trunk, heads, st, c_emb, res, cots)
    if x0.device.type != "cuda":
        raise ValueError(f"no render kernel for device {x0.device}")
    global x0_bwd_launches
    R, S = z_vals.shape
    in0 = x0.shape[1]
    _check_kernel_args({"x0": (x0, (R * S, in0))}, in0, z_vals, ray_cond, c_emb, trunk, heads, st)
    (d_x0,), d_cond, d_cemb, dtrunk, dh = _launch_bwd([None, None, z_vals, None, ray_cond, c_emb, x0], in0, 0, z_vals,
                                                      ray_cond, trunk, heads, st, c_emb, res, cots, True)
    x0_bwd_launches += 1
    return d_x0, d_cond, d_cemb, dtrunk, dh


def _check_frozen(st: RTStatic, weights) -> None:
    if not st.param_grads and any(w.requires_grad for w in weights):
        raise RuntimeError("param_grads=False computes no weight gradient, but a weight requires grad:"
                           " freeze the model (requires_grad_(False)) or set param_grads=True")


def _weight_grads(st: RTStatic, names, heads, dtrunk, dh, nw: int):
    """The backward's weight gradients in the Functions' flat order (None for each in the frozen mode)."""
    if not st.param_grads:
        return [None] * nw
    return [t for wb in dtrunk for t in wb] + [dh[k].reshape(heads[k].shape) for k in names]


class RenderTrainRays(torch.autograd.Function):
    """Differentiable fused render of one pass (the JAX kernel's custom VJP).

    apply(rays_o, rays_d, z_vals, pe_w, ray_cond, c_emb, st, head_names,
    *trunk_flat, *head_tensors) -> the outputs in st.out_keys order."""

    @staticmethod
    def forward(ctx, rays_o, rays_d, z_vals, pe_w, ray_cond, c_emb, st, head_names, *weights):
        _check_frozen(st, weights)
        D = st.D
        trunk = [(weights[2 * i], weights[2 * i + 1]) for i in range(D)]
        heads = dict(zip(head_names, weights[2 * D :]))
        out, res = render_train_rays_fwd(rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st,
                                         c_emb=c_emb, save_res=True)
        ctx.st, ctx.head_names = st, head_names
        ctx.res_keys = tuple(res)
        ctx.save_for_backward(rays_o, rays_d, z_vals, pe_w, ray_cond, c_emb, *weights, *res.values())
        return tuple(out[k] for k in st.out_keys)

    @staticmethod
    def backward(ctx, *grads):
        st, names = ctx.st, ctx.head_names
        saved = ctx.saved_tensors
        rays_o, rays_d, z_vals, pe_w, ray_cond, c_emb = saved[:6]
        nw = 2 * st.D + len(names)
        weights = saved[6 : 6 + nw]
        res = dict(zip(ctx.res_keys, saved[6 + nw :]))
        trunk = [(weights[2 * i], weights[2 * i + 1]) for i in range(st.D)]
        heads = dict(zip(names, weights[2 * st.D :]))
        cots = dict(zip(st.out_keys, grads))
        d_o, d_d, d_cond, d_cemb, dtrunk, dh = render_train_rays_bwd(
            rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st, c_emb, res, cots
        )
        return (d_o, d_d, None, None, d_cond, d_cemb, None, None, *_weight_grads(st, names, heads, dtrunk, dh, nw))


def render_train_rays(rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st: RTStatic, c_emb=None):
    """Differentiable forward: the outputs dict, through RenderTrainRays."""
    names = st.head_keys
    flat = [t for wb in trunk for t in wb] + [heads[k] for k in names]
    outs = RenderTrainRays.apply(rays_o, rays_d, z_vals, pe_w, ray_cond, c_emb, st, names, *flat)
    return dict(zip(st.out_keys, outs))


class RenderTrain(torch.autograd.Function):
    """Differentiable fused render from pre-built PE rows (the JAX package's
    fused_render_train and its custom VJP, :1255 / :1372).

    apply(x0, z_vals, ray_cond, c_emb, st, head_names, *trunk_flat,
    *head_tensors) -> the outputs in st.out_keys order. Returns gradients for
    x0, ray_cond, c_emb and every weight (None for the weights with
    st.param_grads off), and None for z_vals."""

    @staticmethod
    def forward(ctx, x0, z_vals, ray_cond, c_emb, st, head_names, *weights):
        _check_frozen(st, weights)
        D = st.D
        trunk = [(weights[2 * i], weights[2 * i + 1]) for i in range(D)]
        heads = dict(zip(head_names, weights[2 * D :]))
        out, res = render_train_fwd(x0, z_vals, ray_cond, trunk, heads, st, c_emb=c_emb, save_res=True)
        ctx.st, ctx.head_names = st, head_names
        ctx.res_keys = tuple(res)
        ctx.save_for_backward(x0, z_vals, ray_cond, c_emb, *weights, *res.values())
        return tuple(out[k] for k in st.out_keys)

    @staticmethod
    def backward(ctx, *grads):
        st, names = ctx.st, ctx.head_names
        saved = ctx.saved_tensors
        x0, z_vals, ray_cond, c_emb = saved[:4]
        nw = 2 * st.D + len(names)
        weights = saved[4 : 4 + nw]
        res = dict(zip(ctx.res_keys, saved[4 + nw :]))
        trunk = [(weights[2 * i], weights[2 * i + 1]) for i in range(st.D)]
        heads = dict(zip(names, weights[2 * st.D :]))
        d_x0, d_cond, d_cemb, dtrunk, dh = render_train_bwd(x0, z_vals, ray_cond, trunk, heads, st, c_emb, res,
                                                            dict(zip(st.out_keys, grads)))
        return (d_x0, None, d_cond, d_cemb, None, None, *_weight_grads(st, names, heads, dtrunk, dh, nw))


def render_train(x0, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb=None):
    """Differentiable forward from PE rows x0 (R*S, in0): the outputs dict, through RenderTrain."""
    names = st.head_keys
    flat = [t for wb in trunk for t in wb] + [heads[k] for k in names]
    outs = RenderTrain.apply(x0, z_vals, ray_cond, c_emb, st, names, *flat)
    return dict(zip(st.out_keys, outs))
