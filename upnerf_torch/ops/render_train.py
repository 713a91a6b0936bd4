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
  bf16 saved-chain train backward as its CUDA route splits it: per slab of
  rays, the walk fills the dW operand buffers of `dw_layout`, then the plain
  dW (`dw_gemm.dw_gemm_plain`) adds the slab's weight and bias gradients.
- `render_train_rays_fwd` / `render_train_rays_bwd` and `render_train_fwd` /
  `render_train_bwd` are the wrappers of the two frontends: on CPU tensors
  they run the plain versions; on CUDA tensors they launch the hand-written
  kernels (`csrc/render_train_fwd.cu`, `csrc/render_train_bwd.cu`; the x0
  frontend is their X0_IN mode, any in0 <= 64; the bf16 saved-chain train
  backward also `csrc/dw_gemm.cu`, counted in `dw_gemm.dw_launches`) or
  raise. The rays frontend
  counts its launches in `launches`, `bwd_launches` and (the backward's
  frozen-model mode) `frozen_bwd_launches`; in the recompute mode, the
  forward with residuals and both backward modes in `recompute_launches`,
  `recompute_bwd_launches` and `recompute_frozen_bwd_launches` instead. The x0
  frontend counts every mode's in `x0_launches` and `x0_bwd_launches`.
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
# The forward-layout weights the recompute backward rebuilds the chain with (besides the trunk's).
RECOMPUTE_KEYS = ("xyzf_w", "xyzf_b", "rgb1_w", "c1x_w", "c1_b", "c2_w", "c2_b")
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
# Kernel launches made by render_train_fwd / render_train_bwd (the x0 frontend), in every mode.
x0_launches = 0
x0_bwd_launches = 0


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


def _bwd_walk_plain(
    x0, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb, res: Dict[str, torch.Tensor],
    cots: Dict[str, Optional[torch.Tensor]],
):
    """The backward's walk (render_train_bwd_plain without its weight
    gradients). Returns (d_x0, d_ray_cond or None, d_c_emb or None, ops):
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
    HH = heads["rgb1_w"].shape[1] if st.use_rgb else 0
    HC = heads["c2_w"].shape[1] if st.use_cand else 0
    M = R * S
    f32 = z_vals.dtype  # float32; float64 where the plain version serves as a float64 witness

    def dot(a, b):
        return matmul(a, b, prec)

    def cot(k, shape):
        g = cots.get(k)
        return torch.zeros(shape, dtype=f32, device=z_vals.device) if g is None else g.to(f32)

    pg = st.param_grads
    if st.save_chain:
        cuts, col = {}, 0
        for name, w in st.chain_cols(W, HH, HC):
            cuts[name] = res["chain"][:, col : col + w].to(f32)
            col += w
        # feat feeds the feat_map inner products and rgb1's dW: without either, skip it
        need_feat = st.out_feat or (st.use_rgb and pg)
        feat = dot(cuts["xyzf"], heads["feat_w"]) + heads["feat_b"] if need_feat else None
        if st.out_feat and st.use_cand:
            cfeat = dot(cuts["h2"], heads["cfeat_w"]) + heads["cfeat_b"]
    else:
        feat = res["feat"].to(f32)
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

    # compositing backward, division-free (the JAX kernel's _composite)
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
    cf = cg = None
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

    return dx0, d_cond, d_cemb, ops if pg else None


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


def _pe_bwd(dx0, xyz, z_vals, pe_w, L: int):
    """The PE backward (pallas_render_train.py:_pe_backward, :1024-1031): d_x0
    (R*S, 3 + 6L) -> (d_rays_o, d_rays_d) (R, 3), with d sin(x f) = cos(x f) f
    dx and d cos(x f) = -sin(x f) f dx."""
    R, S = z_vals.shape
    M = R * S
    freq = 2.0 ** torch.arange(L, dtype=dx0.dtype, device=dx0.device) * math.pi
    sp = xyz[:, :, None] * freq  # (M, 3, L)
    denc = dx0[:, 3:].reshape(M, 3, 2, L) * pe_w
    dxyz = dx0[:, :3] + (denc[:, :, 0] * torch.cos(sp) * freq - denc[:, :, 1] * torch.sin(sp) * freq).sum(-1)
    dxyz = dxyz.reshape(R, S, 3)
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
# The bf16 saved-chain train backward as two kernels: the walk stores the operands
# of the weight gradients into buffers laid out by dw_layout, then
# csrc/dw_gemm.cu (ops/dw_gemm.py) computes every dW = X^T G and db = sum G from
# them and the saved chain, per slab of rays, adding the slabs in order.

SRC_CHAIN, SRC_OPS, SRC_RAY = 0, 1, 2  # dw_gemm's sources: the saved chain, the operand buffer, the per-ray operands
DW_BUFFER_BYTES = 1 << 30  # the operand buffers of one slab of rays, at most
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


def dw_slab_rays(lay: DwLayout, S: int, n_sm: int = 0) -> int:
    """Rays a slab of the two-kernel backward: as many as keep its buffers
    (operands, per-ray operands, bias rows) within DW_BUFFER_BYTES, rounded
    down to a multiple of n_sm (the card's SMs: the walk runs a block a ray)
    where that leaves one."""
    rays = max(1, DW_BUFFER_BYTES // (S * lay.ops_w * 2 + lay.ray_w * 2 + lay.nb * 4))
    return rays - rays % n_sm if n_sm and rays >= n_sm else rays


def dw_operands_plain(ops: Dict[str, torch.Tensor], lay: DwLayout, st: RTStatic, n: int, S: int, dtype):
    """The walk's stores for n rays of S samples, in plain PyTorch: from
    _bwd_walk_plain's operands, the operand buffer (n S, lay.ops_w) and the
    per-ray operands (n, lay.ray_w) rounded to dtype (zero where no operand
    lies), and the f32 bias rows (n, lay.nb)."""
    dev = ops["x0"].device
    buf = torch.zeros((n * S, lay.ops_w), dtype=dtype, device=dev)
    for name, col in lay.ops.items():
        buf[:, col : col + ops[name].shape[1]] = ops[name].to(dtype)
    ray = torch.zeros((n, lay.ray_w), dtype=dtype, device=dev) if lay.ray_w else None
    for name, col in lay.ray.items():
        ray[:, col : col + ops[name].shape[1]] = ops[name].to(dtype)
    rows = torch.zeros((n, lay.nb), dtype=torch.float32, device=dev)
    for name, g in dw_biases(st):
        off = lay.bias[name][0]
        rows[:, off : off + ops[g].shape[1]] = ops[g].reshape(n, S, -1).sum(1)
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
    """The train backward (st.param_grads, st.save_chain) as the CUDA route
    splits it, in plain PyTorch: per slab of slab_rays rays (dw_slab_rays by
    default), the walk (_bwd_walk_plain) fills the operand buffers of
    dw_layout (dw_operands_plain), then dw_gemm.dw_gemm_plain writes the
    slab's weight gradients and bias sums into a flat result, or adds them to
    it after the first slab. Returns as render_train_bwd_plain; with flat_out,
    also the flat result and the layout."""
    R, S = z_vals.shape
    dtype = _cdt(st)
    W, F = trunk[0][1].shape[0], heads["feat_b"].shape[0]
    HH = heads["rgb1_w"].shape[1] if st.use_rgb else 0
    HC = heads["c2_w"].shape[1] if st.use_cand else 0
    C = c_emb.shape[1] if st.use_cand else 0
    lay = dw_layout(st, W, feat_pad(F, dtype == torch.bfloat16), HH, HC, C)
    slab = slab_rays or dw_slab_rays(lay, S)
    flat = torch.empty((lay.n_dw + lay.nb,), dtype=torch.float32, device=z_vals.device)
    dx0, d_cond, d_cemb = [], [], []
    for r0 in range(0, R, slab):
        r1 = min(R, r0 + slab)
        cut = lambda t, per=1: None if t is None else t[r0 * per : r1 * per]  # noqa: E731
        sres = {k: cut(v, S if k in ("rgb", "chain") else 1) for k, v in res.items()}
        d, dc, de, ops = _bwd_walk_plain(cut(x0, S), cut(z_vals), cut(ray_cond), trunk, heads, st, cut(c_emb), sres,
                                         {k: cut(v) for k, v in cots.items()})
        buf, ray, rows = dw_operands_plain(ops, lay, st, r1 - r0, S, dtype)
        dw_gemm.dw_gemm_plain([sres["chain"], buf, ray], lay.jobs, flat, lay.n_dw, rows, r0 > 0)
        dx0.append(d)
        d_cond.append(dc)
        d_cemb.append(de)
    cat = lambda ts: None if ts[0] is None else torch.cat(ts)  # noqa: E731
    out = (cat(dx0), cat(d_cond), cat(d_cemb), *dw_result(flat, lay, st, x0.shape[1], F))
    return (*out, flat, lay) if flat_out else out


def render_train_rays_bwd_dw_plain(rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st: RTStatic, c_emb, res,
                                   cots, slab_rays: Optional[int] = None):
    """render_train_bwd_dw_plain behind the PE of the rays: returns as
    render_train_rays_bwd_plain."""
    x0, xyz = _pe(rays_o, rays_d, z_vals, pe_w, st.xyz_L)
    dx0, d_cond, d_cemb, dtrunk, dh = render_train_bwd_dw_plain(x0, z_vals, ray_cond, trunk, heads, st, c_emb, res,
                                                                cots, slab_rays)
    d_o, d_d = _pe_bwd(dx0, xyz, z_vals, pe_w, st.xyz_L)
    return d_o, d_d, d_cond, d_cemb, dtrunk, dh


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


# The backward kernel's weight pointers, in order. "^T" marks a transpose; "rm" a
# row-major copy the kernel reads outside its products.
BWD_WEIGHTS = ("xyzf_w^T", "feat_w", "feat_w^T", "rgb1_w^T", "rgb2_w^T", "c1x_w^T", "c1c_w", "c2_w^T", "cfeat_w^T",
               "sigma_w", "csig_w", "feat_b", "cfeat_b", "feat_w rm", "cfeat_w^T rm")
_BWD_PRODUCT_WEIGHTS = ("xyzf_w^T", "feat_w", "feat_w^T", "rgb1_w^T", "c1x_w^T", "c2_w^T", "cfeat_w^T")


def _bwd_weights(trunk, heads: Dict[str, torch.Tensor], st: RTStatic, in0: int):
    """Weights in the layout the backward kernel reads: the trunk's
    transposes (out, in) with x0 padded to X0_PAD columns, BWD_WEIGHTS
    (None where the mode has no such head), their feature dimension
    zero-padded to feat_pad but for the "rm" copies. float32 mode: every
    matrix f32, row-major. bfloat16 mode: the matrices the walk's products
    read (the trunk's, and _BWD_PRODUCT_WEIGHTS) packed in fragment order for
    the tensor cores; rgb2_w^T, c1c_w and the "rm" copies row-major bf16.
    sigma_w and csig_w are f32 columns (the JAX kernel keeps them f32: they
    enter rank-1 terms, not products), the biases f32. Also returns the
    trunk's (in, out) weights with the in0 x0 rows padded to X0_PAD."""
    cdt = _cdt(st)
    packed = cdt == torch.bfloat16
    padded = pad_feat(heads, feat_pad(heads["feat_b"].shape[0], packed))
    ptrunk = [_pad_x0_rows(w, in0) if i == 0 or i in st.skips else w for i, (w, _) in enumerate(trunk)]
    kt = [_pack_fragments(w.t()) if packed else w.t().contiguous() for w in ptrunk]
    out = []
    for name in BWD_WEIGHTS:
        key = name.split(" ")[0].removesuffix("^T")
        v = (heads if name.endswith(" rm") else padded).get(key) if key in st.head_keys else None
        if name == "feat_w" and not st.param_grads:
            v = None  # read only to re-derive feat for rgb1's dW
        if v is not None:
            if key in ("sigma_w", "csig_w"):
                v = v.reshape(-1)
            elif "_b" not in key:
                v = v.t() if "^T" in name else v
                v = _pack_fragments(v) if packed and name in _BWD_PRODUCT_WEIGHTS else v.to(cdt)
            v = v.contiguous()
        out.append(v)
    return kt, out, ptrunk


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


def _launch_fwd(ins, in0: int, L: int, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb, save_res: bool,
                x0_mode: bool):
    """One launch of csrc/render_train_fwd.cu on checked arguments. ins:
    rays_o, rays_d, z_vals, pe_w, ray_cond, c_emb, x0 (None where the frontend
    has none). Returns (outputs, residuals)."""
    from upnerf_torch.ops import _build

    R, S = z_vals.shape
    dev = z_vals.device
    C = c_emb.shape[1] if st.use_cand else 0
    ins = [t.contiguous() if t is not None else None for t in ins]
    F = heads["feat_b"].shape[0]
    FP = feat_pad(F, canonical_precision(st.precision) == "bfloat16")
    ktrunk, kheads = _kernel_weights(trunk, pad_feat({k: heads[k] for k in st.head_keys}, FP), st, in0)
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
        res = {k: torch.empty(shape, dtype=dt, device=dev) for k, (shape, dt) in _res_specs(st, R, S, F).items()}
    out_order = ("s_weights", "s_depth", "rgb_map", "feat_map", "j_weights", "c_depth", "t_weight")
    outs = [out.get(k) for k in out_order] + [res.get(k) for k in RES_ORDER]
    lib = _build.library("render_train_fwd")
    skip_mask = sum(1 << i for i in st.skips if 0 < i < st.D)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.upnerf_render_train_fwd(
            _ptrs(ins), _ptrs([w for w, _ in ktrunk]), _ptrs([b for _, b in ktrunk]), st.D, skip_mask,
            _ptrs([kheads.get(k) for k in HEAD_KEYS]), _ptrs(outs), R, S, L, in0, C, F,
            _flags(st, save_res) | (X0_IN if x0_mode else 0), stream,
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
BWD_DESIGNS = ("stores", "adds", "no_adds")
# Per-ray (1) or per-sample (S) rows of the backward's pointer lists, for cutting them into slabs of rays; None:
# not cut. ins (the backward's order: rays_o, rays_d, z_vals, pe_w, c_emb, ray_cond, x0), cots (all per ray),
# res (RES_ORDER), outs (d_rays_o, d_rays_d, d_ray_cond, d_c_emb, d_x0).
_INS_ROWS = (1, 1, 1, None, 1, 1, "S")
_RES_ROWS = (1, 1, "S", "S", "S", "S")
_OUT_ROWS = (1, 1, 1, 1, "S")


class BwdLaunch:
    """One backward call of csrc/render_train_bwd.cu on checked arguments,
    prepared (weights, outputs, buffers) but not launched; `run()` launches
    it. ins as _launch_fwd's.

    In the bf16 saved-chain train mode (design "stores", the port's) the call
    runs per slab of `slab` rays (dw_slab_rays): the walk with DW_OPS, which
    stores the weight gradients' operands (dw_layout) and adds none, then
    dw_gemm on them, which writes (first slab) or adds the slab's weight and
    bias gradients in a fixed order. `walk(r0, r1)` and `dw(r0, r1)` launch
    one slab's kernels on their own, for timing. Designs "adds" and "no_adds"
    run that mode as the walk did before the dW kernel, one launch that adds
    every gradient with atomics, and the same built without the adds
    (_build.VARIANTS): timing only (chip_smoke.py phase 9). The float32, the
    recompute and the frozen modes run one launch in every design."""

    def __init__(self, ins, in0: int, L: int, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb, res, cots,
                 x0_mode: bool, design: str = "stores"):
        from upnerf_torch.ops import _build

        if design not in BWD_DESIGNS:
            raise ValueError(f"design must be one of {BWD_DESIGNS}, got {design!r}")
        R, S = z_vals.shape
        dev = z_vals.device
        C = c_emb.shape[1] if st.use_cand else 0
        W, HH, HC = (KERNEL_WIDTHS[k] for k in ("W", "HH", "HC"))
        F = heads["feat_b"].shape[0]
        bf16 = _cdt(st) == torch.bfloat16
        FP = feat_pad(F, bf16)
        f32 = dict(dtype=torch.float32, device=dev)
        ins = [t.contiguous() if t is not None else None for t in ins]
        ins = [ins[i] for i in (0, 1, 2, 3, 5, 4, 6)]  # the backward reads c_emb before ray_cond
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
        kt, kw, padded = _bwd_weights(trunk, heads, st, in0)
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        self.grid, tw, tb, fw, scratch = None, None, None, None, None
        if not st.save_chain:
            # the recompute's forward-layout weights, and a scratch of 32 chain rows a persistent block
            tw = [_pack_fragments(w) if bf16 else w.contiguous() for w in padded]
            tb = [b.contiguous() for _, b in trunk]
            _, kh = _kernel_weights([], pad_feat({k: heads[k] for k in RECOMPUTE_KEYS if k in st.head_keys}, FP), st,
                                    in0)
            fw = [kh.get(k) for k in RECOMPUTE_KEYS]
            self.grid = min(R, n_sm)
            chain_w = sum(w for _, w in st.chain_cols(W, HH, HC))
            scratch = torch.empty((self.grid * 32 * chain_w,), dtype=_cdt(st), device=dev)
        d_front = [torch.empty((R * S, in0), **f32)] if x0_mode else [torch.empty((R, 3), **f32),
                                                                      torch.empty((R, 3), **f32)]
        d_cond = torch.empty((R, HH), **f32) if st.use_rgb else None
        d_cemb = torch.empty((R, C), **f32) if st.use_cand else None
        self.stores = st.param_grads and st.save_chain and bf16 and design == "stores"
        dtw, dtb, dhd = [None] * st.D, [None] * st.D, {}
        self.slab, self.lay, layout, self.bufs = R, None, None, None
        if self.stores:
            self.lay = dw_layout(st, W, FP, HH, HC, C)
            self.slab = min(R, dw_slab_rays(self.lay, S, n_sm))
            n = self.slab
            self.bufs = (torch.empty((n * S, self.lay.ops_w), dtype=torch.bfloat16, device=dev),
                         torch.empty((n, self.lay.ray_w), dtype=torch.bfloat16, device=dev) if self.lay.ray_w else None,
                         torch.empty((n, self.lay.nb), **f32))
            self.flat = torch.empty((self.lay.n_dw + self.lay.nb,), **f32)
            layout = (ctypes.c_int * (len(WALK_LAYOUT) + 2 * MAX_D))(*walk_layout(self.lay, st))
        elif st.param_grads:
            # weight gradients accumulated by atomics: zero first; trunk and features in the padded layout
            for i in range(st.D):
                rows = (X0_PAD if i == 0 else (X0_PAD + W if i in st.skips else W))
                dtw[i] = torch.zeros((rows, W), **f32)
                dtb[i] = torch.zeros((W,), **f32)
            dhd = {k: torch.zeros(v.shape, **f32) for k, v in pad_feat({k: heads[k] for k in st.head_keys},
                                                                         FP).items()}
        outs = [None, None, d_cond, d_cemb, d_front[0]] if x0_mode else [*d_front, d_cond, d_cemb, None]
        self.lib = _build.library("render_train_bwd_no_dw_adds" if design == "no_adds" else "render_train_bwd")
        self.name = "render_train_bwd (x0 mode)" if x0_mode else "render_train_bwd"
        flags = _flags(st, True) | (X0_IN if x0_mode else 0) | (DW_OPS if self.stores else 0)
        skip_mask = sum(1 << i for i in st.skips if 0 < i < st.D)
        opt = lambda ts: None if ts is None else _ptrs(ts)  # noqa: E731
        fixed = (_ptrs(kt), st.D, skip_mask, _ptrs(kw), opt(tw), opt(tb), opt(fw))
        grads = (_ptrs(dtw), _ptrs(dtb), _ptrs([dhd.get(k) for k in HEAD_KEYS]),
                 None if scratch is None else scratch.data_ptr(), None if self.bufs is None else _ptrs(self.bufs),
                 layout)
        shape = (S, L, in0, C, F, flags)
        self._lists = (ins, cot_list, res_list, outs)
        self._args = (fixed, grads, shape)
        self._keep = (kt, kw, tw, tb, fw, scratch, dtw, dtb, dhd, layout)  # what the pointers point at
        self.R, self.S, self.dev, self.st, self.in0, self.F = R, S, dev, st, in0, F
        self.result = (d_front, d_cond, d_cemb, dtw, dtb, dhd)

    def walk(self, r0: int, r1: int) -> None:
        """The walk over rays [r0, r1): one launch."""
        S = self.S

        def cut(ts, rows):
            return [t if t is None or per is None else t[r0 * (S if per == "S" else 1) : r1 * (S if per == "S" else 1)]
                    for t, per in zip(ts, rows)]

        ins, cot_list, res_list, outs = self._lists
        (kt, D, skip_mask, kw, tw, tb, fw), (dtw, dtb, dh, scratch, bufs, layout), (_, L, in0, C, F, flags) = \
            self._args
        stream = torch.cuda.current_stream(self.dev).cuda_stream
        with torch.cuda.device(self.dev):
            code = self.lib.upnerf_render_train_bwd(
                _ptrs(cut(ins, _INS_ROWS)), _ptrs(cut(cot_list, (1,) * 7)), _ptrs(cut(res_list, _RES_ROWS)), kt, D,
                skip_mask, kw, tw, tb, fw, _ptrs(cut(outs, _OUT_ROWS)), dtw, dtb, dh, scratch, bufs, layout,
                r1 - r0, S, L, in0, C, F, flags, self.grid or r1 - r0, stream,
            )
        _raise_on(code, self.name, self.lib)

    def dw(self, r0: int, r1: int) -> None:
        """dw_gemm on the operands the walk over rays [r0, r1) stored: the
        slab's weight and bias gradients written into the flat result (r0 =
        0) or added to it."""
        S, (ops, ray, rows) = self.S, self.bufs
        n = r1 - r0
        chain = self._lists[2][RES_ORDER.index("chain")][r0 * S : r1 * S]
        dw_gemm.dw_gemm([chain, ops[: n * S], None if ray is None else ray[:n]], self.lay.jobs, self.flat,
                        self.lay.n_dw, rows[:n], r0 > 0)

    def run(self):
        """The whole call. Returns (d_front, d_ray_cond, d_c_emb, dtrunk,
        dheads): d_front is [d_x0] in the x0 mode, [d_rays_o, d_rays_d]
        otherwise; the last two None in the frozen mode."""
        for r0 in range(0, self.R, self.slab):
            r1 = min(self.R, r0 + self.slab)
            self.walk(r0, r1)
            if self.stores:
                self.dw(r0, r1)
        d_front, d_cond, d_cemb, dtw, dtb, dhd = self.result
        st = self.st
        if not st.param_grads:
            return d_front, d_cond, d_cemb, None, None
        if self.stores:
            return (d_front, d_cond, d_cemb, *dw_result(self.flat, self.lay, st, self.in0, self.F))
        dtrunk = [(unpad_trunk_grad(dtw[i], i, st.skips, self.in0), dtb[i]) for i in range(st.D)]
        return d_front, d_cond, d_cemb, dtrunk, unpad_feat(dhd, self.F)


def _launch_bwd(ins, in0: int, L: int, z_vals, ray_cond, trunk, heads, st: RTStatic, c_emb, res, cots,
                x0_mode: bool):
    """One backward call of csrc/render_train_bwd.cu (and, in the bf16
    saved-chain train mode, csrc/dw_gemm.cu) on checked arguments: BwdLaunch's
    run()."""
    return BwdLaunch(ins, in0, L, z_vals, ray_cond, trunk, heads, st, c_emb, res, cots, x0_mode).run()


def render_train_rays_bwd_launch(rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st: RTStatic, c_emb, res,
                                 cots, design: str = "stores") -> BwdLaunch:
    """render_train_rays_bwd's CUDA call, checked and prepared but not
    launched, in one of BWD_DESIGNS: to time its pieces (chip_smoke.py phase
    9). Counts no launch."""
    R, S = z_vals.shape
    L = st.xyz_L
    front = {"rays_o": (rays_o, (R, 3)), "rays_d": (rays_d, (R, 3)), "pe_w": (pe_w, (L,))}
    _check_kernel_args(front, 3 + 6 * L, z_vals, ray_cond, c_emb, trunk, heads, st)
    return BwdLaunch([rays_o, rays_d, z_vals, pe_w, ray_cond, c_emb, None], 3 + 6 * L, L, z_vals, ray_cond, trunk,
                     heads, st, c_emb, res, cots, False, design)


def render_train_rays_bwd(rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st: RTStatic, c_emb, res, cots):
    """Backward render: `render_train_rays_bwd_plain` for CPU tensors, the
    CUDA kernels for CUDA tensors, with the same arguments and results.

    In the bf16 saved-chain train mode the call runs, per slab of rays
    (dw_slab_rays, its buffers under 1 GiB), the walk, which stores the
    weight gradients' operands (dw_layout), then the dW kernel
    (ops/dw_gemm.py), which sums them in a fixed order: two calls on the same
    inputs give the same bits. In the float32 and the recompute train modes
    the walk accumulates the weight gradients over all rays with f32 atomic
    adds in device memory, so their last bits change from run to run. With
    st.param_grads off it computes the data cotangents only (the same bits as
    the train mode's) and returns None for the weight gradients. In the
    recompute mode (st.save_chain off) it runs persistent blocks, one an SM,
    each rebuilding a 32-sample tile's chain into its own slice of a scratch
    buffer in device memory."""
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
