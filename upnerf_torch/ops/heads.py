"""Fused NeRF trunk + density / feature / candidate heads, forward and backward
(upnerf/ops/pallas_heads.py:fused_trunk_heads).

Per sample: h = trunk(x0), s_sigma = softplus(h Ws + bs), xyzf = h Wx + bx,
s_feat = xyzf Wf + bf; with the candidate branch cin = [xyzf, c_emb],
h1 = relu(cin W1 + b1), h2 = relu(h1 W2 + b2), c_sigma = softplus(h2 Wcs + bcs),
c_feat = h2 Wcf + bcf. The view-dependent rgb head stays outside, in PyTorch,
as in the JAX package. The candidate embedding comes per sample (the JAX
interface: the caller broadcasts it, autograd sums its gradient back per ray).

- `fused_trunk_heads_plain` and `fused_trunk_heads_bwd_plain` are the plain
  PyTorch forward and backward: the JAX kernels step by step. In bfloat16 mode
  every product rounds both operands to bf16 and sums in f32, as the kernels'
  `_dot` does; bias sums stay f32. The JAX backward forms the trunk's input
  cotangent with a bare `jnp.dot` (pallas_heads.py:217); the port follows
  `_dot` there too (ROADMAP.md §3).
- `fused_trunk_heads_fwd` / `fused_trunk_heads_bwd` are the wrappers: on CPU
  tensors they run the plain versions, on CUDA tensors they launch the
  hand-written kernels (`csrc/heads_fwd.cu`, `csrc/heads_bwd.cu`) or raise.
  They count their launches in `launches` and `bwd_launches`.
- `fused_trunk_heads` is the differentiable entry (the JAX custom VJP): an
  autograd.Function whose backward recomputes the chain, as the JAX one does.

Weights come in the JAX kernel's interface: `trunk` is a sequence of
(W (in, out), b (out,)) pairs and `heads` holds HEAD_KEYS (+ CAND_KEYS), with
c1_w unsplit (W + C, HC).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from upnerf_torch.ops.linear import canonical_precision, matmul
from upnerf_torch.ops.mlp import _layout, _padded_trunk, fused_trunk_plain, trunk_chain, trunk_walk_plain
from upnerf_torch.ops.render_train import (
    X0_PAD, _ptrs, _raise_on, check_feat_width, feat_pad, pad_feat, softplus, unpad_feat, unpad_trunk_grad,
)

HEAD_KEYS = ("sigma_w", "sigma_b", "xyzf_w", "xyzf_b", "feat_w", "feat_b")
CAND_KEYS = ("c1_w", "c1_b", "c2_w", "c2_b", "csig_w", "csig_b", "cfeat_w", "cfeat_b")
# The widths the CUDA kernels take (configs/brandenburg_gate.yaml, configs/validation/;
# F one of render_train.KERNEL_F); c_emb up to 64 columns.
KERNEL_WIDTHS = {"W": 256, "HC": 128}
MAX_C = 64
MAX_D = 16

# Kernel launches made in this process by fused_trunk_heads_fwd / _bwd.
launches = 0
bwd_launches = 0


def _heads_fwd(h, c_emb, heads, prec) -> Dict[str, torch.Tensor]:
    """The heads on the last trunk activation h: outputs and the walk's operands."""
    out = {"s_sigma": softplus(matmul(h, heads["sigma_w"], prec) + heads["sigma_b"])}
    out["xyzf"] = xyzf = matmul(h, heads["xyzf_w"], prec) + heads["xyzf_b"]
    out["s_feat"] = matmul(xyzf, heads["feat_w"], prec) + heads["feat_b"]
    if c_emb is not None:
        out["cin"] = cin = torch.cat([xyzf, c_emb], dim=-1)
        out["h1"] = h1 = torch.relu(matmul(cin, heads["c1_w"], prec) + heads["c1_b"])
        out["h2"] = h2 = torch.relu(matmul(h1, heads["c2_w"], prec) + heads["c2_b"])
        out["c_sigma"] = softplus(matmul(h2, heads["csig_w"], prec) + heads["csig_b"])
        out["c_feat"] = matmul(h2, heads["cfeat_w"], prec) + heads["cfeat_b"]
    return out


def _outputs(f, use_cand: bool) -> Tuple[torch.Tensor, ...]:
    keys = ("s_sigma", "s_feat", "c_sigma", "c_feat") if use_cand else ("s_sigma", "s_feat")
    return tuple(f[k] for k in keys)


def fused_trunk_heads_plain(
    x0: torch.Tensor,  # (N, in0) PE input
    c_emb: Optional[torch.Tensor],  # (N, C) per-sample candidate embedding, or None
    trunk: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    heads: Dict[str, torch.Tensor],
    skips: Tuple[int, ...],
    precision: str = "float32",
) -> Tuple[torch.Tensor, ...]:
    """(s_sigma (N, 1), s_feat (N, F)[, c_sigma (N, 1), c_feat (N, F)]), plain PyTorch."""
    h = fused_trunk_plain(x0, trunk, skips, precision)
    return _outputs(_heads_fwd(h, c_emb, heads, canonical_precision(precision)), c_emb is not None)


def fused_trunk_heads_bwd_plain(x0, c_emb, trunk, heads, skips, precision, cots):
    """Plain backward (pallas_heads.py:_bwd_kernel, recomputing the chain).
    cots: the outputs' cotangents in forward order (None means zero). Returns
    (dx0, dc_emb or None, [(dW, db)] per trunk layer, {head key: grad}). float64
    inputs run in float64 with precision float32 (chip_smoke.py's witness)."""
    prec = canonical_precision(precision)
    use_cand = c_emb is not None

    def dot(a, b):
        return matmul(a, b, prec)

    def cot(i, like):
        g = cots[i] if i < len(cots) else None
        return torch.zeros_like(like) if g is None else g.to(like.dtype)

    inputs, acts = trunk_chain(x0, trunk, skips, prec)
    h = acts[-1]
    f = _heads_fwd(h, c_emb, heads, prec)
    g_ss, g_sf = cot(0, f["s_sigma"]), cot(1, f["s_feat"])
    dp = {"feat_w": dot(f["xyzf"].t(), g_sf), "feat_b": g_sf.sum(0)}
    dxyzf = dot(g_sf, heads["feat_w"].t())
    dc_emb = None
    if use_cand:
        g_cs, g_cf = cot(2, f["c_sigma"]), cot(3, f["c_feat"])
        dp["cfeat_w"] = dot(f["h2"].t(), g_cf)
        dp["cfeat_b"] = g_cf.sum(0)
        dh2 = dot(g_cf, heads["cfeat_w"].t())
        dpre_cs = g_cs * (1.0 - torch.exp(-f["c_sigma"]))
        dp["csig_w"] = dot(f["h2"].t(), dpre_cs)
        dp["csig_b"] = dpre_cs.sum(0)
        dh2 = (dh2 + dot(dpre_cs, heads["csig_w"].t())) * (f["h2"] > 0)
        dp["c2_w"] = dot(f["h1"].t(), dh2)
        dp["c2_b"] = dh2.sum(0)
        dh1 = dot(dh2, heads["c2_w"].t()) * (f["h1"] > 0)
        dp["c1_w"] = dot(f["cin"].t(), dh1)
        dp["c1_b"] = dh1.sum(0)
        dcin = dot(dh1, heads["c1_w"].t())
        W = heads["xyzf_w"].shape[1]
        dxyzf = dxyzf + dcin[:, :W]
        dc_emb = dcin[:, W:]
    dp["xyzf_w"] = dot(h.t(), dxyzf)
    dp["xyzf_b"] = dxyzf.sum(0)
    dh = dot(dxyzf, heads["xyzf_w"].t())
    dpre_ss = g_ss * (1.0 - torch.exp(-f["s_sigma"]))
    dp["sigma_w"] = dot(h.t(), dpre_ss)
    dp["sigma_b"] = dpre_ss.sum(0)
    g = dh + dot(dpre_ss, heads["sigma_w"].t())
    dx0, dtrunk = trunk_walk_plain(x0, trunk, skips, prec, inputs, acts, g)
    return dx0, dc_emb, dtrunk, dp


# ---------------------------------------------------------------------------
# CUDA wrappers


def _check_args(x0, c_emb, trunk, heads, skips) -> None:
    """Device, dtype and shape checks of everything the kernels read; raises on
    what they do not take."""
    N, in0 = x0.shape
    D = len(trunk)
    W, HC = KERNEL_WIDTHS["W"], KERNEL_WIDTHS["HC"]
    F = heads["feat_b"].shape[0]
    check_feat_width(F)
    C = 0 if c_emb is None else c_emb.shape[1]
    if in0 > X0_PAD or not 0 < D <= MAX_D or C > MAX_C:
        raise ValueError(f"the CUDA heads kernels take 3 + 6L <= {X0_PAD}, D <= {MAX_D}, C <= {MAX_C};"
                         f" got in0 = {in0}, D = {D}, C = {C}")
    shapes = {"sigma_w": (W, 1), "sigma_b": (1,), "xyzf_w": (W, W), "xyzf_b": (W,), "feat_w": (W, F),
              "feat_b": (F,), "c1_w": (W + C, HC), "c1_b": (HC,), "c2_w": (HC, HC), "c2_b": (HC,),
              "csig_w": (HC, 1), "csig_b": (1,), "cfeat_w": (HC, F), "cfeat_b": (F,)}
    named = [("x0", x0, (N, in0))] + ([("c_emb", c_emb, (N, C))] if C else [])
    for i, (w, b) in enumerate(trunk):
        fan_in = in0 if i == 0 else (in0 + W if i in skips else W)
        named += [(f"trunk[{i}].w", w, (fan_in, W)), (f"trunk[{i}].b", b, (W,))]
    named += [(k, heads[k], shapes[k]) for k in HEAD_KEYS + (CAND_KEYS if C else ())]
    for name, t, shape in named:
        if t.device != x0.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.device} {t.dtype} {tuple(t.shape)}; the kernels take {x0.device}"
                             f" torch.float32 {shape} (W = {W}, F = {F}, HC = {HC})")


def _c1_padded(c1_w: torch.Tensor, W: int) -> torch.Tensor:
    """(W + C, HC) -> (W + 64, HC): c_emb rows zero-padded, the kernels' operand width."""
    return torch.cat([c1_w, c1_w.new_zeros(W + 64 - c1_w.shape[0], c1_w.shape[1])], 0)


def fused_trunk_heads_fwd(x0, c_emb, trunk, heads, skips, precision: str = "float32") -> Tuple[torch.Tensor, ...]:
    """Forward: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors; the same arguments and outputs either way, all f32. The kernel
    takes W = 256, F in render_train.KERNEL_F, HC = 128, 3 + 6L <= 64,
    D <= 16, C <= 64; it computes no gradient (train through
    `fused_trunk_heads`)."""
    if x0.device.type == "cpu":
        return fused_trunk_heads_plain(x0, c_emb, trunk, heads, skips, precision)
    if x0.device.type != "cuda":
        raise ValueError(f"no heads kernel for device {x0.device}")
    global launches
    from upnerf_torch.ops import _build

    _check_args(x0, c_emb, trunk, heads, skips)
    tensors = [x0, c_emb, *heads.values()] + [t for wb in trunk for t in wb]
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("the CUDA heads kernel is forward-only: run it under torch.no_grad()"
                           " or train through fused_trunk_heads")
    N, in0 = x0.shape
    C = 0 if c_emb is None else c_emb.shape[1]
    W, F = KERNEL_WIDTHS["W"], heads["feat_b"].shape[0]
    bf16 = canonical_precision(precision) == "bfloat16"
    cdt = torch.bfloat16 if bf16 else torch.float32
    heads = pad_feat(heads, feat_pad(F, bf16))
    tw = [_layout(w, bf16) for w in _padded_trunk(trunk, skips, in0)]
    tb = [b.contiguous() for _, b in trunk]
    hw = [heads["sigma_w"].reshape(-1).to(cdt).contiguous(), heads["sigma_b"].contiguous(),
          _layout(heads["xyzf_w"], bf16), heads["xyzf_b"].contiguous(),
          _layout(heads["feat_w"], bf16), heads["feat_b"].contiguous()]
    if C:
        hw += [_layout(_c1_padded(heads["c1_w"], W), bf16), heads["c1_b"].contiguous(), _layout(heads["c2_w"], bf16),
               heads["c2_b"].contiguous(), heads["csig_w"].reshape(-1).to(cdt).contiguous(),
               heads["csig_b"].contiguous(), _layout(heads["cfeat_w"], bf16), heads["cfeat_b"].contiguous()]
    else:
        hw += [None] * len(CAND_KEYS)
    f32 = dict(dtype=torch.float32, device=x0.device)
    outs = [torch.empty((N, 1), **f32), torch.empty((N, F), **f32)]
    if C:
        outs += [torch.empty((N, 1), **f32), torch.empty((N, F), **f32)]
    x0 = x0.contiguous()
    ce = c_emb.contiguous() if C else None
    lib = _build.library("heads_fwd")
    skip_mask = sum(1 << i for i in skips if 0 < i < len(trunk))
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    with torch.cuda.device(x0.device):
        code = lib.upnerf_heads_fwd(x0.data_ptr(), ce.data_ptr() if C else None, _ptrs(tw), _ptrs(tb), len(trunk),
                                    skip_mask, _ptrs(hw), _ptrs(outs + [None] * (4 - len(outs))), N, in0, C, F,
                                    int(bf16), stream)
    _raise_on(code, "heads_fwd", lib)
    launches += 1
    return tuple(outs)


def fused_trunk_heads_bwd(x0, c_emb, trunk, heads, skips, precision, cots):
    """Backward: `fused_trunk_heads_bwd_plain` for CPU tensors, the CUDA kernel
    for CUDA tensors, with the same arguments and results. The kernel
    recomputes the chain per tile and adds the weight gradients over all rows
    with f32 atomic adds, so their last bits change from run to run."""
    if x0.device.type == "cpu":
        return fused_trunk_heads_bwd_plain(x0, c_emb, trunk, heads, skips, precision, cots)
    if x0.device.type != "cuda":
        raise ValueError(f"no heads kernel for device {x0.device}")
    global bwd_launches
    from upnerf_torch.ops import _build

    _check_args(x0, c_emb, trunk, heads, skips)
    N, in0 = x0.shape
    C = 0 if c_emb is None else c_emb.shape[1]
    W, HC, F = KERNEL_WIDTHS["W"], KERNEL_WIDTHS["HC"], heads["feat_b"].shape[0]
    D = len(trunk)
    dev = x0.device
    bf16 = canonical_precision(precision) == "bfloat16"
    cdt = torch.bfloat16 if bf16 else torch.float32
    FP = feat_pad(F, bf16)
    kh = pad_feat(heads, FP)  # the feature dimension zero-padded to the kernels' FP
    f32 = dict(dtype=torch.float32, device=dev)
    cot_shapes = [(N, 1), (N, F), (N, 1), (N, F)]
    cot_list = []
    for i, shape in enumerate(cot_shapes):
        g = cots[i] if i < len(cots) else None
        if g is not None:
            if g.device != dev or g.dtype != torch.float32 or tuple(g.shape) != shape:
                raise ValueError(f"cotangent {i}: {g.device} {g.dtype} {tuple(g.shape)}, expected f32 {shape}")
            g = g.contiguous()
        cot_list.append(g)
    padded = _padded_trunk(trunk, skips, in0)
    tw = [_layout(w, bf16) for w in padded]
    tT = [_layout(w.t(), bf16) for w in padded]
    tb = [b.contiguous() for _, b in trunk]
    if C:
        c1 = heads["c1_w"]
        cw = [_layout(_c1_padded(c1, W), bf16), _layout(c1[:W].t(), bf16), c1[W:].to(cdt).contiguous(),
              _layout(heads["c2_w"], bf16), _layout(heads["c2_w"].t(), bf16), _layout(kh["cfeat_w"].t(), bf16)]
        csig = heads["csig_w"].reshape(-1).to(cdt).contiguous()
        cb = [heads["c1_b"].contiguous(), heads["c2_b"].contiguous(), heads["csig_b"].contiguous()]
    else:
        cw, csig, cb = [None] * 6, None, [None] * 3
    w = [_layout(heads["xyzf_w"], bf16), _layout(heads["xyzf_w"].t(), bf16), _layout(kh["feat_w"].t(), bf16),
         *cw, heads["sigma_w"].reshape(-1).to(cdt).contiguous(), csig]
    b = [heads["xyzf_b"].contiguous(), heads["sigma_b"].contiguous(), *cb]
    dx0 = torch.empty((N, in0), **f32)
    dcemb = torch.empty((N, C), **f32) if C else None
    dtw = [torch.zeros(t.shape, **f32) for t in padded]
    dtb = [torch.zeros((W,), **f32) for _ in range(D)]
    shapes = {"sigma_w": (W,), "sigma_b": (1,), "xyzf_w": (W, W), "xyzf_b": (W,), "feat_w": (W, FP), "feat_b": (FP,),
              "c1_w": (W + 64, HC), "c1_b": (HC,), "c2_w": (HC, HC), "c2_b": (HC,), "csig_w": (HC,), "csig_b": (1,),
              "cfeat_w": (HC, FP), "cfeat_b": (FP,)}
    keys = HEAD_KEYS + (CAND_KEYS if C else ())
    dh = {k: torch.zeros(shapes[k], **f32) for k in keys}
    chain_w = (D + 1) * W + 2 * HC
    grid = min((N + 31) // 32, torch.cuda.get_device_properties(dev).multi_processor_count)
    scratch = torch.empty((grid * 32 * chain_w,), dtype=cdt, device=dev)
    lib = _build.library("heads_bwd")
    skip_mask = sum(1 << i for i in skips if 0 < i < D)
    stream = torch.cuda.current_stream(dev).cuda_stream
    x0 = x0.contiguous()
    ce = c_emb.contiguous() if C else None
    with torch.cuda.device(dev):
        code = lib.upnerf_heads_bwd(
            x0.data_ptr(), ce.data_ptr() if C else None, _ptrs(cot_list), _ptrs(tw), _ptrs(tb), _ptrs(tT), D,
            skip_mask, _ptrs(w), _ptrs(b), _ptrs([dx0, dcemb]), _ptrs(dtw), _ptrs(dtb),
            _ptrs([dh.get(k) for k in HEAD_KEYS + CAND_KEYS]), scratch.data_ptr(), N, in0, C, F, int(bf16), grid,
            stream,
        )
    _raise_on(code, "heads_bwd", lib)
    bwd_launches += 1
    dtrunk = [(unpad_trunk_grad(dtw[i], i, skips, in0), dtb[i]) for i in range(D)]
    dp = {k: v.reshape(heads[k].shape) if k != "c1_w" else v[: W + C] for k, v in unpad_feat(dh, F).items()}
    return dx0, dcemb, dtrunk, dp


class FusedTrunkHeads(torch.autograd.Function):
    """Differentiable trunk + heads (the JAX kernel's custom VJP): the forward
    kernel, and a backward that recomputes the chain.

    apply(x0, c_emb, skips, precision, head_names, *trunk_flat, *head_tensors)
    -> (s_sigma, s_feat[, c_sigma, c_feat])."""

    @staticmethod
    def forward(ctx, x0, c_emb, skips, precision, head_names, *weights):
        D = (len(weights) - len(head_names)) // 2
        trunk = [(weights[2 * i], weights[2 * i + 1]) for i in range(D)]
        heads = dict(zip(head_names, weights[2 * D :]))
        outs = fused_trunk_heads_fwd(x0, c_emb, trunk, heads, skips, precision)
        ctx.skips, ctx.precision, ctx.head_names, ctx.D = skips, precision, head_names, D
        ctx.save_for_backward(x0, c_emb, *weights)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        x0, c_emb, *weights = ctx.saved_tensors
        D = ctx.D
        trunk = [(weights[2 * i], weights[2 * i + 1]) for i in range(D)]
        heads = dict(zip(ctx.head_names, weights[2 * D :]))
        dx0, dcemb, dtrunk, dh = fused_trunk_heads_bwd(x0, c_emb, trunk, heads, ctx.skips, ctx.precision, grads)
        flat = [t for wb in dtrunk for t in wb] + [dh[k] for k in ctx.head_names]
        return (dx0, dcemb, None, None, None, *flat)


def fused_trunk_heads(x0, c_emb, trunk, heads, skips, precision: str = "float32") -> Tuple[torch.Tensor, ...]:
    """Differentiable (s_sigma (N, 1), s_feat (N, F)[, c_sigma (N, 1), c_feat
    (N, F)]), through FusedTrunkHeads; c_emb None leaves out the candidate
    branch (and its heads are not read)."""
    names = HEAD_KEYS + (CAND_KEYS if c_emb is not None else ())
    flat = [t for wb in trunk for t in wb] + [heads[k] for k in names]
    return FusedTrunkHeads.apply(x0, c_emb, tuple(skips), precision, names, *flat)
