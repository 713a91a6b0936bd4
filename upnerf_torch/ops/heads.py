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
  They count their launches in `launches` and `bwd_launches`. In bfloat16
  mode both kernels stream their weights, packed once a call by one gather
  (`_fwd_wgmma_weights`, `_bwd_wgmma_weights`, from the same strip helpers),
  to `wgmma` consumers; `fused_trunk_heads_fwd_launch` also launches the
  forward's timing variant (`HEADS_FWD_DESIGNS`). The backward
  runs per slab of rows: the kernel stores the operands of every weight
  gradient into a buffer laid out by `heads_dw_layout`, and `dw_gemm`
  (csrc/dw_gemm.cu) sums them in a fixed order, so two calls give the same
  bits. `fused_trunk_heads_bwd_dw_plain` is that route in plain PyTorch.
- `fused_trunk_heads` is the differentiable entry (the JAX custom VJP): an
  autograd.Function whose backward recomputes the chain, as the JAX one does.

Weights come in the JAX kernel's interface: `trunk` is a sequence of
(W (in, out), b (out,)) pairs and `heads` holds HEAD_KEYS (+ CAND_KEYS), with
c1_w unsplit (W + C, HC).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from upnerf_torch.ops import dw_gemm, render_train
from upnerf_torch.ops.linear import canonical_precision, matmul
from upnerf_torch.ops.mlp import _check_args as _check_trunk_args
from upnerf_torch.ops.mlp import _layout, _padded_trunk, fused_trunk_plain, trunk_chain, trunk_walk_plain
from upnerf_torch.ops.render_train import (
    X0_PAD, DwLayout, _pad_x0_rows, _ptrs, _raise_on, check_feat_width, feat_pad, pack_wgmma, pad_feat, softplus,
    unpad_feat, unpad_trunk_grad,
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


def fused_trunk_heads_bwd_plain(x0, c_emb, trunk, heads, skips, precision, cots, ops=None):
    """Plain backward (pallas_heads.py:_bwd_kernel, recomputing the chain).
    cots: the outputs' cotangents in forward order (None means zero). Returns
    (dx0, dc_emb or None, [(dW, db)] per trunk layer, {head key: grad}). float64
    inputs run in float64 with precision float32 (chip_smoke.py's witness).
    ops: a dict that receives the weight gradients' operands, unrounded
    (heads_dw_products' names)."""
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
    if ops is not None:
        ops.update({"x0": x0, "xyzf": f["xyzf"], "g_feat": g_sf, **{f"act{i}": a for i, a in enumerate(acts)}})
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
        if ops is not None:
            ops.update({"c_emb": c_emb, "h1": f["h1"], "h2": f["h2"], "g_cfeat": g_cf, "g_cpre": dpre_cs, "g_h2": dh2,
                        "g_h1": dh1})
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
    if ops is not None:
        ops.update({"g_xyzf": dxyzf, "g_spre": dpre_ss})
    dx0, dtrunk = trunk_walk_plain(x0, trunk, skips, prec, inputs, acts, g, ops)
    return dx0, dc_emb, dtrunk, dp


# ---------------------------------------------------------------------------
# The backward's weight gradients: per slab of rows, the kernel (or its plain
# route) stores every dW = X^T G's operands into one buffer laid out by
# heads_dw_layout and a row of bias sums a tile, then dw_gemm (csrc/dw_gemm.cu)
# sums them in a fixed order, writing the first slab's result and adding the
# others'.

# Rows a bias row sums: a consumer warpgroup's tile of the Hopper kernel (bf16), the
# SIMT kernel's tile (f32).
BWD_TILE = {"bfloat16": 64, "float32": 32}
SLAB_ALIGN = 128  # slab rows a multiple of the Hopper kernel's tile pair
# The kernel's layout slots (csrc/heads_bwd.cu:Lay), in order: the buffer's row width
# and the bias count, each operand's first column (the trunk's at i W from act0 /
# g_act0, g_spre and g_cpre at columns 0 and 1 of g_narrow), each bias's offset in a
# tile's row (the trunk's at i W from trunk0_b). -1: not in the mode.
HEADS_LAYOUT = ("ops_w", "nb", "x0", "c_emb", "act0", "xyzf", "h1", "h2", "g_act0", "g_xyzf", "g_feat", "g_cfeat",
                "g_h2", "g_h1", "g_narrow", "trunk0_b", "xyzf_b", "sigma_b", "feat_b", "cfeat_b", "csig_b", "c2_b",
                "c1_b")
NARROW = {"g_spre": 0, "g_cpre": 1}  # the 1-column cotangents share one column block


def heads_dw_products(D: int, skips, heads: bool, cand: bool):
    """The backward's weight gradients as (name, X operands, G operand), in
    the plain backward's names (fused_trunk_heads_bwd_plain's ops): the
    gradient is X^T G over the rows, a skip layer's X [x0, act] and c1's
    [xyzf, c_emb] side by side. Trunk-only (heads False): the trunk's."""
    out = []
    for i in range(D):
        xs = ("x0",) if i == 0 else (("x0", f"act{i - 1}") if i in skips else (f"act{i - 1}",))
        out.append((f"trunk{i}_w", xs, f"g_act{i}"))
    if heads:
        h = f"act{D - 1}"
        out += [("sigma_w", (h,), "g_spre"), ("xyzf_w", (h,), "g_xyzf"), ("feat_w", ("xyzf",), "g_feat")]
        if cand:
            out += [("c1_w", ("xyzf", "c_emb"), "g_h1"), ("c2_w", ("h1",), "g_h2"), ("csig_w", ("h2",), "g_cpre"),
                    ("cfeat_w", ("h2",), "g_cfeat")]
    return tuple(out)


def heads_dw_biases(D: int, heads: bool, cand: bool):
    """The bias gradients as (name, G operand): column sums of G over the rows, in f32 (unrounded)."""
    out = [(f"trunk{i}_b", f"g_act{i}") for i in range(D)]
    if heads:
        out += [("xyzf_b", "g_xyzf"), ("sigma_b", "g_spre"), ("feat_b", "g_feat")]
        if cand:
            out += [("cfeat_b", "g_cfeat"), ("csig_b", "g_cpre"), ("c2_b", "g_h2"), ("c1_b", "g_h1")]
    return tuple(out)


@functools.lru_cache(maxsize=64)
def heads_dw_layout(D: int, skips: Tuple[int, ...], W: int, FP: int, HC: int, C: int, heads: bool = True) -> DwLayout:
    """The backward's dW operand layout for a trunk of D layers of width W
    (skips), the padded feature width FP, candidate width HC and embedding
    width C (0: no candidate branch); heads False: the trunk-only mode (ops/
    mlp.py), whose layout is the trunk's subset. One buffer (rows = the slab's
    rows) holds every X operand (x0 at X0_PAD columns, c_emb zero-padded to a
    block, each trunk activation, xyzf, h1, h2) and every rounded cotangent G
    of heads_dw_products, each at whole 64-column blocks (dw_gemm.BLOCK);
    g_spre and g_cpre share one block (NARROW). A tile's bias row holds the
    f32 sums of each bias's cotangent (heads_dw_biases). The flat result
    holds each weight gradient (trunk x0 rows at X0_PAD, feature columns at
    FP, c1_w at W + C rows), then the biases. The jobs all read source 0."""
    cand = heads and C > 0
    blk = dw_gemm.BLOCK
    up = lambda n: -(-n // blk) * blk  # noqa: E731
    widths = {"x0": X0_PAD, "c_emb": C, "xyzf": W, "h1": HC, "h2": HC, "g_xyzf": W, "g_feat": FP, "g_cfeat": FP,
              "g_h2": HC, "g_h1": HC, "g_spre": 1, "g_cpre": 1,
              **{f"act{i}": W for i in range(D)}, **{f"g_act{i}": W for i in range(D)}}
    names = ["x0"] + (["c_emb"] if cand else []) + [f"act{i}" for i in range(D)] + (["xyzf"] if heads else [])
    names += (["h1", "h2"] if cand else []) + [f"g_act{i}" for i in range(D)] + (["g_xyzf", "g_feat"] if heads else [])
    names += ["g_cfeat", "g_h2", "g_h1"] if cand else []
    ops, col = {}, 0
    for name in names:
        ops[name] = col
        col += up(widths[name])
    if heads:
        ops.update({k: col + c for k, c in NARROW.items() if k == "g_spre" or cand})
        col += blk
    bias, nb = {}, 0
    for name, g in heads_dw_biases(D, heads, cand):
        bias[name] = (nb, widths[g])
        nb += widths[g]
    shapes = {"sigma_w": (W, 1), "xyzf_w": (W, W), "feat_w": (W, FP), "c1_w": (W + C, HC), "c2_w": (HC, HC),
              "csig_w": (HC, 1), "cfeat_w": (HC, FP)}
    outs, n_dw, jobs = {}, 0, []
    for name, xs, g in heads_dw_products(D, skips, heads, cand):
        shape = (sum(widths[x] for x in xs), W) if name.startswith("trunk") else shapes[name]
        outs[name] = (n_dw, shape)
        if g in NARROW:
            g_col, g_cols, g0 = ops[g] - NARROW[g], blk, NARROW[g]
        else:
            g_col, g_cols, g0 = ops[g], up(widths[g]), 0
        row0 = 0
        for x in xs:
            jobs.append(dw_gemm.DwJob(0, ops[x], up(widths[x]), 0, g_col, g_cols, g0, widths[g], widths[x],
                                      n_dw + row0 * shape[1], shape[1]))
            row0 += widths[x]
        n_dw += shape[0] * shape[1]
    return DwLayout(ops, col, {}, 0, bias, nb, outs, n_dw, tuple(jobs))


def heads_layout_slots(lay: DwLayout) -> list:
    """The kernel's layout slots (HEADS_LAYOUT) of lay."""
    cols = {"ops_w": lay.ops_w, "nb": lay.nb, **lay.ops, **{k: off for k, (off, _) in lay.bias.items()},
            "g_narrow": lay.ops["g_spre"] if "g_spre" in lay.ops else -1}
    return [cols.get(k, -1) for k in HEADS_LAYOUT]


def heads_slab_rows(lay: DwLayout, N: int, esize: int) -> int:
    """Rows a slab of the backward: as many as keep its operand buffer (esize
    bytes an element) and bias rows within render_train.DW_BUFFER_BYTES (the
    render backward's budget), a multiple of SLAB_ALIGN, at most N rounded up
    to it."""
    per_row = lay.ops_w * esize + lay.nb * 4 / min(BWD_TILE.values())
    rows = max(SLAB_ALIGN, int(render_train.DW_BUFFER_BYTES // per_row) // SLAB_ALIGN * SLAB_ALIGN)
    return min(rows, -(-N // SLAB_ALIGN) * SLAB_ALIGN)


def heads_operands_plain(ops: Dict[str, torch.Tensor], lay: DwLayout, n: int, tile: int, dtype, biases):
    """The kernel's stores for n rows, in plain PyTorch: from the plain
    backward's operands, the operand buffer (n, lay.ops_w) rounded to dtype
    (zero where no operand lies), and the f32 bias rows of each tile of tile
    rows (ceil(n / tile), lay.nb); biases: heads_dw_biases."""
    buf = torch.zeros((n, lay.ops_w), dtype=dtype, device=ops["x0"].device)
    for name, col in lay.ops.items():
        v = ops[name].reshape(n, -1)
        buf[:, col : col + v.shape[1]] = v.to(dtype)
    nt = -(-n // tile)
    rows = torch.zeros((nt, lay.nb), dtype=torch.float32, device=buf.device)
    for name, g in biases:
        off = lay.bias[name][0]
        v = ops[g].reshape(n, -1).float()
        v = torch.cat([v, v.new_zeros(nt * tile - n, v.shape[1])])
        rows[:, off : off + v.shape[1]] = v.reshape(nt, tile, -1).sum(1)
    return buf, rows


def heads_dw_result(flat: torch.Tensor, lay: DwLayout, D: int, skips, in0: int, F: int, heads: Dict):
    """The flat result -> ([(dW, db)] per trunk layer, {head key: grad}) at the
    layers' and the heads' own shapes (heads: the head tensors, for their
    shapes; feature columns cut from FP to F)."""
    grads = {k: flat[off : off + r * c].view(r, c) for k, (off, (r, c)) in lay.outs.items()}
    grads.update({k: flat[lay.n_dw + off : lay.n_dw + off + w] for k, (off, w) in lay.bias.items()})
    dtrunk = [(unpad_trunk_grad(grads[f"trunk{i}_w"], i, skips, in0), grads[f"trunk{i}_b"]) for i in range(D)]
    dp = unpad_feat({k: grads[k] for k in heads}, F)
    return dtrunk, {k: v.reshape(heads[k].shape) for k, v in dp.items()}


def _bwd_dw_plain(walk, x0, lay: DwLayout, biases, n_cut, slab_rows: Optional[int], precision: str):
    """Per slab of rows (slab_rows, heads_slab_rows by default): walk(r0, r1,
    ops) runs the plain backward on the rows [r0, r1) and fills ops;
    heads_operands_plain stores them, dw_gemm_plain sums them into the flat
    result (written by the first slab, added to by the others). Returns (the
    walk's per-row outputs concatenated, the flat result)."""
    prec = canonical_precision(precision)
    dtype = torch.bfloat16 if prec == "bfloat16" else torch.float32
    N = x0.shape[0]
    slab = slab_rows or heads_slab_rows(lay, N, dtype.itemsize)
    flat = torch.empty((lay.n_dw + lay.nb,), dtype=torch.float32, device=x0.device)
    outs = []
    for r0 in range(0, N, slab):
        r1 = min(N, r0 + slab)
        ops = {}
        outs.append(walk(r0, r1, ops))
        buf, rows = heads_operands_plain(ops, lay, r1 - r0, BWD_TILE[prec], dtype, biases)
        dw_gemm.dw_gemm_plain([buf], lay.jobs, flat, lay.n_dw, rows, r0 > 0)
    cat = [None if parts[0] is None else torch.cat(parts) for parts in list(zip(*outs))[:n_cut]]
    return cat, flat


def fused_trunk_heads_bwd_dw_plain(x0, c_emb, trunk, heads, skips, precision, cots, slab_rows: Optional[int] = None):
    """The backward as the CUDA route splits it, in plain PyTorch: per slab
    of rows, the plain backward (fused_trunk_heads_bwd_plain) with its
    operands stored into the buffers of heads_dw_layout (rounded to the
    compute dtype; a bias row a tile of BWD_TILE rows) and dw_gemm_plain on
    them. Returns as fused_trunk_heads_bwd_plain."""
    D, W, F = len(trunk), trunk[0][1].shape[0], heads["feat_b"].shape[0]
    C = 0 if c_emb is None else c_emb.shape[1]
    HC = heads["c2_w"].shape[1] if C else 0
    bf16 = canonical_precision(precision) == "bfloat16"
    lay = heads_dw_layout(D, tuple(skips), W, feat_pad(F, bf16), HC, C)
    cut = lambda t, r0, r1: None if t is None else t[r0:r1]  # noqa: E731

    def walk(r0, r1, ops):
        cs = [cut(c, r0, r1) for c in cots]
        return fused_trunk_heads_bwd_plain(x0[r0:r1], cut(c_emb, r0, r1), trunk, heads, skips, precision, cs, ops)

    names = HEAD_KEYS + (CAND_KEYS if C else ())
    (dx0, dc_emb), flat = _bwd_dw_plain(walk, x0, lay, heads_dw_biases(D, True, C > 0), 2, slab_rows, precision)
    return (dx0, dc_emb, *heads_dw_result(flat, lay, D, skips, x0.shape[1], F, {k: heads[k] for k in names}))


# The Hopper kernels' weight streams (csrc/heads_fwd.cu:wg_fwd_kernel,
# csrc/heads_bwd.cu:wg_bwd_kernel): one tile's K-strips in the order its consumers
# read them, packed by pack_wgmma, then the narrow heads.
WG_NARROW = 8  # the sigma heads' columns, zero-padded: wgmma's smallest N
WG_HEADS_BYTES = 8192


class _Stream:
    """A weight stream in the making, from the shapes alone: index matrices
    packed as K-strips (pack_wgmma) under a key each, and the schedule of
    (byte offset, bytes) of the strips in the order a kernel reads them."""

    def __init__(self):
        self.parts, self.pieces, self.size, self.sched = [], {}, 0, []

    def add(self, key, idx: torch.Tensor, nb: int) -> None:
        self.parts.append(pack_wgmma(idx, nb))
        self.pieces[key] = (self.size, idx.shape[0], idx.shape[1] // nb, nb)
        self.size += self.parts[-1].numel()

    def strips(self, key, blocks=None) -> None:
        """Piece key's K-strips into the schedule: each block of nb columns
        (all, or those named), its strips in K order."""
        start, K, n_blocks, nb = self.pieces[key]
        for b in range(n_blocks) if blocks is None else blocks:
            for ks in range(K // 64):
                self.sched.append((2 * (start + (b * (K // 64) + ks) * 64 * nb), 128 * nb))

    def narrow(self, sigma_w: torch.Tensor, csig_w: Optional[torch.Tensor], HC: int) -> None:
        """The narrow heads' 8 KB (sigma_w, then csig_w or zeros, at WG_NARROW
        columns), last in the stream and the schedule."""
        parts = [pack_wgmma(_cols(sigma_w, WG_NARROW), WG_NARROW)]
        parts.append(pack_wgmma(_cols(csig_w, WG_NARROW) if csig_w is not None else _zeros(HC, WG_NARROW),
                                WG_NARROW))
        parts.append(_zeros(WG_HEADS_BYTES // 2 - sum(t.numel() for t in parts), 1).reshape(-1))
        self.sched.append((2 * self.size, WG_HEADS_BYTES))
        self.parts += parts

    def done(self):
        return torch.cat(self.parts), tuple(self.sched)


def _zeros(k: int, n: int) -> torch.Tensor:
    return torch.zeros((k, n), dtype=torch.int64)


def _cols(t: torch.Tensor, n: int) -> torch.Tensor:
    """t's columns zero-padded (index 0) to n."""
    return torch.cat([t, _zeros(t.shape[0], n - t.shape[1])], 1)


def _stream_sources(D: int, skips, in0: int, W: int, HC: int, C: int, F: int) -> Dict:
    """Each weight's index matrix into the flat concatenation [0, the trunk's
    weights, then (C >= 0: the heads) sigma_w, xyzf_w, feat_w, and with C > 0
    c1_w, c2_w, csig_w, cfeat_w] (0: a padded zero)."""
    src, at = {}, 1
    sizes = [(f"t{i}", (in0 if i == 0 else (in0 + W if i in skips else W), W)) for i in range(D)]
    if C >= 0:
        sizes += [("sigma_w", (W, 1)), ("xyzf_w", (W, W)), ("feat_w", (W, F))]
    if C > 0:
        sizes += [("c1_w", (W + C, HC)), ("c2_w", (HC, HC)), ("csig_w", (HC, 1)), ("cfeat_w", (HC, F))]
    for name, (k, n) in sizes:
        src[name] = torch.arange(at, at + k * n, dtype=torch.int64).reshape(k, n)
        at += k * n
    return src


def _add_chain(st: _Stream, src: Dict, D: int, skips, in0: int, W: int, C: int):
    """The chain's products as the forward computes them (the backward's
    rebuild streams the same strips): each trunk layer (x0 rows zero-padded
    to X0_PAD at layer 0 and the skip layers), then with the heads xyzf, with
    the candidate branch c1 ([c_emb rows zero-padded to X0_PAD | xyzf's W
    rows]) and c2; columns in blocks of 128. Returns (the padded trunk, the
    padded c_emb rows of c1 or None)."""
    trunk = [_pad_x0_rows(src[f"t{i}"], in0) if i == 0 or i in skips else src[f"t{i}"] for i in range(D)]
    for i in range(D):
        st.add(("fwd", i), trunk[i], 128)
    if C >= 0:
        st.add("xyzf", src["xyzf_w"], 128)
    cpad = None
    if C > 0:
        c1 = src["c1_w"]
        cpad = torch.cat([c1[W:], _zeros(X0_PAD - C, c1.shape[1])])
        st.add("c1", torch.cat([cpad, c1[:W]]), 128)
        st.add("c2", src["c2_w"], 128)
    return trunk, cpad


def _chain_strips(st: _Stream, D: int, heads: bool) -> None:
    """The trunk's strips, layer by layer and half by half, then xyzf's."""
    for i in range(D):
        st.strips(("fwd", i))
    if heads:
        st.strips("xyzf")


@functools.lru_cache(maxsize=64)
def _bwd_wgmma_plan(D: int, skips: Tuple[int, ...], in0: int, W: int, FP: int, HC: int, C: int, F: int):
    """The gather that packs the backward's weights (bf16) and its schedule,
    from the shapes alone: (index, sched). index (int64, CPU) maps each
    packed element to its source in the flat concatenation of
    _stream_sources (0: a padded zero). C = -1: the trunk-only mode. sched:
    (byte offset, bytes) of each K-strip, then of the narrow heads' 8 KB
    (with the heads): the rebuild (the forward's chain), then the walk."""
    heads, cand = C >= 0, C > 0
    src = _stream_sources(D, skips, in0, W, HC, C, F)
    st = _Stream()
    trunk, cpad = _add_chain(st, src, D, skips, in0, W, C)
    if cand:
        c1 = src["c1_w"]
        st.add("cfeat_t", _cols(src["cfeat_w"], FP).t(), 128)
        st.add("c2_t", src["c2_w"].t(), 128)
        st.add("c1c_t", cpad.t(), 64)
        st.add("c1x_t", c1[:W].t(), 128)
    if heads:
        st.add("feat_t", _cols(src["feat_w"], FP).t(), 128)
        st.add("xyzf_t", src["xyzf_w"].t(), 128)
    for i in range(D):
        wt = trunk[i].t()
        if i == 0 or i in skips:
            st.add(("x0_t", i), wt[:, :X0_PAD], 64)
        if i > 0:
            st.add(("h_t", i), wt[:, X0_PAD:] if i in skips else wt, 128)

    _chain_strips(st, D, heads)  # the rebuild
    if cand:
        st.strips("c1")
        st.strips("c2")
        st.strips("cfeat_t")  # the walk: the candidate branch
        st.strips("c2_t")
        st.strips("c1c_t")
    if heads:
        for b in range(W // 128):  # g_xyzf's halves: feat, then c1's xyzf part
            st.strips("feat_t", [b])
            if cand:
                st.strips("c1x_t", [b])
        st.strips("xyzf_t")
    for i in reversed(range(D)):  # the trunk, last layer first: x0's columns, then the halves
        if i == 0 or i in skips:
            st.strips(("x0_t", i))
        if i > 0:
            st.strips(("h_t", i))
    if heads:
        st.narrow(src["sigma_w"], src["csig_w"] if cand else None, HC)
    return st.done()


@functools.lru_cache(maxsize=64)
def _fwd_wgmma_plan(D: int, skips: Tuple[int, ...], in0: int, W: int, FP: int, HC: int, C: int, F: int):
    """The forward's gather and schedule, as _bwd_wgmma_plan's: the trunk
    and xyzf (the strips the backward's rebuild streams first), then feat
    untransposed (FP columns in blocks of 128, or one of 64 at FP = 64), then
    with the candidate branch c1, c2 and cfeat (as feat); the narrow heads
    last."""
    heads, cand = C >= 0, C > 0
    src = _stream_sources(D, skips, in0, W, HC, C, F)
    st = _Stream()
    _add_chain(st, src, D, skips, in0, W, C)
    NB = min(FP, 128)
    if heads:
        st.add("feat", _cols(src["feat_w"], FP), NB)
    if cand:
        st.add("cfeat", _cols(src["cfeat_w"], FP), NB)
    _chain_strips(st, D, heads)
    if heads:
        st.strips("feat")
    if cand:
        for key in ("c1", "c2", "cfeat"):
            st.strips(key)
    if heads:
        st.narrow(src["sigma_w"], src["csig_w"] if cand else None, HC)
    return st.done()


_STREAM_INDEX: Dict[tuple, torch.Tensor] = {}  # each plan's index on each device


def _wgmma_weights(plan, trunk, heads: Optional[Dict[str, torch.Tensor]], skips, in0: int, C: int):
    """The bf16 weights of a Hopper kernel as one flat tensor, and the
    schedule its producer streams for every tile (plan: _fwd_wgmma_plan or
    _bwd_wgmma_plan); heads None: the trunk-only mode. A call runs one
    concatenation, one gather and one rounding on the device."""
    W = trunk[0][1].shape[0]
    mats = [w for w, _ in trunk]
    F, FP, HC = 0, 64, 0
    if heads is not None:
        F = heads["feat_b"].shape[0]
        FP = feat_pad(F, True)
        mats += [heads[k] for k in ("sigma_w", "xyzf_w", "feat_w")]
        if C:
            HC = heads["c2_w"].shape[1]
            mats += [heads[k] for k in ("c1_w", "c2_w", "csig_w", "cfeat_w")]
    key = (len(trunk), tuple(skips), in0, W, FP, HC, C if heads is not None else -1, F)
    index, sched = plan(*key)
    dev = trunk[0][0].device
    if (plan, key, dev) not in _STREAM_INDEX:
        _STREAM_INDEX[(plan, key, dev)] = index.to(dev)
    flat = torch.cat([mats[0].new_zeros(1)] + [m.reshape(-1) for m in mats])
    return flat[_STREAM_INDEX[(plan, key, dev)]].to(torch.bfloat16), list(sched)


def _bwd_wgmma_weights(trunk, heads, skips, in0: int, C: int):
    """The Hopper backward's stream (_wgmma_weights of _bwd_wgmma_plan)."""
    return _wgmma_weights(_bwd_wgmma_plan, trunk, heads, skips, in0, C)


def _fwd_wgmma_weights(trunk, heads, skips, in0: int, C: int):
    """The Hopper forward's stream (_wgmma_weights of _fwd_wgmma_plan)."""
    return _wgmma_weights(_fwd_wgmma_plan, trunk, heads, skips, in0, C)


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


# The forward's bfloat16 designs: the route's Hopper kernel (wg_fwd_kernel), and for
# timing only the mma.sync design it replaced, built as a variant (_build.VARIANTS)
# that chip_smoke.py (phases 14 and 16, --kernel_times) and the card tests select.
HEADS_FWD_DESIGNS = ("wgmma", "mma_sync")
HEADS_FWD_LIBS = {"wgmma": "heads_fwd", "mma_sync": "heads_fwd_mma_sync"}


def fused_trunk_heads_fwd_launch(x0, c_emb, trunk, heads, skips, precision: str = "float32",
                                 design: str = "wgmma") -> Tuple[torch.Tensor, ...]:
    """One launch of csrc/heads_fwd.cu on CUDA tensors, checked: kernel 5's
    forward (fused_trunk_heads_fwd's outputs), or with heads None the
    trunk-only mode (kernel 6's: (h (N, W),), mlp.fused_trunk_fwd). design,
    one of HEADS_FWD_DESIGNS, picks the bfloat16 kernel: "wgmma" (the
    routes'), or "mma_sync" (a timing variant no route reaches; the float32
    kernel is the same in both). Counts no launch."""
    from upnerf_torch.ops import _build

    if design not in HEADS_FWD_DESIGNS:
        raise ValueError(f"design must be one of {HEADS_FWD_DESIGNS}, got {design!r}")
    if heads is None:
        _check_trunk_args(x0, trunk, skips)
    else:
        _check_args(x0, c_emb, trunk, heads, skips)
    N, in0 = x0.shape
    C = 0 if c_emb is None else c_emb.shape[1]
    W, F = KERNEL_WIDTHS["W"], 0 if heads is None else heads["feat_b"].shape[0]
    bf16 = canonical_precision(precision) == "bfloat16"
    hopper = bf16 and design == "wgmma"
    dev = x0.device
    tb = [b.contiguous() for _, b in trunk]
    wpack, sched, n_sched, in_rows = None, None, 0, None
    if hopper:  # the matrices in one packed stream; the kernel reads the biases beside it
        wpack, pairs = _fwd_wgmma_weights(trunk, heads, skips, in0, C)
        sched = (ctypes.c_int * (2 * len(pairs)))(*[v for pair in pairs for v in pair])
        n_sched = len(pairs) - (heads is not None)
        in_rows = torch.empty((N, 2 * X0_PAD if C else X0_PAD), dtype=torch.bfloat16, device=dev)
        tw = [None] * len(trunk)
    else:
        tw = [_layout(w, bf16) for w in _padded_trunk(trunk, skips, in0)]
    f32 = dict(dtype=torch.float32, device=dev)
    hw = None
    if heads is None:
        outs = [torch.empty((N, W), **f32)]
    else:
        cdt = torch.bfloat16 if bf16 else torch.float32
        hp = pad_feat(heads, feat_pad(F, bf16))
        mat = (lambda t: None) if hopper else (lambda t: _layout(t, bf16))  # noqa: E731
        vec = (lambda t: None) if hopper else (lambda t: t.reshape(-1).to(cdt).contiguous())  # noqa: E731
        hw = [vec(hp["sigma_w"]), hp["sigma_b"].contiguous(), mat(hp["xyzf_w"]), hp["xyzf_b"].contiguous(),
              mat(hp["feat_w"]), hp["feat_b"].contiguous()]
        if C:
            hw += [mat(_c1_padded(hp["c1_w"], W)), hp["c1_b"].contiguous(), mat(hp["c2_w"]), hp["c2_b"].contiguous(),
                   vec(hp["csig_w"]), hp["csig_b"].contiguous(), mat(hp["cfeat_w"]), hp["cfeat_b"].contiguous()]
        else:
            hw += [None] * len(CAND_KEYS)
        outs = [torch.empty((N, 1), **f32), torch.empty((N, F), **f32)]
        if C:
            outs += [torch.empty((N, 1), **f32), torch.empty((N, F), **f32)]
    x0 = x0.contiguous()
    ce = c_emb.contiguous() if C else None
    lib = _build.library(HEADS_FWD_LIBS[design] if bf16 else "heads_fwd")
    skip_mask = sum(1 << i for i in skips if 0 < i < len(trunk))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.upnerf_heads_fwd(x0.data_ptr(), ce.data_ptr() if C else None, _ptrs(tw), _ptrs(tb), len(trunk),
                                    skip_mask, None if hw is None else _ptrs(hw),
                                    _ptrs(outs + [None] * (4 - len(outs))), N, in0, C, F, int(bf16),
                                    None if wpack is None else wpack.data_ptr(), sched, n_sched,
                                    None if in_rows is None else in_rows.data_ptr(), stream)
    _raise_on(code, "heads_fwd" if heads is not None else "heads_fwd (trunk only)", lib)
    return tuple(outs)


def fused_trunk_heads_fwd(x0, c_emb, trunk, heads, skips, precision: str = "float32") -> Tuple[torch.Tensor, ...]:
    """Forward: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (in bfloat16 mode the Hopper design); the same arguments and
    outputs either way, all f32. The kernel takes W = 256, F in
    render_train.KERNEL_F, HC = 128, 3 + 6L <= 64, D <= 16, C <= 64; it
    computes no gradient (train through `fused_trunk_heads`)."""
    if x0.device.type == "cpu":
        return fused_trunk_heads_plain(x0, c_emb, trunk, heads, skips, precision)
    if x0.device.type != "cuda":
        raise ValueError(f"no heads kernel for device {x0.device}")
    global launches
    tensors = [x0, c_emb, *heads.values()] + [t for wb in trunk for t in wb]
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("the CUDA heads kernel is forward-only: run it under torch.no_grad()"
                           " or train through fused_trunk_heads")
    outs = fused_trunk_heads_fwd_launch(x0, c_emb, trunk, heads, skips, precision)
    launches += 1
    return outs


class BwdCall:
    """One backward call of csrc/heads_bwd.cu on checked arguments: kernel 5's
    (the trunk + heads), or with heads None the trunk-only mode (kernel 6's,
    cots [g (N, W)]); prepared (weights, buffers) but not launched. `run()`
    launches it: per slab of rows (heads_slab_rows), the kernel stores the
    slab's dW operands and bias rows (heads_dw_layout), then dw_gemm sums
    them into the flat result, the first slab writing it and the others
    adding to it. `walk(r0, r1)` and `dw(r0, r1)` launch one slab's kernels
    on their own, for timing. bfloat16 mode streams the weights packed once a
    call (_bwd_wgmma_weights); float32 mode reads them row-major."""

    def __init__(self, x0, c_emb, trunk, heads, skips, precision, cots):
        from upnerf_torch.ops import _build

        N, in0 = x0.shape
        D, W, dev = len(trunk), KERNEL_WIDTHS["W"], x0.device
        C = 0 if c_emb is None else c_emb.shape[1]
        HC = KERNEL_WIDTHS["HC"]
        F = 0 if heads is None else heads["feat_b"].shape[0]
        self.prec = canonical_precision(precision)
        bf16 = self.prec == "bfloat16"
        cdt = torch.bfloat16 if bf16 else torch.float32
        FP = feat_pad(F, bf16) if heads is not None else 64
        f32 = dict(dtype=torch.float32, device=dev)
        self.lay = heads_dw_layout(D, tuple(skips), W, FP, HC if C else 0, C, heads is not None)
        ops = self.lay.ops
        assert all(ops[f"act{i}"] == ops["act0"] + i * W and ops[f"g_act{i}"] == ops["g_act0"] + i * W
                   for i in range(D)), "the kernel reads the trunk's operands at i W from the first"
        self.slab = heads_slab_rows(self.lay, N, cdt.itemsize)
        self.tile = BWD_TILE[self.prec]
        padded = _padded_trunk(trunk, skips, in0)
        tb = [b.contiguous() for _, b in trunk]
        if bf16:
            self.wpack, sched = _bwd_wgmma_weights(trunk, heads, skips, in0, C)
            self.sched = (ctypes.c_int * (2 * len(sched)))(*[v for pair in sched for v in pair])
            self.n_sched = len(sched) - (heads is not None)
            tw = tT = None
        else:
            self.wpack, self.sched, self.n_sched = None, None, 0
            tw = [w.contiguous() for w in padded]
            tT = [w.t().contiguous() for w in padded]
        w, b = [], []
        if heads is not None:
            kh = pad_feat(heads, FP)
            rnd = (lambda t: t.reshape(-1).bfloat16().float().contiguous()) if bf16 else (  # noqa: E731
                lambda t: t.reshape(-1).contiguous())
            w = [rnd(heads["sigma_w"]), rnd(heads["csig_w"]) if C else None]
            if not bf16:
                w += [heads["xyzf_w"].contiguous(), heads["xyzf_w"].t().contiguous(), kh["feat_w"].t().contiguous()]
                if C:
                    c1 = heads["c1_w"]
                    w += [_c1_padded(c1, W), c1[:W].t().contiguous(), c1[W:].contiguous(), heads["c2_w"].contiguous(),
                          heads["c2_w"].t().contiguous(), kh["cfeat_w"].t().contiguous()]
                else:
                    w += [None] * 6
            b = [heads["xyzf_b"].contiguous(), heads["sigma_b"].contiguous()] + (
                [heads[k].contiguous() for k in ("c1_b", "c2_b", "csig_b")] if C else [None] * 3)
        self.dx0 = torch.empty((N, in0), **f32)
        self.dcemb = torch.empty((N, C), **f32) if C else None
        rows = -(-self.slab // SLAB_ALIGN) * SLAB_ALIGN
        self.ops = torch.empty((rows, self.lay.ops_w), dtype=cdt, device=dev)
        self.bias_rows = torch.empty((rows // self.tile, self.lay.nb), **f32)
        self.flat = torch.empty((self.lay.n_dw + self.lay.nb,), **f32)
        self.lib = _build.library("heads_bwd")
        self.x0 = x0.contiguous()
        self.c_emb = c_emb.contiguous() if C else None
        self.cots = [None if g is None else g.contiguous() for g in cots]
        self.layout = (ctypes.c_int * len(HEADS_LAYOUT))(*heads_layout_slots(self.lay))
        self._w = (None if tw is None else _ptrs(tw), _ptrs(tb), None if tT is None else _ptrs(tT), _ptrs(w), _ptrs(b))
        self._keep = (tw, tb, tT, w, b)  # what the pointers point at
        self.skip_mask = sum(1 << i for i in skips if 0 < i < D)
        self.heads = heads
        self.N, self.in0, self.C, self.F, self.D, self.skips, self.dev = N, in0, C, F, D, skips, dev
        self.name = "heads_bwd" if heads is not None else "heads_bwd (trunk only)"

    def walk(self, r0: int, r1: int) -> None:
        """The kernel over rows [r0, r1): one launch (two in bfloat16 mode: its
        x0 / c_emb rows first)."""
        n = r1 - r0
        cut = lambda t, per=1: None if t is None else t[r0 * per : r1 * per]  # noqa: E731
        cots = [cut(g) for g in self.cots]
        tw, tb, tT, w, b = self._w
        stream = torch.cuda.current_stream(self.dev).cuda_stream
        ce = cut(self.c_emb)
        with torch.cuda.device(self.dev):
            code = self.lib.upnerf_heads_bwd(
                cut(self.x0).data_ptr(), None if ce is None else ce.data_ptr(), _ptrs(cots), tw, tb, tT, self.D,
                self.skip_mask, w, b, None if self.wpack is None else self.wpack.data_ptr(), self.sched,
                self.n_sched, _ptrs([cut(self.dx0), cut(self.dcemb)]), self.ops.data_ptr(), self.layout,
                self.bias_rows.data_ptr(), n, self.in0, self.C, self.F, int(self.prec == "bfloat16"),
                int(self.heads is not None), stream,
            )
        _raise_on(code, self.name, self.lib)

    def dw(self, r0: int, r1: int) -> None:
        """dw_gemm on the operands the kernel over rows [r0, r1) stored: the
        slab's weight and bias gradients written into the flat result (r0 =
        0) or added to it."""
        n = r1 - r0
        tiles = -(-n // self.tile)  # the bias rows the kernel wrote: in bfloat16 mode a block's two tiles
        tiles += tiles % 2 if self.prec == "bfloat16" else 0
        dw_gemm.dw_gemm([self.ops[:n]], self.lay.jobs, self.flat, self.lay.n_dw, self.bias_rows[:tiles], r0 > 0)

    def run(self):
        """The whole call: (dx0, dc_emb or None, [(dW, db)] per trunk layer,
        {head key: grad}) ({} in the trunk-only mode)."""
        for r0 in range(0, self.N, self.slab):
            r1 = min(self.N, r0 + self.slab)
            self.walk(r0, r1)
            self.dw(r0, r1)
        names = () if self.heads is None else HEAD_KEYS + (CAND_KEYS if self.C else ())
        hd = {} if self.heads is None else {k: self.heads[k] for k in names}
        return (self.dx0, self.dcemb, *heads_dw_result(self.flat, self.lay, self.D, self.skips, self.in0, self.F, hd))


def _check_cots(cots, shapes, dev):
    out = []
    for i, shape in enumerate(shapes):
        g = cots[i] if i < len(cots) else None
        if g is not None and (g.device != dev or g.dtype != torch.float32 or tuple(g.shape) != shape):
            raise ValueError(f"cotangent {i}: {g.device} {g.dtype} {tuple(g.shape)}, expected {dev} torch.float32"
                             f" {shape}")
        out.append(g)
    return out


def fused_trunk_heads_bwd_launch(x0, c_emb, trunk, heads, skips, precision, cots) -> BwdCall:
    """fused_trunk_heads_bwd's CUDA call, checked and prepared but not
    launched: to time its pieces (chip_smoke.py phase 16). Counts no launch."""
    _check_args(x0, c_emb, trunk, heads, skips)
    N, F = x0.shape[0], heads["feat_b"].shape[0]
    cots = _check_cots(cots, [(N, 1), (N, F), (N, 1), (N, F)], x0.device)
    names = HEAD_KEYS + (CAND_KEYS if c_emb is not None else ())
    return BwdCall(x0, c_emb, trunk, {k: heads[k] for k in names}, skips, precision, cots)


def fused_trunk_heads_bwd(x0, c_emb, trunk, heads, skips, precision, cots):
    """Backward: `fused_trunk_heads_bwd_plain` for CPU tensors, the CUDA
    kernels for CUDA tensors, with the same arguments and results. Per slab
    of rows the kernel rebuilds the chain and walks it, storing the weight
    gradients' operands (in bfloat16 mode the Hopper design on wgmma), and
    the dW kernel sums them in a fixed order: two calls on the same inputs
    give the same bits."""
    if x0.device.type == "cpu":
        return fused_trunk_heads_bwd_plain(x0, c_emb, trunk, heads, skips, precision, cots)
    if x0.device.type != "cuda":
        raise ValueError(f"no heads kernel for device {x0.device}")
    global bwd_launches
    out = fused_trunk_heads_bwd_launch(x0, c_emb, trunk, heads, skips, precision, cots).run()
    bwd_launches += 1
    return out


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
