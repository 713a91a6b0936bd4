"""Fused phase-2 static render from pre-built PE rows
(upnerf/ops/pallas_render.py:fused_static_render).

Per ray r and sample s, from x0 (R*S, 3 + 6L):
  h = trunk(x0), sigma = softplus(h Ws + bs), feat = (h Wx + bx) Wf + bf,
  rgb = sigmoid(relu(feat Wr1 + ray_cond_r) Wr2 + br2),
  alpha = 1 - exp(-delta sigma) (last delta 1e2), w = alpha T,
  rgb_map = sum_s w rgb, depth = sum_s w z.

- `fused_static_render_plain` is the plain PyTorch version, the JAX package's
  XLA twin `xla_static_render`: the plain trunk and heads of ops/mlp.py and
  ops/heads.py, then T by an exclusive cumprod of 1 - alpha.
- `fused_static_render_fwd` is the wrapper: on CPU tensors the plain version,
  on CUDA tensors the x0 mode of the fused render kernel
  (`csrc/render_train_fwd.cu`, flag X0_IN: the serving mode with the PE rows
  read instead of built) or an error. The kernel builds T as
  exp(-sum_{t<s} delta_t sigma_t), the TPU kernel as
  exp(excl_cumsum(log(max(1 - alpha, 1e-24)))); the two agree until
  delta sigma passes ~55, where T is 0 to f32 in both. Launches are counted in
  `launches` (apart from the rays modes' counter in ops/render_train.py).
- `fused_static_render` is the differentiable entry: its backward replays
  autograd through the plain version, as the JAX package's VJP replays XLA
  (pallas_render.py:233-248). No path of the port differentiates it today.

Weights come in the JAX kernel's interface: `trunk` is a sequence of
(W (in, out), b (out,)) pairs and `head` holds HEAD_KEYS; rgb1_w is the
first F rows of rgb1 (its other rows and its bias are in ray_cond).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from upnerf_torch.ops import render_train as rt
from upnerf_torch.ops.heads import _heads_fwd
from upnerf_torch.ops.linear import canonical_precision, matmul
from upnerf_torch.ops.mlp import fused_trunk_plain

HEAD_KEYS = ("sigma_w", "sigma_b", "xyzf_w", "xyzf_b", "feat_w", "feat_b", "rgb1_w", "rgb2_w", "rgb2_b")
X0_IN = 128  # render_common.cuh:Flag

# Kernel launches made in this process by fused_static_render_fwd.
launches = 0


def fused_static_render_plain(
    x0: torch.Tensor,  # (R*S, in0) PE rows
    z_vals: torch.Tensor,  # (R, S)
    ray_cond: torch.Tensor,  # (R, HH) per-ray dir / appearance term incl. rgb1's bias
    trunk: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    head: Dict[str, torch.Tensor],
    skips: Tuple[int, ...],
    precision: str = "float32",
):
    """(rgb_map (R, 3), depth (R, 1), weights (R, S)), plain PyTorch."""
    prec = canonical_precision(precision)
    R, S = z_vals.shape
    f = _heads_fwd(fused_trunk_plain(x0, trunk, skips, prec), None, head, prec)
    sigma = f["s_sigma"].reshape(R, S)
    rgbh = torch.relu(matmul(f["s_feat"], head["rgb1_w"], prec).reshape(R, S, -1) + ray_cond[:, None, :])
    rgb = torch.sigmoid(matmul(rgbh.reshape(R * S, -1), head["rgb2_w"], prec) + head["rgb2_b"]).reshape(R, S, 3)
    alpha = 1.0 - torch.exp(-rt._deltas(z_vals) * sigma)
    _, w = rt._cumprod_weights(alpha)
    return (w[..., None] * rgb).sum(1), (w * z_vals).sum(1, keepdim=True), w


def _check_args(x0, z_vals, ray_cond, trunk, head, skips) -> int:
    """Device, dtype and shape checks of what the kernel reads; returns L."""
    R, S = z_vals.shape
    in0 = x0.shape[1]
    L = (in0 - 3) // 6
    W, HH, F = rt.KERNEL_WIDTHS["W"], rt.KERNEL_WIDTHS["HH"], head["feat_b"].shape[0]
    rt.check_feat_width(F)
    if in0 != 3 + 6 * L or in0 > rt.X0_PAD or not 0 < len(trunk) <= 16:
        raise ValueError(f"the CUDA render kernel takes x0 of 3 + 6L <= {rt.X0_PAD} columns and D <= 16;"
                         f" got {in0} columns, D = {len(trunk)}")
    shapes = {"sigma_w": (W, 1), "sigma_b": (1,), "xyzf_w": (W, W), "xyzf_b": (W,), "feat_w": (W, F),
              "feat_b": (F,), "rgb1_w": (F, HH), "rgb2_w": (HH, 3), "rgb2_b": (3,)}
    named = [("x0", x0, (R * S, in0)), ("z_vals", z_vals, (R, S)), ("ray_cond", ray_cond, (R, HH))]
    for i, (w, b) in enumerate(trunk):
        fan_in = in0 if i == 0 else (in0 + W if i in skips else W)
        named += [(f"trunk[{i}].w", w, (fan_in, W)), (f"trunk[{i}].b", b, (W,))]
    named += [(k, head[k], shapes[k]) for k in HEAD_KEYS]
    for name, t, shape in named:
        if t.device != x0.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.device} {t.dtype} {tuple(t.shape)}; the kernel takes {x0.device}"
                             f" torch.float32 {shape} (W = {W}, F = {F}, HH = {HH})")
    return L


def fused_static_render_fwd(x0, z_vals, ray_cond, trunk, head, skips, precision: str = "float32"):
    """(rgb_map (R, 3), depth (R, 1), weights (R, S)): the plain version for CPU
    tensors, the x0 mode of the CUDA render kernel for CUDA tensors. The kernel
    takes W = 256, F in render_train.KERNEL_F, HH = 128, 3 + 6L <= 64, D <= 16
    and computes no gradient (train through `fused_static_render`)."""
    if x0.device.type == "cpu":
        return fused_static_render_plain(x0, z_vals, ray_cond, trunk, head, skips, precision)
    if x0.device.type != "cuda":
        raise ValueError(f"no render kernel for device {x0.device}")
    global launches
    from upnerf_torch.ops import _build

    L = _check_args(x0, z_vals, ray_cond, trunk, head, skips)
    tensors = [x0, ray_cond, *head.values()] + [t for wb in trunk for t in wb]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the CUDA render kernel is forward-only: run it under torch.no_grad()"
                           " or through fused_static_render")
    R, S = z_vals.shape
    st = rt.RTStatic(D=len(trunk), skips=tuple(skips), xyz_L=L, precision=precision)
    F = head["feat_b"].shape[0]
    FP = rt.feat_pad(F, canonical_precision(precision) == "bfloat16")
    ktrunk, kheads = rt._kernel_weights(trunk, rt.pad_feat({k: head[k] for k in st.head_keys}, FP), st)
    dev = x0.device
    f32 = dict(dtype=torch.float32, device=dev)
    w, depth, rgb_map = torch.empty((R, S), **f32), torch.empty((R,), **f32), torch.empty((R, 3), **f32)
    ins = [None, None, z_vals.contiguous(), None, ray_cond.contiguous(), None, x0.contiguous()]
    outs = [w, depth, rgb_map] + [None] * 10
    lib = _build.library("render_train_fwd")
    skip_mask = sum(1 << i for i in skips if 0 < i < len(trunk))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.upnerf_render_train_fwd(
            rt._ptrs(ins), rt._ptrs([k for k, _ in ktrunk]), rt._ptrs([b for _, b in ktrunk]), len(trunk), skip_mask,
            rt._ptrs([kheads.get(k) for k in rt.HEAD_KEYS]), rt._ptrs(outs), R, S, L, 0, F,
            rt._flags(st, False) | X0_IN, stream,
        )
    rt._raise_on(code, "render_train_fwd (x0 mode)", lib)
    launches += 1
    return rgb_map, depth[:, None], w


class FusedStaticRender(torch.autograd.Function):
    """The forward kernel, and a backward by autograd through the plain version.

    apply(x0, z_vals, ray_cond, skips, precision, *trunk_flat, *head_tensors)
    -> (rgb_map, depth, weights)."""

    @staticmethod
    def forward(ctx, x0, z_vals, ray_cond, skips, precision, *weights):
        D = (len(weights) - len(HEAD_KEYS)) // 2
        trunk = [(weights[2 * i], weights[2 * i + 1]) for i in range(D)]
        head = dict(zip(HEAD_KEYS, weights[2 * D :]))
        ctx.skips, ctx.precision, ctx.D = skips, precision, D
        ctx.save_for_backward(x0, z_vals, ray_cond, *weights)
        return fused_static_render_fwd(x0, z_vals, ray_cond, trunk, head, skips, precision)

    @staticmethod
    def backward(ctx, *grads):
        x0, z_vals, ray_cond, *weights = ctx.saved_tensors
        D = ctx.D
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (x0, ray_cond, *weights)]
            trunk = [(leaves[2 + 2 * i], leaves[3 + 2 * i]) for i in range(D)]
            head = dict(zip(HEAD_KEYS, leaves[2 + 2 * D :]))
            outs = fused_static_render_plain(leaves[0], z_vals, leaves[1], trunk, head, ctx.skips, ctx.precision)
            g = torch.autograd.grad(outs, leaves, grads, allow_unused=True)
        return (g[0], None, g[1], None, None, *g[2:])


def fused_static_render(x0, z_vals, ray_cond, trunk, head, skips, precision: str = "float32"):
    """Differentiable (rgb_map (R, 3), depth (R, 1), weights (R, S)) through
    FusedStaticRender."""
    flat = [t for wb in trunk for t in wb] + [head[k] for k in HEAD_KEYS]
    return FusedStaticRender.apply(x0, z_vals, ray_cond, tuple(skips), precision, *flat)
