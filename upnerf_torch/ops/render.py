"""Fused phase-2 static render from pre-built PE rows
(upnerf/ops/pallas_render.py:fused_static_render).

Per ray r and sample s, from x0 (R*S, in0):
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
  read instead of built; any width in0 <= 64, as pallas_render.py:200 takes
  x0.shape[1]) or an error. The kernel builds T as
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


def fused_static_render_fwd(x0, z_vals, ray_cond, trunk, head, skips, precision: str = "float32"):
    """(rgb_map (R, 3), depth (R, 1), weights (R, S)): the plain version for CPU
    tensors, the x0 mode of the CUDA render kernel for CUDA tensors (the serving
    mode of render_train's x0 frontend). The kernel takes W = 256, F in
    render_train.KERNEL_F, HH = 128, in0 <= 64, D <= 16 and computes no
    gradient (train through `fused_static_render`)."""
    if x0.device.type == "cpu":
        return fused_static_render_plain(x0, z_vals, ray_cond, trunk, head, skips, precision)
    if x0.device.type != "cuda":
        raise ValueError(f"no render kernel for device {x0.device}")
    global launches
    R, S = z_vals.shape
    in0 = x0.shape[1]
    st = rt.RTStatic(D=len(trunk), skips=tuple(skips), xyz_L=0, precision=precision)
    rt._check_kernel_args({"x0": (x0, (R * S, in0))}, in0, z_vals, ray_cond, None, trunk, head, st)
    rt._refuse_grad([x0, ray_cond, *head.values()] + [t for wb in trunk for t in wb], "fused_static_render")
    out, _ = rt._launch_fwd([None, None, z_vals, None, ray_cond, None, x0], in0, 0, z_vals, ray_cond, trunk, head, st,
                            None, False, True)
    launches += 1
    return out["rgb_map"], out["s_depth"][:, None], out["s_weights"]


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
