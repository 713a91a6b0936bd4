"""Fused forward render of one NeRF pass (upnerf/ops/pallas_render_train.py).

The port covers the kernel's phase-2 inference mode: the rays frontend
(xyz = o + d z and the annealed PE built from per-ray origin/direction),
the trunk, the sigma/xyz_final/feat/rgb heads and the static compositing,
with no candidate branch, no feature output and no saved residuals. Its
outputs are s_weights (R, S), s_depth (R,) and rgb_map (R, 3).

- `render_train_rays_plain` is the plain PyTorch version (the JAX package's
  XLA twin, `xla_render_train_rays`): PE, trunk and heads as tensor ops,
  compositing by cumprod as in render/volume.py.
- `render_train_rays_fwd` is the wrapper: on CPU tensors it runs the plain
  version; on CUDA tensors it launches the hand-written kernel in
  `upnerf_torch/csrc/render_train_fwd.cu` or raises. It counts its launches
  in `launches`.

Weights come in the JAX kernel's interface: `trunk` is a sequence of
(W (in, out), b (out,)) pairs and `heads` holds xyzf_w/b, sigma_w/b,
feat_w/b, rgb1_w (F, HH; its bias is folded into ray_cond), rgb2_w/b.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from upnerf_torch.ops.linear import canonical_precision, matmul

LAST_DELTA = 1e2  # the last interval is quasi-infinite, as in render/volume.py

HEAD_KEYS = ("xyzf_w", "xyzf_b", "sigma_w", "sigma_b", "feat_w", "feat_b", "rgb1_w", "rgb2_w", "rgb2_b")
X0_PAD = 64  # the bf16 kernel's x0 width: 3 + 6L padded to a multiple of 16

# Number of kernel launches made by render_train_rays_fwd in this process.
launches = 0


class RTStatic(NamedTuple):
    """Static configuration of the forward: trunk depth, skip layers, PE
    bands of xyz, and the matmul precision ('bfloat16' or 'float32')."""

    D: int
    skips: Tuple[int, ...]
    xyz_L: int
    precision: str = "float32"


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Stable softplus max(x, 0) + log1p(exp(-|x|)), with no threshold
    (torch.nn.functional.softplus switches to x above 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def render_train_rays_plain(
    rays_o: torch.Tensor,  # (R, 3)
    rays_d: torch.Tensor,  # (R, 3)
    z_vals: torch.Tensor,  # (R, S)
    pe_w: torch.Tensor,  # (L,) annealed band weights
    ray_cond: torch.Tensor,  # (R, HH) per-ray rgb conditioning incl. bias
    trunk: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    heads: Dict[str, torch.Tensor],
    st: RTStatic,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch forward (xla_render_train_rays + xla_render_train)."""
    prec = canonical_precision(st.precision)
    L = st.xyz_L
    R, S = z_vals.shape
    xyz = (rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]).reshape(R * S, 3)
    freq = 2.0 ** torch.arange(L, dtype=torch.float32, device=xyz.device) * math.pi
    sp = xyz[:, :, None] * freq  # (M, 3, L)
    enc = torch.stack([torch.sin(sp) * pe_w, torch.cos(sp) * pe_w], dim=-2)
    x0 = torch.cat([xyz, enc.reshape(R * S, 6 * L)], dim=-1)

    h = x0
    for i, (w, b) in enumerate(trunk):
        if i in st.skips and i > 0:
            h = torch.cat([x0, h], dim=-1)
        h = torch.relu(matmul(h, w, prec) + b)
    sig = softplus(matmul(h, heads["sigma_w"], prec) + heads["sigma_b"]).reshape(R, S)
    xyzf = matmul(h, heads["xyzf_w"], prec) + heads["xyzf_b"]
    feat = matmul(xyzf, heads["feat_w"], prec) + heads["feat_b"]
    pre = matmul(feat, heads["rgb1_w"], prec).reshape(R, S, -1)
    rgbh = torch.relu(pre + ray_cond[:, None, :]).reshape(R * S, -1)
    rgb = torch.sigmoid(matmul(rgbh, heads["rgb2_w"], prec) + heads["rgb2_b"]).reshape(R, S, 3)

    delta = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], torch.full_like(z_vals[:, :1], LAST_DELTA)], -1)
    a_s = 1.0 - torch.exp(-delta * sig)
    ow = a_s * torch.cumprod(torch.cat([torch.ones_like(a_s[:, :1]), 1.0 - a_s[:, :-1]], -1), -1)
    return {
        "s_weights": ow,
        "s_depth": (ow * z_vals).sum(-1),
        "rgb_map": (ow[..., None] * rgb).sum(1),
    }


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


def _kernel_weights(trunk, heads: Dict[str, torch.Tensor], st: RTStatic):
    """Weights in the layout the CUDA kernel reads, each its own contiguous
    (so 16-byte aligned) tensor. float32 mode: every matrix (in, out), f32.
    bfloat16 mode: the trunk, xyzf, feat and rgb1 matrices packed by
    _pack_fragments, with the x0 rows of layer 0 and of the skip layers
    zero-padded to X0_PAD; sigma and rgb2 (in, out) in bf16. Biases f32."""
    if canonical_precision(st.precision) == "float32":
        return [(w.contiguous(), b.contiguous()) for w, b in trunk], {k: v.contiguous() for k, v in heads.items()}
    in0 = 3 + 6 * st.xyz_L
    out = []
    for i, (w, b) in enumerate(trunk):
        if i == 0 or i in st.skips:
            w = torch.cat([w[:in0], w.new_zeros(X0_PAD - in0, w.shape[1]), w[in0:]], 0)
        out.append((_pack_fragments(w), b.contiguous()))
    kheads = {}
    for k, v in heads.items():
        if k in ("xyzf_w", "feat_w", "rgb1_w"):
            v = _pack_fragments(v)
        elif k in ("sigma_w", "rgb2_w"):
            v = v.to(torch.bfloat16)
        kheads[k] = v.contiguous()
    return out, kheads


def render_train_rays_fwd(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: torch.Tensor,
    pe_w: torch.Tensor,
    ray_cond: torch.Tensor,
    trunk: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    heads: Dict[str, torch.Tensor],
    st: RTStatic,
) -> Dict[str, torch.Tensor]:
    """Forward render: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors; the same arguments either way, all f32.

    The CUDA kernel takes the repo model's widths (W=256, F=384, HH=128),
    3 + 6L <= 64 and D <= 16, and is forward only: inputs that require grad
    are refused while grad mode is on."""
    if rays_o.device.type == "cpu":
        return render_train_rays_plain(rays_o, rays_d, z_vals, pe_w, ray_cond, trunk, heads, st)
    if rays_o.device.type != "cuda":
        raise ValueError(f"no render kernel for device {rays_o.device}")
    global launches
    from upnerf_torch.ops import _build

    prec = canonical_precision(st.precision)
    dev = rays_o.device
    R, S = z_vals.shape
    L, D = st.xyz_L, len(trunk)
    if D != st.D:
        raise ValueError(f"trunk has {D} layers, st.D is {st.D}")
    W, F, HH = trunk[0][1].shape[0], heads["feat_b"].shape[0], ray_cond.shape[1]
    if (W, F, HH) != (256, 384, 128) or 3 + 6 * L > X0_PAD or D > 16:
        raise ValueError(f"the CUDA kernel takes W=256, F=384, HH=128, 3+6L <= 64, D <= 16; got {(W, F, HH, L, D)}")
    in0 = 3 + 6 * L
    _check("rays_o", rays_o, (R, 3), dev)
    _check("rays_d", rays_d, (R, 3), dev)
    _check("z_vals", z_vals, (R, S), dev)
    _check("pe_w", pe_w, (L,), dev)
    _check("ray_cond", ray_cond, (R, HH), dev)
    for i, (w, b) in enumerate(trunk):
        fan_in = in0 if i == 0 else (in0 + W if i in st.skips else W)
        _check(f"trunk[{i}].w", w, (fan_in, W), dev)
        _check(f"trunk[{i}].b", b, (W,), dev)
    shapes = {
        "xyzf_w": (W, W), "xyzf_b": (W,), "sigma_w": (W, 1), "sigma_b": (1,), "feat_w": (W, F),
        "feat_b": (F,), "rgb1_w": (F, HH), "rgb2_w": (HH, 3), "rgb2_b": (3,),
    }
    for k in HEAD_KEYS:
        _check(k, heads[k], shapes[k], dev)
    tensors = [rays_o, rays_d, z_vals, pe_w, ray_cond, *heads.values()] + [t for wb in trunk for t in wb]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the CUDA render kernel is forward-only: run it under torch.no_grad()")

    rays_o, rays_d, z_vals, pe_w, ray_cond = (t.contiguous() for t in (rays_o, rays_d, z_vals, pe_w, ray_cond))
    ktrunk, kheads = _kernel_weights(trunk, heads, st)
    s_weights = torch.empty((R, S), dtype=torch.float32, device=dev)
    s_depth = torch.empty((R,), dtype=torch.float32, device=dev)
    rgb_map = torch.empty((R, 3), dtype=torch.float32, device=dev)
    ptr_array = ctypes.c_void_p * D
    trunk_w = ptr_array(*[w.data_ptr() for w, _ in ktrunk])
    trunk_b = ptr_array(*[b.data_ptr() for _, b in ktrunk])
    skip_mask = sum(1 << i for i in st.skips if 0 < i < D)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = _build.library().upnerf_render_train_fwd(
            rays_o.data_ptr(), rays_d.data_ptr(), z_vals.data_ptr(), pe_w.data_ptr(), ray_cond.data_ptr(),
            trunk_w, trunk_b, D, skip_mask,
            *[kheads[k].data_ptr() for k in HEAD_KEYS],
            s_weights.data_ptr(), s_depth.data_ptr(), rgb_map.data_ptr(),
            R, S, L, W, F, HH, int(prec == "bfloat16"), stream,
        )
    if code != 0:
        msg = _build.library().upnerf_error_string(code).decode()
        raise RuntimeError(f"render_train_fwd kernel failed ({code}): {msg}")
    launches += 1
    return {"s_weights": s_weights, "s_depth": s_depth, "rgb_map": rgb_map}
