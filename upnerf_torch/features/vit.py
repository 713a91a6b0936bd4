"""Vision Transformer backbone (DINO-style) as plain functions over a
parameter dict (upnerf/features/vit.py).

The dino-vit-features tricks the extractors rely on: the patch-embed
stride override (overlapping patches, a denser token grid), the bicubic
positional-embedding resize to that grid, and the attention 'key' facet of
one block.

Parameters are a nested dict of float32 tensors with the npz layout's keys
(upnerf/features/vit.py:11-17), in the port's layouts: the patch-embed
conv (D, 3, P, P) (torch's OIHW), every linear (in, out) for `x @ w + b`.
`upnerf_torch.utils.weights.vit_params_from_jax` builds it from the npz
layout; `init_vit_params` draws a random tree in the npz layout.

Images and tokens keep the JAX package's layouts: the image is (H, W, 3),
tokens are (1, 1 + N, D).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from upnerf_torch.ops.attention import flash_attention


class ViTConfig(NamedTuple):
    patch_size: int = 8
    dim: int = 384
    depth: int = 12
    heads: int = 6
    mlp_ratio: int = 4
    base_grid: int = 28  # pretrain grid side (224 / patch)
    # "auto" (the flash kernel on the card above the chunk threshold, else
    # chunked or dense), or force "dense" | "chunked" | "flash".
    attn_impl: str = "auto"


def layer_norm(x: torch.Tensor, p: Dict, eps: float = 1e-6) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_hw: Tuple[int, int], base_grid: int) -> torch.Tensor:
    """Bicubic-resample the (1, 1+N0, D) pos embed to a (gh, gw) token grid.

    jax.image.resize's bicubic is Keys' cubic with a = -0.5 and its weights
    renormalised at the borders. `F.interpolate(mode="bicubic")` is a =
    -0.75 with a clamped border; its antialias path is the former."""
    cls_pe, patch_pe = pos_embed[:, :1], pos_embed[:, 1:]
    d = patch_pe.shape[-1]
    patch_pe = patch_pe.reshape(1, base_grid, base_grid, d).permute(0, 3, 1, 2)
    patch_pe = F.interpolate(patch_pe, size=tuple(grid_hw), mode="bicubic", antialias=True, align_corners=False)
    gh, gw = grid_hw
    return torch.cat([cls_pe, patch_pe.permute(0, 2, 3, 1).reshape(1, gh * gw, d)], dim=1)


def patch_embed(x: torch.Tensor, p: Dict, patch: int, stride: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(1, H, W, 3) image -> (1, N, D) tokens with the stride-overridden conv."""
    w = p["patch_embed"]["w"]  # (D, 3, P, P)
    if w.shape[-1] != patch:
        raise ValueError(f"patch-embed kernel is {w.shape[-1]}, config says {patch}")
    y = F.conv2d(x.permute(0, 3, 1, 2), w, p["patch_embed"]["b"], stride=stride)
    _, d, gh, gw = y.shape
    return y.flatten(2).transpose(1, 2), (gh, gw)


# Above this token count dense attention is not viable: the stride-4 448x448
# grid gives 12,322 tokens, whose dense (H, N, N) scores take ~3.6 GB. "auto"
# takes the flash kernel on the card and the query-chunked form elsewhere.
ATTN_CHUNK_THRESHOLD = 4096
ATTN_Q_CHUNK = 1024


def _resolve_attn_impl(impl: str, N: int, device: torch.device) -> str:
    if impl == "auto":
        if N <= ATTN_CHUNK_THRESHOLD:
            return "dense"
        return "flash" if device.type == "cuda" else "chunked"
    if impl not in ("dense", "chunked", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return impl


def qkv_proj(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """(B, N, D) -> (B, N, 3D): [q | k | v], heads concatenated in each."""
    return x @ p["qkv"]["w"] + p["qkv"]["b"]


def attention(x: torch.Tensor, p: Dict, heads: int, return_keys: bool = False, impl: str = "auto"):
    """Standard MHSA; optionally also return the keys (B, N, D) with heads
    concatenated: the 'key' descriptor facet."""
    B, N, D = x.shape
    hd = D // heads
    scale = float(1.0 / np.sqrt(hd))
    qkv = qkv_proj(x, p).reshape(B, N, 3, heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, N, hd)
    impl = _resolve_attn_impl(impl, N, x.device)
    if impl == "flash":
        out = flash_attention(
            q.reshape(B * heads, N, hd), k.reshape(B * heads, N, hd), v.reshape(B * heads, N, hd), scale=scale,
        ).reshape(B, heads, N, hd)
    elif impl == "chunked":
        kT = k.transpose(-2, -1)
        out = torch.cat(
            [torch.softmax(q[:, :, i : i + ATTN_Q_CHUNK] @ kT * scale, -1) @ v for i in range(0, N, ATTN_Q_CHUNK)],
            dim=2,
        )
    else:
        out = torch.softmax(q @ k.transpose(-2, -1) * scale, -1) @ v
    out = out.transpose(1, 2).reshape(B, N, D)
    out = out @ p["proj"]["w"] + p["proj"]["b"]
    if return_keys:
        return out, qkv[:, :, 1].reshape(B, N, D)
    return out


def block(x: torch.Tensor, p: Dict, heads: int, return_keys: bool = False, impl: str = "auto"):
    h = layer_norm(x, p["ln1"])
    if return_keys:
        attn_out, keys = attention(h, p, heads, return_keys=True, impl=impl)
    else:
        attn_out, keys = attention(h, p, heads, impl=impl), None
    x = x + attn_out
    h = layer_norm(x, p["ln2"])
    h = F.gelu(h @ p["mlp1"]["w"] + p["mlp1"]["b"], approximate="none")
    x = x + (h @ p["mlp2"]["w"] + p["mlp2"]["b"])
    return (x, keys) if return_keys else x


def embed(params: Dict, cfg: ViTConfig, img: torch.Tensor, stride: int):
    """(H, W, 3) normalized image -> ((1, 1+N, D) tokens with the CLS token
    and the resized pos embed, (gh, gw))."""
    tokens, (gh, gw) = patch_embed(img[None], params, cfg.patch_size, stride)
    cls = params["cls_token"].expand(1, 1, cfg.dim)
    tokens = torch.cat([cls, tokens], dim=1)
    return tokens + interpolate_pos_embed(params["pos_embed"], (gh, gw), cfg.base_grid), (gh, gw)


def forward_features(
    params: Dict,
    cfg: ViTConfig,
    img: torch.Tensor,
    stride: int,
    key_layer: int = None,
    out_layers: Tuple[int, ...] = (),
):
    """Run the ViT; returns a dict with:
      tokens : final-LN tokens (1, 1+N, D)
      keys   : 'key' facet at key_layer (1, 1+N, D) (if key_layer is set)
      layers : {i: pre-norm block outputs} for i in out_layers (DPT hooks)
      grid   : (gh, gw)
    """
    tokens, grid = embed(params, cfg, img, stride)
    out = {"grid": grid, "layers": {}}
    for i in range(cfg.depth):
        p = params[f"blk{i}"]
        if key_layer is not None and i == key_layer:
            tokens, out["keys"] = block(tokens, p, cfg.heads, return_keys=True, impl=cfg.attn_impl)
        else:
            tokens = block(tokens, p, cfg.heads, impl=cfg.attn_impl)
        if i in out_layers:
            out["layers"][i] = tokens
    out["tokens"] = layer_norm(tokens, params["ln_final"])
    return out


def init_vit_params(rng: np.random.Generator, cfg: ViTConfig) -> Dict:
    """Random parameters in the npz layout (numpy; HWIO patch-embed conv):
    N(0, 0.02) weights, zero biases, unit LayerNorm scales. For tests and
    shape checks; real use loads converted DINO weights."""
    d, m = cfg.dim, cfg.dim * cfg.mlp_ratio

    def normal(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)).astype(np.float32)

    def lin(i, o):
        return {"w": normal(i, o), "b": np.zeros((o,), np.float32)}

    def ln():
        return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}

    p = {
        "patch_embed": {"w": normal(cfg.patch_size, cfg.patch_size, 3, d), "b": np.zeros((d,), np.float32)},
        "cls_token": normal(1, 1, d),
        "pos_embed": normal(1, 1 + cfg.base_grid**2, d),
        "ln_final": ln(),
    }
    for i in range(cfg.depth):
        p[f"blk{i}"] = {
            "ln1": ln(), "qkv": lin(d, 3 * d), "proj": lin(d, d), "ln2": ln(), "mlp1": lin(d, m), "mlp2": lin(m, d),
        }
    return p
