"""UP-NeRF field with BARF-annealed positional encoding (upnerf/models/nerf.py).

`NeRFField` is an nn.Module whose parameter names are the reference's
NeRF state_dict keys (`xyz_encoding_1.0.weight`, ..., `share_sigma.0.*`,
`rgb_share_layer.{0,2}.*`, `feat_share_layer.*`, `candidate_encoding.{0,2}.*`,
`candidate_sigma.0.*`, `feat_candidate_layer.*` or `rgb_candidate_layer.*`,
`progress`), so a
reference checkpoint loads with `load_state_dict(strict=True)`.

Architecture:
  trunk   : D layers of W + ReLU, skip concat [x0, h] at the skip layers;
            xyz_encoding_final Linear(W, W).
  shared  : sigma = Softplus(Linear(W, 1)); feat = Linear(W, feat_dim);
            rgb = Sigmoid(MLP(feat + PE(dir) + appearance, W/2)).
  candidate: enc = 2 x (Linear -> ReLU) on [xyz_final, candidate embedding];
            c_sigma = Softplus(Linear); c_feat = Linear (phases 0 and 1).

`NeRFField.forward` is the per-sample field (apply_nerf). With
`NeRFConfig.fused_trunk` (on unless the config turns it off, as the JAX
package turns it on for its accelerator) the trunk and the sigma / xyzf /
feat / candidate heads run through upnerf_torch.ops.heads.fused_trunk_heads
(the CUDA kernels on the card, forward and backward), without it through
its plain version fused_trunk_heads_plain (autograd); the rgb head in
PyTorch. The unfused render path (`tpu.fused_train` off) trains through it.
Its sigma-only mode (the probe of the fast serving render) runs the trunk
through upnerf_torch.ops.mlp.fused_trunk, the CUDA trunk kernel on the card.
The feature-less field (`nerf.feat_dim: 0`, the JAX package's RGB surrogate)
runs its trunk through the same fused_trunk, differentiable (the trunk
kernel's forward and backward), with fused_trunk on, and through the plain
trunk without it; its heads in PyTorch: the static rgb head on xyz_final in
every phase, and the candidate's c_rgb (no sigmoid) in place of c_feat.
The fused render path runs the same math through upnerf_torch.ops.render_train.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F_
from torch import nn

from upnerf_torch.ops.heads import fused_trunk_heads, fused_trunk_heads_plain
from upnerf_torch.ops.linear import dense, init_linear_
from upnerf_torch.ops.mlp import fused_trunk, fused_trunk_plain
from upnerf_torch.ops.render_train import softplus


class NeRFConfig(NamedTuple):
    """Static NeRF hyperparameters."""

    D: int = 8
    W: int = 256
    skips: Tuple[int, ...] = (4,)
    encode_feat: bool = True
    feat_dim: int = 384
    xyz_L: int = 10
    dir_L: int = 4
    appearance_dim: int = 48
    candidate_dim: int = 16
    c2f: Optional[Tuple[float, float]] = (0.1, 0.5)
    # Trunk + heads through ops.heads.fused_trunk_heads (tpu.fused_trunk; omitted = on).
    fused_trunk: bool = True

    @property
    def in_channels_xyz(self) -> int:
        return 6 * self.xyz_L + 3

    @property
    def in_channels_dir(self) -> int:
        return 6 * self.dir_L + 3

    @property
    def encode_appearance(self) -> bool:
        return self.appearance_dim > 0

    @property
    def encode_candidate(self) -> bool:
        return self.candidate_dim > 0

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any]) -> "NeRFConfig":
        c2f = hp.get("pose.c2f")
        return cls(
            D=hp.get("nerf.D", 8),
            W=hp.get("nerf.W", 256),
            skips=tuple(hp.get("nerf.skips", (4,))),
            encode_feat=hp["nerf.feat_dim"] > 0,
            feat_dim=hp["nerf.feat_dim"],
            xyz_L=hp["nerf.N_emb_xyz"],
            dir_L=hp["nerf.N_emb_dir"],
            appearance_dim=hp["nerf.appearance_dim"],
            candidate_dim=hp["nerf.candidate_dim"],
            c2f=tuple(c2f) if c2f is not None else None,
            fused_trunk=bool(hp.get("tpu.fused_trunk", True)),
        )


def pe_weight(progress: float, L: int, c2f: Tuple[float, float], device=None) -> torch.Tensor:
    """(L,) BARF coarse-to-fine band weights:
    w_k = (1 - cos(pi * clamp(alpha - k, 0, 1))) / 2,
    alpha = (progress - start) / (end - start) * L, in f32 as the reference
    computes it. alpha is formed on the host, so no host-to-device copy (and
    no stream synchronisation) happens per call."""
    start, end = c2f
    alpha = ((torch.tensor(float(progress), dtype=torch.float32) - start) / (end - start) * L).item()
    k = torch.arange(L, dtype=torch.float32, device=device)
    return (1 - torch.cos(torch.clamp(alpha - k, 0.0, 1.0) * math.pi)) / 2


def band_weights(cfg: NeRFConfig, L: int, progress: float, device=None) -> torch.Tensor:
    """pe_weight under c2f, ones without it."""
    if cfg.c2f is None:
        return torch.ones(L, dtype=torch.float32, device=device)
    return pe_weight(progress, L, cfg.c2f, device=device)


def positional_encoding(x: torch.Tensor, L: int, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sin/cos PE in the torch column layout: the raw coordinates, then per
    coordinate [sin(f_0 x) .. sin(f_{L-1} x), cos(f_0 x) .. cos(f_{L-1} x)],
    f_l = 2^l * pi. Output dim N + 2NL for input dim N."""
    freq = 2.0 ** torch.arange(L, dtype=torch.float32, device=x.device) * math.pi
    spectrum = x[..., None] * freq  # [..., N, L]
    sin, cos = torch.sin(spectrum), torch.cos(spectrum)
    if weight is not None:
        sin = sin * weight
        cos = cos * weight
    enc = torch.stack([sin, cos], dim=-2).reshape(*x.shape[:-1], x.shape[-1] * 2 * L)
    return torch.cat([x, enc], dim=-1)


class NeRFField(nn.Module):
    """One NeRF MLP (coarse or fine), reference parameter names."""

    def __init__(self, cfg: NeRFConfig, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device)
        for i in range(cfg.D):
            if i == 0:
                fan_in = cfg.in_channels_xyz
            elif i in cfg.skips:
                fan_in = cfg.W + cfg.in_channels_xyz
            else:
                fan_in = cfg.W
            setattr(self, f"xyz_encoding_{i + 1}", nn.Sequential(nn.Linear(fan_in, cfg.W, **kw), nn.ReLU(True)))
        self.xyz_encoding_final = nn.Linear(cfg.W, cfg.W, **kw)
        self.share_sigma = nn.Sequential(nn.Linear(cfg.W, 1, **kw), nn.Softplus())
        rgb_in = (cfg.feat_dim if cfg.encode_feat else cfg.W) + cfg.in_channels_dir + cfg.appearance_dim
        self.rgb_share_layer = nn.Sequential(
            nn.Linear(rgb_in, cfg.W // 2, **kw), nn.ReLU(True), nn.Linear(cfg.W // 2, 3, **kw), nn.Sigmoid()
        )
        if cfg.encode_feat:
            self.feat_share_layer = nn.Linear(cfg.W, cfg.feat_dim, **kw)
        if cfg.encode_candidate:
            self.candidate_encoding = nn.Sequential(
                nn.Linear(cfg.W + cfg.candidate_dim, cfg.W // 2, **kw),
                nn.ReLU(True),
                nn.Linear(cfg.W // 2, cfg.W // 2, **kw),
                nn.ReLU(True),
            )
            self.candidate_sigma = nn.Sequential(nn.Linear(cfg.W // 2, 1, **kw), nn.Softplus())
            if cfg.encode_feat:
                self.feat_candidate_layer = nn.Linear(cfg.W // 2, cfg.feat_dim, **kw)
            else:
                self.rgb_candidate_layer = nn.Linear(cfg.W // 2, 3, **kw)
        self.progress = nn.Parameter(torch.tensor(0.0, device=device), requires_grad=False)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_linear_(m, generator)

    def trunk_layers(self):
        return [getattr(self, f"xyz_encoding_{i + 1}")[0] for i in range(self.cfg.D)]

    def trunk_heads_weights(self, use_cand: bool):
        """(trunk, heads) in the interface of ops.heads (the JAX kernel's): (in,
        out) matrices; HEAD_KEYS, and CAND_KEYS with c1 unsplit (W + C, HC)."""
        trunk = self.trunk_weights()
        heads = {
            "sigma_w": self.share_sigma[0].weight.t(), "sigma_b": self.share_sigma[0].bias,
            "xyzf_w": self.xyz_encoding_final.weight.t(), "xyzf_b": self.xyz_encoding_final.bias,
            "feat_w": self.feat_share_layer.weight.t(), "feat_b": self.feat_share_layer.bias,
        }
        if use_cand:
            c1, c2 = self.candidate_encoding[0], self.candidate_encoding[2]
            heads.update(
                c1_w=c1.weight.t(), c1_b=c1.bias, c2_w=c2.weight.t(), c2_b=c2.bias,
                csig_w=self.candidate_sigma[0].weight.t(), csig_b=self.candidate_sigma[0].bias,
                cfeat_w=self.feat_candidate_layer.weight.t(), cfeat_b=self.feat_candidate_layer.bias,
            )
        return trunk, heads

    def forward(
        self,
        xyz: torch.Tensor,  # (..., 3)
        dirs: torch.Tensor,  # (..., 3), or per ray (R, 3) for xyz (R, S, 3)
        a_emb: Optional[torch.Tensor],  # like dirs, (..., appearance_dim)
        *,
        progress: float,
        precision: str = "float32",
        phase: int = 2,
        c_emb: Optional[torch.Tensor] = None,  # like dirs, (..., candidate_dim)
        encode_candidate: bool = True,
        sigma_only: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """apply_nerf: s_sigma (...), s_feat (..., feat_dim); s_rgb (..., 3)
        in phases 1 and 2; c_sigma and c_feat in phases 0 and 1 with the
        candidate branch. The feature-less field (encode_feat off): s_sigma and
        s_rgb in every phase, c_sigma and c_rgb (..., 3) with the candidate
        branch. Per-ray `dirs`/`a_emb`/`c_emb` are broadcast over the sample
        axis. sigma_only: s_sigma alone, the trunk through the fused trunk
        kernel (`dirs` and `a_emb` are not read)."""
        cfg = self.cfg
        x0 = positional_encoding(xyz, cfg.xyz_L, band_weights(cfg, cfg.xyz_L, progress, xyz.device))
        if sigma_only:
            lin = self.share_sigma[0]
            h = fused_trunk(x0.reshape(-1, x0.shape[-1]), self.trunk_weights(), cfg.skips, precision)
            h = h.reshape(*x0.shape[:-1], cfg.W)
            return {"s_sigma": softplus(dense(h, lin.weight, lin.bias, precision))[..., 0]}
        per_ray = dirs.dim() == xyz.dim() - 1
        lead = x0.shape[:-1]

        def widen(p):
            return p[..., None, :].expand(*lead, p.shape[-1]) if per_ray else p

        def rgb_head(base):
            dir_pe = positional_encoding(dirs, cfg.dir_L, band_weights(cfg, cfg.dir_L, progress, dirs.device))
            parts = [dir_pe] + ([a_emb] if cfg.encode_appearance else [])
            l1, l2 = self.rgb_share_layer[0], self.rgb_share_layer[2]
            rgbh = F_.relu(dense(torch.cat([base] + [widen(p) for p in parts], -1), l1.weight, l1.bias, precision))
            return torch.sigmoid(dense(rgbh, l2.weight, l2.bias, precision))

        use_cand = cfg.encode_candidate and encode_candidate and phase < 2
        if not cfg.encode_feat:
            return self._featureless(x0, lead, widen, rgb_head, c_emb if use_cand else None, precision)
        # the candidate embedding goes in per sample, as the JAX package broadcasts it
        c_flat = widen(c_emb).reshape(-1, c_emb.shape[-1]) if use_cand else None
        trunk_heads = fused_trunk_heads if cfg.fused_trunk else fused_trunk_heads_plain
        outs = trunk_heads(x0.reshape(-1, x0.shape[-1]), c_flat, *self.trunk_heads_weights(use_cand), cfg.skips,
                           precision)
        out = {"s_sigma": outs[0].reshape(lead), "s_feat": outs[1].reshape(*lead, cfg.feat_dim)}
        if use_cand:
            out["c_sigma"] = outs[2].reshape(lead)
            out["c_feat"] = outs[3].reshape(*lead, cfg.feat_dim)
        if phase > 0:
            out["s_rgb"] = rgb_head(out["s_feat"])
        return out

    def trunk_weights(self):
        """The trunk in the interface of ops.mlp: (in, out) matrices and biases."""
        return [(lay.weight.t(), lay.bias) for lay in self.trunk_layers()]

    def _featureless(self, x0, lead, widen, rgb_head, c_emb, precision: str) -> Dict[str, torch.Tensor]:
        """The feature-less field (upnerf/models/nerf.py:304-367): the trunk
        through ops.mlp.fused_trunk (fused_trunk on) or the plain trunk, then
        s_sigma, xyz_final and s_rgb = rgb_head(xyz_final) in every phase; with
        the candidate embedding c_emb, c_sigma and c_rgb = h2 W + b, no sigmoid."""
        cfg = self.cfg
        trunk = fused_trunk if cfg.fused_trunk else fused_trunk_plain
        h = trunk(x0.reshape(-1, x0.shape[-1]), self.trunk_weights(), cfg.skips, precision).reshape(*lead, cfg.W)
        lin = self.share_sigma[0]
        xyz_final = dense(h, self.xyz_encoding_final.weight, self.xyz_encoding_final.bias, precision)
        out = {"s_sigma": softplus(dense(h, lin.weight, lin.bias, precision))[..., 0], "s_rgb": rgb_head(xyz_final)}
        if c_emb is not None:
            c1, c2 = self.candidate_encoding[0], self.candidate_encoding[2]
            h1 = F_.relu(dense(torch.cat([xyz_final, widen(c_emb)], -1), c1.weight, c1.bias, precision))
            h2 = F_.relu(dense(h1, c2.weight, c2.bias, precision))
            cs, cr = self.candidate_sigma[0], self.rgb_candidate_layer
            out["c_sigma"] = softplus(dense(h2, cs.weight, cs.bias, precision))[..., 0]
            out["c_rgb"] = dense(h2, cr.weight, cr.bias, precision)
        return out
