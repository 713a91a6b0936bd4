"""UP-NeRF phase-scheduled loss (upnerf/train/losses.py).

Terms (all means over the ray batch):
  phase < 2:
    l_depth_{c,f}: L1(s_depth, depth_prior) * (1 - t_weight).detach()
                   * depth_mult * (1 - sched)
    l_feat_{c,f} : L2(feat, dino_feat) * (1 - sched)
    l_c_rgb_{c,f}: L2(c_rgb, rgb) * (1 - sched), in place of l_feat for the
                   feature-less field (nerf.feat_dim 0)
  phase > 0:
    l_rgb_c : L2(s_rgb_coarse, rgb) * sched / 2
    l_rgb_f : L2(s_rgb_fine, rgb) / (2 beta^2) * sched
    l_beta  : log(beta).mean() * sched
    l_alpha : t_alpha.mean() * alpha_reg * sched
The rgb terms read the raw static s_rgb_*, not the transient-composited
rgb_* maps, as the reference does: the transient net trains only through
beta and the alpha regulariser.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch


class LossConfig(NamedTuple):
    depth_mult: float = 1e-3
    alpha_reg: float = 1.0
    encode_feat: bool = True
    fine: bool = True
    depth_scale_reg: float = 0.0  # opt-in variance penalty on the log depth scales

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any]) -> "LossConfig":
        return cls(
            depth_mult=hp["loss.depth_mult"],
            alpha_reg=hp["loss.alpha_reg"],
            encode_feat=hp["nerf.feat_dim"] > 0,
            fine=hp["nerf.N_importance"] > 0,
            depth_scale_reg=hp.get("loss.depth_scale_reg", 0.0),
        )


def compute_loss(
    cfg: LossConfig,
    results: Dict[str, torch.Tensor],
    rgb_targets: torch.Tensor,  # (R, 3)
    feat_targets: torch.Tensor,  # (R, feat_dim)
    depth_targets: torch.Tensor,  # (R,)
    sched_mult: float,
    phase: int,
) -> Dict[str, torch.Tensor]:
    """Per-term loss dict (sum it for the total)."""
    ret: Dict[str, torch.Tensor] = {}

    def depth_term(typ: str) -> torch.Tensor:
        l = torch.abs(results[f"s_depth_{typ}"] - depth_targets)
        tw = results.get(f"t_weight_{typ}")
        if tw is not None:
            l = l * (1.0 - tw.detach())
        return l.mean() * cfg.depth_mult * (1.0 - sched_mult)

    typs = ("coarse", "fine") if cfg.fine else ("coarse",)
    for typ in typs:
        c = typ[0]
        if phase < 2:
            ret[f"l_depth_{c}"] = depth_term(typ)
            if cfg.encode_feat:
                ret[f"l_feat_{c}"] = ((results[f"feat_{typ}"] - feat_targets) ** 2).mean() * (1.0 - sched_mult)
            else:
                ret[f"l_c_rgb_{c}"] = ((results[f"c_rgb_{typ}"] - rgb_targets) ** 2).mean() * (1.0 - sched_mult)
        if phase > 0 and typ == "coarse":
            ret["l_rgb_c"] = ((results["s_rgb_coarse"] - rgb_targets) ** 2).mean() * sched_mult / 2.0
    if cfg.fine and phase > 0:
        beta = results["t_beta"]
        l_rgb_f = ((results["s_rgb_fine"] - rgb_targets) ** 2) / (2.0 * beta[..., None] ** 2)
        ret["l_rgb_f"] = l_rgb_f.mean() * sched_mult
        ret["l_beta"] = torch.log(beta).mean() * sched_mult
        ret["l_alpha"] = results["t_alpha"].mean() * cfg.alpha_reg * sched_mult
    return ret
