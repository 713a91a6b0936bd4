"""2-D transient (occluder) network over per-pixel DINO features
(upnerf/models/transient.py).

A per-pixel MLP on the 384-d DINO feature predicts an occluder alpha; with a
per-image transient embedding it predicts the occluder rgb and the
uncertainty beta = softplus(.) * alpha + beta_min. Parameter names are the
reference's `transient_net.*` keys (hidden width 256).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from upnerf_torch.models.embeddings import init_embedding
from upnerf_torch.ops.linear import dense, init_linear_
from upnerf_torch.ops.render_train import softplus

HIDDEN = 256


class TransientConfig(NamedTuple):
    beta_min: float = 0.1
    transient_dim: int = 128
    feat_dim: int = 384

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any]) -> "TransientConfig":
        return cls(beta_min=hp["t_net.beta_min"], transient_dim=hp["t_net.transient_dim"], feat_dim=hp["t_net.feat_dim"])


class TransientNet(nn.Module):
    def __init__(self, cfg: TransientConfig, n_images: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        h = HIDDEN
        self.embedding_t = init_embedding(n_images, cfg.transient_dim, generator)
        self.feat_encoder = nn.Sequential(
            nn.Linear(cfg.feat_dim, h), nn.ReLU(True), nn.Linear(h, h), nn.ReLU(True),
            nn.Linear(h, h), nn.ReLU(True), nn.Linear(h, h), nn.ReLU(True),
        )
        self.final_encoder = nn.Linear(h, h)
        self.t_encoder = nn.Sequential(nn.Linear(h + cfg.transient_dim, 128), nn.ReLU(True))
        self.alpha_layer = nn.Sequential(nn.Linear(h, 1), nn.Sigmoid())
        self.beta_layer = nn.Sequential(nn.Linear(128, 1), nn.Softplus())
        self.rgb_layer = nn.Sequential(nn.Linear(128, 3), nn.Sigmoid())
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_linear_(m, generator)

    def forward(self, feat: torch.Tensor, img_idx: torch.Tensor, precision: str = "float32") -> Dict[str, torch.Tensor]:
        """feat (B, feat_dim), img_idx (B,) -> {alpha (B,), rgb (B, 3), beta (B,)}."""
        t_emb = self.embedding_t.weight[img_idx]
        h = feat
        for lin in self.feat_encoder[0::2]:
            h = torch.relu(dense(h, lin.weight, lin.bias, precision))
        final = dense(h, self.final_encoder.weight, self.final_encoder.bias, precision)
        lt = self.t_encoder[0]
        temb_in = torch.relu(dense(torch.cat([final, t_emb], -1), lt.weight, lt.bias, precision))
        la, lb, lr = self.alpha_layer[0], self.beta_layer[0], self.rgb_layer[0]
        alpha = torch.sigmoid(dense(h, la.weight, la.bias, precision))[..., 0]
        rgb = torch.sigmoid(dense(temb_in, lr.weight, lr.bias, precision))
        beta = softplus(dense(temb_in, lb.weight, lb.bias, precision))[..., 0] * alpha + self.cfg.beta_min
        return {"alpha": alpha, "rgb": rgb, "beta": beta}
