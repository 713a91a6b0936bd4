"""Per-image embedding tables (upnerf/models/embeddings.py).

A table is an (N_images, dim) nn.Embedding, gathered by ray image index:
appearance (48-d) and candidate (16-d) per pass, N(0, 1) like
torch.nn.Embedding. (The se3 refinement and depth scale tables start at
zero; see upnerf_torch/utils/weights.py.)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def init_embedding(n: int, dim: int, generator: Optional[torch.Generator] = None) -> nn.Embedding:
    """(n, dim) table drawn from N(0, 1) with `generator`."""
    table = nn.Embedding(n, dim)
    with torch.no_grad():
        table.weight.normal_(generator=generator)
    return table
