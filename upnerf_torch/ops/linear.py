"""Dense layer with the repo's matmul-precision policy (upnerf/ops/linear.py).

- 'bfloat16': both operands rounded to bf16, products accumulated in f32.
  That is `a.bfloat16().float() @ b.bfloat16().float()`: the product of two
  bf16 values is exact in f32, so this equals JAX's
  `jnp.dot(bf16, bf16, preferred_element_type=f32)`. It is NOT
  `a.bfloat16() @ b.bfloat16()`, which rounds the result to bf16 as well.
- 'float32': full f32 (TF32 is off, see upnerf_torch/__init__.py).

'high' (JAX's bf16x3 passes, near-f32) maps to 'float32'.

Weights are in torch's (out, in) layout, as nn.Linear stores them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

PRECISIONS = ("bfloat16", "float32")


def canonical_precision(precision: str) -> str:
    if precision == "high":
        return "float32"
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS} or 'high', got {precision!r}")
    return precision


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b under the precision policy, accumulated in f32."""
    if precision == "bfloat16":
        return a.bfloat16().float() @ b.bfloat16().float()
    return a @ b


def dense(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    precision: str = "float32",
) -> torch.Tensor:
    """x @ weight.T + bias, weight (out, in) as in nn.Linear."""
    y = matmul(x, weight.t(), precision)
    return y if bias is None else y + bias


def init_linear_(layer: nn.Linear, generator: Optional[torch.Generator] = None) -> nn.Linear:
    """torch.nn.Linear's default init, drawn from `generator`:
    W, b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (upnerf/ops/linear.py)."""
    bound = 1.0 / math.sqrt(layer.in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if layer.bias is not None:
            layer.bias.uniform_(-bound, bound, generator=generator)
    return layer
