"""Optimizers (upnerf/train/optim.py): Adam with eps 1e-8 and an
ExponentialLR of gamma = (lr_end / lr)^(1 / max_steps), stepped once per
iteration; one optimizer for the model and one for the pose tables.

`make_optimizer` returns a spec, the counterpart of optax's
GradientTransformation; `spec.init(params)` builds the torch optimizer and
its LR scheduler (the counterpart of the optax state). torch's Adam applies
lr * m_hat / (sqrt(v_hat) + eps), optax's adam the same, and both use lr at
the first update and lr * gamma^t at update t + 1 (optax's
exponential_decay(transition_steps=1) at count t). The JAX package's other
kinds (adamw, sgd, cosine) are not ported: no configuration uses them.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch


class OptState(NamedTuple):
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler

    def step(self) -> None:
        """One update, then one scheduler step. Parameters without a
        gradient get a zero one first, so every Adam moment decays and every
        step count advances together, as in optax."""
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.scheduler.step()

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)


class Optimizer(NamedTuple):
    lr: float
    lr_end: float
    max_steps: int

    def init(self, params: Iterable[torch.nn.Parameter]) -> OptState:
        opt = torch.optim.Adam(list(params), lr=self.lr, eps=1e-8)
        gamma = (self.lr_end / self.lr) ** (1.0 / self.max_steps)
        return OptState(opt, torch.optim.lr_scheduler.ExponentialLR(opt, gamma))


def make_optimizer(opt_type: str, lr: float, lr_end: float, max_steps: int,
                   scheduler: str = "ExponentialLR") -> Optimizer:
    """Adam (eps 1e-8) with ExponentialLR, as upnerf.train.make_optimizer
    builds it for the reference configuration."""
    if opt_type != "adam" or scheduler != "ExponentialLR":
        raise ValueError(f"only adam with ExponentialLR is ported, got {opt_type!r} / {scheduler!r}")
    return Optimizer(lr, lr_end, max_steps)
