"""Optimizers and LR schedules (upnerf/train/optim.py): one optimizer for the
model and one for the pose tables, each stepped once per iteration.

`make_optimizer` returns a spec, the counterpart of optax's
GradientTransformation; `spec.init(params)` builds the torch optimizer and
its LR scheduler (the counterpart of the optax state). The kinds:
- adam: torch Adam with eps 1e-8 (optax.adam(lr, eps=1e-8));
- adamw: torch AdamW with optax.adamw's defaults, eps 1e-8 and weight decay
  1e-4 on every parameter (torch's own default decay is 1e-2);
- sgd: plain SGD, no momentum (optax.sgd).
Schedules, as the factor of the base LR at update t (t = 0 for the first):
- ExponentialLR: gamma^t, gamma = (lr_end / lr)^(1 / max_steps)
  (optax.exponential_decay with transition_steps 1);
- cosine, CosineAnnealingLR: alpha + (1 - alpha) (1 + cos(pi min(t, T) / T)) / 2
  with T = max_steps and alpha = 1e-8 / lr (optax.cosine_decay_schedule): it
  holds at alpha lr past T, where torch's recursive CosineAnnealingLR would
  rise again;
- constant: None, "constant", "none", "None" or an empty name.
Each LR is computed in float32 as optax computes it (near the end of the
cosine, 1 + cos cancels, and its float32 value moves by ~1e-6). Every
schedule is this closed form in a LambdaLR, so a run resumed from a
checkpoint (the scheduler's state_dict holds the step) reads the same LR as
one that was not interrupted.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

CONSTANT = (None, "", "constant", "none", "None")


def lr_factor(lr: float, lr_end: Optional[float], max_steps: int, kind: Optional[str]) -> Callable[[int], float]:
    """The schedule as a function of the update count t: the LR of update t
    over the base LR."""
    f32 = np.float32
    if kind == "ExponentialLR":
        if lr_end is None:
            raise ValueError("ExponentialLR needs scheduler.lr_end")
        gamma = f32((lr_end / lr) ** (1.0 / max_steps))
        return lambda t: float(f32(lr) * gamma ** f32(t)) / lr
    if kind in ("cosine", "CosineAnnealingLR"):
        alpha = 1e-8 / lr

        def cosine(t: int) -> float:
            decay = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * f32(min(t, max_steps)) / f32(max_steps)))
            return float(f32(lr) * (f32(1.0 - alpha) * decay + f32(alpha))) / lr

        return cosine
    if kind in CONSTANT:
        return lambda t: 1.0
    raise ValueError(f"unknown scheduler {kind!r}")


def learning_rate_at(step: int, lr: float, lr_end: Optional[float], max_steps: int,
                     scheduler: Optional[str] = "ExponentialLR") -> float:
    """The LR of update `step` (0 for the first), for logging."""
    return lr * lr_factor(lr, lr_end, max_steps, scheduler)(step)


class OptState(NamedTuple):
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler

    def step(self) -> None:
        """One update, then one scheduler step. Parameters without a
        gradient get a zero one first, so every moment decays, every step
        count advances and AdamW's decay reaches every parameter, as in
        optax."""
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.scheduler.step()

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def seek(self, count: int) -> None:
        """Put the schedule at update `count`, as optax's state after
        `count` updates (moments are left as they are)."""
        sch = self.scheduler
        sch.last_epoch = count
        sch._last_lr = [base * fn(count) for base, fn in zip(sch.base_lrs, sch.lr_lambdas)]
        for group, lr in zip(self.optimizer.param_groups, sch._last_lr):
            group["lr"] = lr


class Optimizer(NamedTuple):
    kind: str
    lr: float
    lr_end: Optional[float]
    max_steps: int
    scheduler: Optional[str]

    def init(self, params: Iterable[torch.nn.Parameter]) -> OptState:
        params = list(params)
        if self.kind == "adam":
            opt = torch.optim.Adam(params, lr=self.lr, eps=1e-8)
        elif self.kind == "adamw":
            opt = torch.optim.AdamW(params, lr=self.lr, eps=1e-8, weight_decay=1e-4)
        else:
            opt = torch.optim.SGD(params, lr=self.lr)
        return OptState(opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_factor(self.lr, self.lr_end, self.max_steps,
                                                                               self.scheduler)))


def make_optimizer(opt_type: str, lr: float, lr_end: Optional[float] = None, max_steps: int = 1,
                   scheduler: Optional[str] = "ExponentialLR") -> Optimizer:
    """adam (eps 1e-8) / adamw / sgd with one of the schedules above, as
    upnerf.train.make_optimizer builds them."""
    if opt_type not in ("adam", "adamw", "sgd"):
        raise ValueError("optimizer not recognized!")
    lr_factor(lr, lr_end, max_steps, scheduler)  # an unknown schedule raises here, not at init
    return Optimizer(opt_type, lr, lr_end, max_steps, scheduler)
