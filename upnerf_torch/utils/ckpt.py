"""Checkpoints of the train state on torch.save (upnerf/utils/ckpt.py, which
uses orbax).

Each checkpoint is one file `<directory>/<step>.ckpt`: a reference-format
checkpoint ({"state_dict", "hyper_parameters", "global_step"}, as
utils/weights.py:export_reference_ckpt writes it, so `cli.tto --ckpt`,
`cli.eval` and `cli.render_video` read it as it is) plus the two optimizers'
and LR schedulers' states and the train generator's state. A file is written
to a temporary name and renamed, so a reader never sees half of one.

Retention = {latest step} + {top `max_to_keep` steps by val_psnr}, enforced
after every save: retention that kept only the top-k by metric deleted the
final (or a preemption) checkpoint the moment it landed, and auto-resume then
restarted from an older step. Per-step metrics live in a JSON journal beside
the checkpoints, so `best_step` works across manager instances; steps saved
without metrics are kept while latest, then removed.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^(\d+)\.ckpt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._metrics_path = os.path.join(self.directory, "ckpt_metrics.json")
        self._metrics: Dict[int, Dict[str, float]] = {}
        if os.path.isfile(self._metrics_path):
            try:
                with open(self._metrics_path) as f:
                    self._metrics = {int(k): v for k, v in json.load(f).items()}
            except (json.JSONDecodeError, OSError, ValueError):
                self._metrics = {}

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.ckpt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, payload: Dict[str, Any], metrics: Optional[dict] = None) -> str:
        """Write `payload` as step `step`'s checkpoint, journal `metrics`, then
        apply the retention rule; returns the file's path."""
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if metrics:
            self._metrics[int(step)] = {k: float(v) for k, v in metrics.items()}
            tmp = self._metrics_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({str(k): v for k, v in self._metrics.items()}, f)
            os.replace(tmp, self._metrics_path)
        self._sweep()
        return path

    def _scored(self, steps):
        return sorted(((self._metrics[s].get("val_psnr", -1.0), s) for s in steps if s in self._metrics),
                      reverse=True)

    def _sweep(self) -> None:
        steps = self.all_steps()
        if not steps:
            return
        keep = {steps[-1]}
        keep.update(s for _, s in self._scored(steps)[: self.max_to_keep])
        for s in steps:
            if s not in keep:
                os.remove(self.path(s))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        scored = self._scored(self.all_steps())
        return scored[0][1] if scored else self.latest_step()

    def load(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The payload of step `step` (the latest when None), on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=False)
