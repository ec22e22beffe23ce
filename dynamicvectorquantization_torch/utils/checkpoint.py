"""Training checkpoints under `<logdir>/checkpoints/` (the port's counterpart
of the JAX loop's orbax manager, `train/loop.py` `_ckpt_manager`).

One `torch.save` file per saved step, `step_<step>.pt`, written to a
temporary name and renamed into place, so a reader never sees a partial
file. With a monitored metric the manager keeps the `save_top_k` steps with
the SMALLEST metric plus the newest step (so a resume never rewinds past a
bad epoch); without one, the newest `save_top_k`. The metrics of the kept
steps live in `index.json` beside the files.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import torch

_PREFIX, _SUFFIX = "step_", ".pt"


class CheckpointManager:
    def __init__(self, directory: str, save_top_k: int = 3, monitor: Optional[str] = None):
        self.directory = os.path.abspath(directory)
        self.save_top_k = int(save_top_k)
        self.monitor = monitor
        os.makedirs(self.directory, exist_ok=True)
        self._index_path = os.path.join(self.directory, "index.json")
        self.metrics = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self.metrics = {int(k): v for k, v in json.load(f).items()}
        self.metrics = {s: self.metrics.get(s, {}) for s in self.all_steps()}

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_PREFIX}{int(step)}{_SUFFIX}")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith(_PREFIX) and name.endswith(_SUFFIX):
                steps.append(int(name[len(_PREFIX):-len(_SUFFIX)]))
        return sorted(steps)

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _keep(self, steps):
        if not self.monitor:
            return set(steps[-self.save_top_k:]) if self.save_top_k > 0 else set()
        best = sorted(steps, key=lambda s: (self.metrics[s].get(self.monitor, 0.0), -s))
        return set(best[:max(self.save_top_k, 0)]) | {steps[-1]}

    def save(self, step: int, state: dict, metrics: Optional[dict] = None):
        """Write `state` as the checkpoint of `step` (atomically), then drop
        the steps that are neither among the best nor the newest."""
        final = self.path(step)
        tmp = final + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, final)
        self.metrics[int(step)] = {k: float(v) for k, v in (metrics or {}).items()}
        steps = self.all_steps()
        keep = self._keep(steps)
        for s in steps:
            if s not in keep:
                os.remove(self.path(s))
                self.metrics.pop(s, None)
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in sorted(self.metrics.items())}, f)
        os.replace(tmp, self._index_path)
        return final

    def restore(self, step: Optional[int] = None, map_location="cpu") -> dict:
        step = self.latest() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        # the files hold tensors, numbers and strings only
        return torch.load(self.path(step), map_location=map_location, weights_only=True)
