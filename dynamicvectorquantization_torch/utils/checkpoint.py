"""Training checkpoints under `<logdir>/checkpoints/` (the port's counterpart
of the JAX loop's orbax manager, `train/loop.py` `_ckpt_manager`, which
saves asynchronously).

One `torch.save` file per saved step, `step_<step>.pt`, written to a
temporary name and renamed into place, so a reader never sees a partial
file. With a monitored metric the manager keeps the `save_top_k` steps with
the SMALLEST metric plus the newest step (so a resume never rewinds past a
bad epoch); a step saved without that metric ranks last. Without a monitor,
the newest `save_top_k`. The metrics of the kept
steps live in `index.json` beside the files.

Saves leave the training thread early: `save` copies the state into host
memory (pinned buffers, reused from save to save, filled by non-blocking
copies on the current stream; CPU tensors cloned), records an event and
returns; one writer thread waits for the event, writes the file, renames it
and prunes. `save`, `restore`, `latest`, `all_steps` and `wait` first wait
for a write in flight (and raise its error); the training loop calls `wait`
at the end of a fit and after an emergency save.

Over several ranks the state a rank hands in is already whole: the
trainers' `state_dict` gathers ZeRO-1 / FSDP slices and tensor-parallel
shards on every rank (a collective), and rank 0 alone saves, on this writer
thread. So a file holds the leaves of the one-process model, as the JAX
package's orbax checkpoints hold global arrays: a run written under `--tp 2`
resumes at `--tp 2` bit for bit and loads in one process (the trainer cuts
the whole leaves to its shards, `Stage2Trainer.load_state_dict`).
"""
from __future__ import annotations

import json
import os
import threading
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
        self.metrics = {s: self.metrics.get(s, {}) for s in self._steps()}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned = {}  # (path in the state, shape, dtype) -> pinned host buffer

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_PREFIX}{int(step)}{_SUFFIX}")

    def all_steps(self):
        """The saved steps, once a write in flight has finished."""
        self.wait()
        return self._steps()

    def _steps(self):
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
        # a step saved without the monitored metric (an emergency save) ranks
        # after every measured one: it is kept while it is the newest
        best = sorted(steps, key=lambda s: (self.monitor not in self.metrics[s],
                                            self.metrics[s].get(self.monitor, 0.0), -s))
        return set(best[:max(self.save_top_k, 0)]) | {steps[-1]}

    # --------------------------------------------------------------- save
    def _snapshot(self, obj, path=()):
        """A host copy of `obj` (nested dicts / lists / tuples of tensors and
        plain values): device tensors into pinned buffers by non-blocking
        copies, host tensors cloned."""
        if isinstance(obj, dict):
            return {k: self._snapshot(v, path + (k,)) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._snapshot(v, path + (i,)) for i, v in enumerate(obj))
        if not isinstance(obj, torch.Tensor):
            return obj
        t = obj.detach()
        if t.device.type == "cpu":
            return t.clone()
        key = (path, tuple(t.shape), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t, non_blocking=True)

    def save(self, step: int, state: dict, metrics: Optional[dict] = None):
        """Save `state` as the checkpoint of `step` (see the module
        docstring); returns the file's path, which exists once the write has
        finished (`wait`)."""
        self.wait()
        snapshot = self._snapshot(state)
        event = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            event = torch.cuda.Event()
            event.record()
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        self._thread = threading.Thread(target=self._write_guarded,
                                        args=(int(step), snapshot, event, metrics),
                                        name="checkpoint-writer", daemon=True)
        self._thread.start()
        return self.path(step)

    def _write_guarded(self, *args):
        try:
            self._write(*args)
        except BaseException as e:  # raised on the training thread by `wait`
            self._error = e

    def _write(self, step, snapshot, event, metrics):
        if event is not None:
            event.synchronize()
        final = self.path(step)
        tmp = final + ".tmp"
        torch.save(snapshot, tmp)
        os.replace(tmp, final)
        self.metrics[step] = metrics
        steps = self._steps()
        keep = self._keep(steps)
        for s in steps:
            if s not in keep:
                os.remove(self.path(s))
                self.metrics.pop(s, None)
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in sorted(self.metrics.items())}, f)
        os.replace(tmp, self._index_path)

    def wait(self):
        """Wait for a write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, step: Optional[int] = None, map_location="cpu") -> dict:
        step = self.latest() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        self.wait()
        # the files hold tensors, numbers and strings only
        return torch.load(self.path(step), map_location=map_location, weights_only=True)
