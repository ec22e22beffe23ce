"""Stage-2 (DQ-Transformer) training step (counterpart of
`dynamicvectorquantization_tpu/train/stage2.py` `Stage2Trainer`).

AdamW(0.9, 0.95) with a decay / no-decay split (Linear weights decay; biases,
LayerNorms, embedding tables and the absolute `pos_emb` do not), warmup +
cosine LR, a frozen first stage, total = content_loss_weight * content +
position_loss_weight * position. The pad rows of the three embedding tables
get a zero gradient every step, as `nn.Embedding(padding_idx=...)` gives them
in the reference.

Where the JAX trainer is a pure function of a state, this one owns its state
and updates it in place: `masters` (f32 parameters), `m`, `v` (f32 moments,
all keyed by the transformer's parameter names), `count` (optimizer steps
taken) and `epoch`; `state_dict()` / `load_state_dict()` carry all of it.
With
`compute_dtype="bfloat16"` the transformer module holds the bf16 working
copy; autograd differentiates with respect to that copy (bf16 gradients), and
the fused AdamW kernel reads them, updates the f32 masters and writes the
next working copy in the same pass. With f32 the module's parameters are the
masters. Validation (`eval_step`) and the loop's image grids run on the f32
masters, as the JAX trainer evaluates and samples with `state.params`
(`master_weights`).

The first stage is frozen. Under bf16 the trainer encodes with its own bf16
copy of it, `frozen_first_stage`, every floating parameter and buffer (the
codebook and the EMA buffers included) cast to bf16, as the JAX trainer's
`_cast_tree` casts every f32 leaf, and with the images cast to bf16: the
cached-codes pre-encode (`encode`, `encode_dataset`, the loop's per-epoch
encode) and the inline encode of `compute_grads` alike. `eval_step` encodes
with the model's f32 first stage, as the JAX trainer evaluates with the
uncast variables. Checkpoints save the f32 first stage; whoever loads new
weights into it calls `refresh_first_stage` to rebuild the copy. Under f32
`frozen_first_stage` is the model's own first stage.

Dropout is a function of (base seed, optimizer step, microbatch, layer) and
of nothing else, as the JAX loop folds the global step into a constant base
key: a run resumed from a checkpoint draws the masks the uninterrupted run
would have drawn. The attention kernels get an integer seed per forward
(`ops.attention.attention_seed`, mixed on the host: no device sync); the
trainer's own `torch.Generator`, which feeds the embedding and residual
dropouts, is re-seeded from the base seed at every step. A caller that
passes its own generator keeps that generator's stream instead.

The epoch loop, checkpoints and data loading live in `train/loop.py`; the
parallel trainers are not ported (ROADMAP.md).
"""
from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch
from torch import nn

from ..ops.attention import attention_seed, mix_seed
from ..ops.fused_adamw import adamw_scalars, fused_adamw_step
from ..utils.device import resolve_device
from .schedules import warmup_cosine

B1, B2, EPS = 0.9, 0.95, 1e-8
_LOSS_KEYS = ("content_loss", "position_loss", "coarse_position_loss", "fine_position_loss")
_ELEMENTWISE = 0xE1E  # stream tag of the embedding / residual dropout generator


def cast_copy(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """A frozen copy of `module` with every floating parameter and buffer
    cast to `dtype`, as the JAX trainer's `_cast_tree` casts every f32 leaf."""
    return copy.deepcopy(module).to(dtype).requires_grad_(False)


def decayed_parameter_names(module: nn.Module):
    """Names of the parameters AdamW decays: the weights of `nn.Linear`
    layers (heads included) and nothing else. Selected by module type, since
    `weight` is also the leaf name of embeddings and LayerNorms."""
    return {f"{prefix}.weight" if prefix else "weight"
            for prefix, mod in module.named_modules() if isinstance(mod, nn.Linear)}


class Stage2Trainer:
    def __init__(self, model, learning_rate, min_learning_rate=0.0, warmup_steps=0,
                 max_steps=1_000_000, accum=1, compute_dtype=None, device=None, seed=0):
        if compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.accum = int(accum)
        if self.accum < 1:
            raise ValueError("accum must be at least 1")
        self.schedule = warmup_cosine(learning_rate, warmup_steps, max_steps,
                                      min_learning_rate / max(learning_rate, 1e-20))
        self.weight_decay = float(model.weight_decay)
        self.mixed = compute_dtype == "bfloat16"

        model.first_stage_model.eval()
        model.first_stage_model.requires_grad_(False)
        tf = model.transformer
        tf.requires_grad_(True)
        self.params = dict(tf.named_parameters())
        self.decayed = decayed_parameter_names(tf) & set(self.params)
        self.pad_rows = {"content_emb.weight": tf.content_pad_code,
                         "content_coarse_pos_emb.weight": tf.coarse_position_pad_code,
                         "content_fine_pos_emb.weight": tf.fine_position_pad_code}
        if self.mixed:
            self.masters = {k: p.detach().float().clone() for k, p in self.params.items()}
            tf.to(torch.bfloat16)
        else:
            tf.float()
            self.masters = {k: p.data for k, p in self.params.items()}
        self.m = {k: torch.zeros_like(p) for k, p in self.masters.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.masters.items()}
        self.count = 0
        self.epoch = 0
        self.base_seed = int(seed)
        self.generator = torch.Generator(device=self.device)
        self.refresh_first_stage()

    def refresh_first_stage(self):
        """(Re)build `frozen_first_stage` from the model's first stage: a bf16
        copy under bf16, the module itself under f32."""
        fs = self.model.first_stage_model
        self.frozen_first_stage = cast_copy(fs) if self.mixed else fs

    # ------------------------------------------------------------- state
    def state_dict(self):
        """The whole training state: f32 masters, both moments, the step
        count, the epoch and the base seed of the dropout streams."""
        return {"masters": dict(self.masters), "m": dict(self.m), "v": dict(self.v),
                "count": self.count, "epoch": self.epoch, "seed": self.base_seed}

    def load_state_dict(self, state):
        """Continue from a `state_dict()`: the masters (and from them the
        bf16 working copy, which is their rounding), the moments, the counts
        and the base seed."""
        if set(state["masters"]) != set(self.masters):
            raise KeyError("training state does not match the transformer's parameters")
        with torch.no_grad():
            for k, p in self.params.items():
                self.masters[k].copy_(state["masters"][k])
                if self.mixed:
                    p.copy_(self.masters[k])
        self.load_optimizer_state(state["count"], state["m"], state["v"])
        self.epoch = int(state["epoch"])
        self.base_seed = int(state["seed"])

    def load_optimizer_state(self, count: int, m: dict, v: dict):
        """Continue from a (count, m, v) state keyed by parameter name, e.g.
        `utils.weights.adamw_state_from_optax` of a JAX training state."""
        if set(m) != set(self.masters) or set(v) != set(self.masters):
            raise KeyError("optimizer state does not match the transformer's parameters")
        for k in self.masters:
            self.m[k].copy_(m[k])
            self.v[k].copy_(v[k])
        self.count = int(count)

    # -------------------------------------------------------------- steps
    def _to_device(self, x):
        if isinstance(x, dict):
            return {k: torch.as_tensor(v).to(self.device) for k, v in x.items()}
        return torch.as_tensor(x).to(self.device)

    def _losses(self, x, c, train, generator, seed=None, first_stage=None):
        if isinstance(x, dict):  # cached permuter streams
            out = self.model.forward_tokens(x, c, train=train, generator=generator, seed=seed)
        else:
            out = self.model(x, c, train=train, generator=generator, seed=seed,
                             first_stage=first_stage)
        return self.model.loss(out), out

    def compute_grads(self, x, generator=None, c=None):
        """(logs, grads): the losses of one training forward as 0-d f32
        tensors, and the gradient of the total with respect to every
        transformer parameter (pad rows zeroed), keyed by name. x: a dict of
        (B, L) streams or (B, H, W, 3) images, `c` their (B,) class labels
        (None: unconditional); with `accum > 1` the same with a leading
        (accum,) axis, gradients accumulated in f32 and averaged. Without a
        `generator` the trainer's own is used, re-seeded for this step."""
        x = self._to_device(x)
        c = None if c is None else self._to_device(c)
        if generator is None:
            generator = self.generator
            generator.manual_seed(mix_seed(self.base_seed, self.count, _ELEMENTWISE) >> 1)
        names, params = zip(*self.params.items())
        if self.accum == 1:
            micro = [(x, c)]
        else:
            n = len(next(iter(x.values()))) if isinstance(x, dict) else len(x)
            if n != self.accum:
                raise ValueError(f"expected {self.accum} microbatches, got {n}")
            micro = [({k: v[i] for k, v in x.items()} if isinstance(x, dict) else x[i],
                      None if c is None else c[i]) for i in range(n)]
        sums, log_sums = None, None
        for i, (xi, ci) in enumerate(micro):
            total, out = self._losses(xi, ci, True, generator,
                                      attention_seed(self.base_seed, self.count, i),
                                      self.frozen_first_stage)
            g = torch.autograd.grad(total, params)
            logs = {"total": total.detach().float(),
                    **{k: out[k].detach().float() for k in _LOSS_KEYS}}
            if self.accum == 1:
                sums, log_sums = list(g), logs
            elif sums is None:
                sums, log_sums = [t.float() for t in g], logs
            else:
                for s, t in zip(sums, g):
                    s.add_(t.float())
                log_sums = {k: log_sums[k] + logs[k] for k in logs}
        if self.accum > 1:
            inv = 1.0 / self.accum
            sums = [s.mul_(inv) for s in sums]
            log_sums = {k: t * inv for k, t in log_sums.items()}
        grads = dict(zip(names, sums))
        for name, pad in self.pad_rows.items():
            grads[name][pad] = 0.0
        return {"train_loss": log_sums["total"],
                **{f"train_{k}": log_sums[k] for k in _LOSS_KEYS}}, grads

    def apply_update(self, grads):
        """One AdamW update of every parameter from `grads`."""
        lr, c1, c2 = adamw_scalars(self.count, self.schedule, B1, B2)
        for name, p in self.params.items():
            wd = self.weight_decay if name in self.decayed else 0.0
            fused_adamw_step(grads[name].contiguous(), self.masters[name], self.m[name],
                             self.v[name], lr, c1, c2, B1, B2, EPS, wd,
                             copy=p.data if self.mixed else None)
        self.count += 1

    def train_step(self, x, generator=None, c=None):
        """One optimizer step; returns the logs (0-d tensors on the device)."""
        logs, grads = self.compute_grads(x, generator, c)
        self.apply_update(grads)
        return logs

    def train_steps(self, xs, generator=None, cs=None):
        """K full optimizer steps over xs (and their labels `cs`) with a
        leading (K,) axis; returns the logs stacked per step."""
        xs = self._to_device(xs)
        k = len(next(iter(xs.values()))) if isinstance(xs, dict) else len(xs)
        steps = [self.train_step({n: v[i] for n, v in xs.items()} if isinstance(xs, dict)
                                 else xs[i], generator, None if cs is None else cs[i])
                 for i in range(k)]
        return {key: torch.stack([s[key] for s in steps]) for key in steps[0]}

    @contextlib.contextmanager
    def master_weights(self):
        """For its duration the transformer computes with the f32 masters:
        each parameter's data points at its master, and back to the bf16
        working copy after. No second model is allocated; under f32 the
        parameters are the masters already."""
        if not self.mixed:
            yield
            return
        working = {k: p.data for k, p in self.params.items()}
        try:
            for k, p in self.params.items():
                p.data = self.masters[k]
            yield
        finally:
            for k, p in self.params.items():
                p.data = working[k]

    @torch.no_grad()
    def eval_step(self, x, c=None):
        """The validation losses of `x` (and its labels `c`), computed with
        the f32 masters and encoded by the f32 first stage (the monitored
        `val_loss` ranks the checkpoints)."""
        c = None if c is None else self._to_device(c)
        with self.master_weights():
            total, out = self._losses(self._to_device(x), c, False, None)
        return {"val_loss": total.float(), **{f"val_{k}": out[k].float() for k in _LOSS_KEYS}}

    @torch.no_grad()
    def encode(self, x):
        """The training encode (the JAX trainer's `make_encode_fn`): images
        (B, H, W, 3) on the trainer's device -> the permuter streams, by
        `frozen_first_stage` in its dtype."""
        return self.model.encode_to_z(x, self.frozen_first_stage)[1]

    @torch.no_grad()
    def encode_dataset(self, images, batch: int = 64):
        """Images (N, H, W, 3) -> the permuter streams as a dict of (N, L)
        numpy int arrays, encoded once by `encode`; usable as the `x` of
        `train_step` / `eval_step`."""
        outs = []
        for i in range(0, len(images), batch):
            outs.append(self.encode(torch.as_tensor(np.asarray(images[i:i + batch]))
                                    .to(self.device)))
        # gather after every batch is enqueued, so the host copies do not
        # serialise the encodes
        return {k: np.concatenate([o[k].cpu().numpy() for o in outs], axis=0) for k in outs[0]}
