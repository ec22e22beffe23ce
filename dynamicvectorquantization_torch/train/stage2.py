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
would have drawn, whatever the number of steps per dispatch. The attention
kernels get a seed per layer (`ops.attention.attention_seed`, mixed on the
host: no device sync); the trainer's own `torch.Generator`, which feeds the
embedding and residual dropouts, is re-seeded from the base seed at every
step. A caller that passes its own generator keeps that generator's stream
instead.

The step on cached codes (dict streams, `accum == 1`), the JAX loop's
compiled step: `_static_step` reads everything that changes between steps
from preallocated tensors (`_StepState`: the batch's streams, a class
model's labels, the table of the step's attention seeds, one per layer, and
AdamW's (lr, c1, c2)) and writes its logs into a static slot. Before each
step the host copies the step's inputs in (stream-ordered: the batch device
to device, the seeds and scalars from pinned memory without blocking) and
re-seeds the elementwise-dropout generator. On the CPU it runs eagerly; on
CUDA it replays one CUDA graph of the whole step, forward, backward,
pad-row zeroing and every AdamW launch (`models/graphs.py` `GraphRunner`;
the key holds the batch's shapes and dtypes, the compute dtype, the dropout
rates, the storage of the working copy and of the masters and moments), the
first call of a key run eagerly on the runner's side stream and then
captured. The same function runs both ways, so the CPU tests hold what the
card replays; `eager=True` runs it without the graph (a control). A capture
or replay that fails raises. The inline-encode step (images, or `accum >
1`) stays eager, op by op, as the stage-1 step does: K steps a dispatch run
as K such steps.

The epoch loop, checkpoints and data loading live in `train/loop.py`; the
parallel trainers are not ported (ROADMAP.md).
"""
from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch
from torch import nn

from ..models.graphs import parameter_storage, runner_for
from ..nn.transformer import CausalSelfAttention
from ..ops.attention import attention_seed, mix_seed
from ..ops.fused_adamw import adamw_scalars, fused_adamw_step
from ..utils.device import resolve_device
from .schedules import warmup_cosine

B1, B2, EPS = 0.9, 0.95, 1e-8
_LOSS_KEYS = ("content_loss", "position_loss", "coarse_position_loss", "fine_position_loss")
_LOG_NAMES = ("train_loss",) + tuple(f"train_{k}" for k in _LOSS_KEYS)
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


def _signature(x, c):
    """Names, shapes and dtypes of a step's streams and labels."""
    return (tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(x.items())),
            None if c is None else (tuple(c.shape), c.dtype))


def _fill_from_host(dst, values):
    """dst[:] = values (a list of numbers, or a numpy array), ordered on the
    current stream: on CUDA from pinned memory without blocking the host (the
    pinned block is not reused before the copy has run), so a graph replayed
    next reads them."""
    src = torch.from_numpy(np.ascontiguousarray(values))
    if dst.device.type == "cuda":
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


class _StepState:
    """The static tensors of the cached-codes step: inputs the host fills
    before each step and the logs it writes."""

    def __init__(self, x, c, n_layers, device):
        self.x = {k: torch.empty_like(v, device=device) for k, v in x.items()}
        self.c = None if c is None else torch.empty_like(c, device=device)
        self.seeds = torch.zeros(n_layers, dtype=torch.int64, device=device)
        self.scalars = torch.zeros(3, dtype=torch.float32, device=device)  # lr, c1, c2
        self.logs = torch.zeros(len(_LOG_NAMES), dtype=torch.float32, device=device)


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
        self.n_layers = sum(isinstance(m, CausalSelfAttention) for m in tf.modules())
        self._step_states = {}  # batch signature -> _StepState
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

    def _update(self, grads, lr, c1=None, c2=None):
        """AdamW over every parameter: lr, c1, c2 as floats, or as the (3,)
        device tensor `lr` the kernels read on the device."""
        for name, p in self.params.items():
            wd = self.weight_decay if name in self.decayed else 0.0
            fused_adamw_step(grads[name].contiguous(), self.masters[name], self.m[name],
                             self.v[name], lr, c1, c2, B1, B2, EPS, wd,
                             copy=p.data if self.mixed else None)

    def apply_update(self, grads):
        """One AdamW update of every parameter from `grads`."""
        self._update(grads, *adamw_scalars(self.count, self.schedule, B1, B2))
        self.count += 1

    def seed_table(self):
        """The attention-dropout seeds of the next step, one per layer of the
        model, as `nn/transformer.py` mixes them from `attention_seed`
        (microbatch 0), as int64 (their 64 bits)."""
        seed = attention_seed(self.base_seed, self.count, 0)
        return np.array([mix_seed(seed, i) for i in range(self.n_layers)],
                        dtype=np.uint64).view(np.int64)

    def _static_step(self, st: _StepState, generator):
        """One optimizer step that reads its inputs from `st` and writes its
        logs there: what a CUDA graph captures and replays."""
        names, params = zip(*self.params.items())
        total, out = self._losses(st.x, st.c, True, generator, st.seeds)
        grads = dict(zip(names, torch.autograd.grad(total, params)))
        for name, pad in self.pad_rows.items():
            grads[name][pad] = 0.0
        st.logs.copy_(torch.stack([total.detach().float()]
                                  + [out[k].detach().float() for k in _LOSS_KEYS]))
        self._update(grads, st.scalars)

    def _graph_key(self, st: _StepState):
        """Everything a capture of `_static_step(st)` bakes in: the batch's
        signature, the compute dtype, the dropout rates, the storage of the
        working copy (a `master_weights` swap changes it) and of the masters
        and moments."""
        tf = self.model.transformer
        rates = tuple(v for mod in tf.modules() for k, v in sorted(vars(mod).items())
                      if k.endswith("_pdrop"))
        state = tuple(t.data_ptr() for d in (self.masters, self.m, self.v) for t in d.values())
        return ("stage2_step", _signature(st.x, st.c), self.mixed, rates,
                parameter_storage(tf), state)

    def _cached_step(self, x, generator, c, eager):
        x = self._to_device(x)
        c = None if c is None else self._to_device(c)
        sig = _signature(x, c)
        if sig not in self._step_states:
            self._step_states[sig] = _StepState(x, c, self.n_layers, self.device)
        st = self._step_states[sig]
        for k, v in x.items():
            st.x[k].copy_(v, non_blocking=True)
        if c is not None:
            st.c.copy_(c, non_blocking=True)
        _fill_from_host(st.seeds, self.seed_table())
        _fill_from_host(st.scalars, np.array(adamw_scalars(self.count, self.schedule, B1, B2),
                                             dtype=np.float32))
        if generator is None:
            generator = self.generator
            generator.manual_seed(mix_seed(self.base_seed, self.count, _ELEMENTWISE) >> 1)
        if self.device.type == "cuda" and not eager:
            runner = runner_for(self, self.device)
            with runner.carry_generator(generator) as g:
                runner.run(self._graph_key(st), lambda: self._static_step(st, g),
                           release_cache=True)
        else:
            self._static_step(st, generator)
        self.count += 1
        # a copy: the slot is written again by the next step
        return dict(zip(_LOG_NAMES, st.logs.clone().unbind()))

    def train_step(self, x, generator=None, c=None, eager=False):
        """One optimizer step; returns the logs (0-d tensors on the device).
        Cached streams (a dict) at `accum == 1` take the static-state step,
        on CUDA a CUDA graph replay (`eager=True`: the same step op by op, a
        control); images or `accum > 1` the eager step."""
        if isinstance(x, dict) and self.accum == 1:
            return self._cached_step(x, generator, c, eager)
        logs, grads = self.compute_grads(x, generator, c)
        self.apply_update(grads)
        return logs

    def train_steps(self, xs, generator=None, cs=None, eager=False):
        """K full optimizer steps over xs (and their labels `cs`) with a
        leading (K,) axis, each a `train_step`; returns the logs stacked per
        step."""
        xs = self._to_device(xs)
        k = len(next(iter(xs.values()))) if isinstance(xs, dict) else len(xs)
        steps = [self.train_step({n: v[i] for n, v in xs.items()} if isinstance(xs, dict)
                                 else xs[i], generator, None if cs is None else cs[i], eager)
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
