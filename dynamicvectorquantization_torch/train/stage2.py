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

Over several ranks (`world`, a `parallel.dist.World`), each rank takes its
rows of the global batch, and the step equals the one-process step over the
global batch up to the order of the sums, as the JAX step under GSPMD does:
the forward runs inside `global_stats` (the loss's denominator counts the
global batch's valid targets), and the pad-frozen gradients and the logs
are averaged over the ranks in flat buckets (`parallel/shard.py`) before
the AdamW kernel runs. `shard="zero1"` keeps the moments of leaves of at
least `shard_min_elements` elements as each rank's contiguous slice
(gradients reduce-scattered to their owners, the kernel run on the slice,
the updated leaves all-gathered); `shard="fsdp"` also keeps the f32 masters
of those leaves as slices under bf16 (the full bf16 working copy is
gathered; under f32 the masters are the working parameters, so FSDP is
ZeRO-1 there). Elementwise updates of slices give the unsharded bits.
On CUDA the cached-codes step captures the collectives with the step
(NCCL); a gloo world runs it eagerly (gloo cannot be captured). Dropout draws
are per rank: the rank is mixed into the attention seeds and the
elementwise generator's seed.

Model parallelism (`tp`, `sp` or `pp` > 1; one of them, over data
parallelism; counterpart of the JAX loop's (dp, tp | sp | pp) mesh and
`models/dqtransformer.py` `transformer_train_apply`): the world splits into
a dp group and a model-axis group (`parallel/dist.py` `split_world`). The
dp group plays the world's part above (rows, global statistics, gradient
average, ZeRO-1 / FSDP slices); the dropout streams mix in the dp rank and
never the model-axis rank, so replicated activations draw equal masks
across a model group.

  * tp: the blocks hold their shards (`parallel/mesh.py` `shard_stage2`),
    and so do the masters and moments of the split leaves, which ZeRO-1 /
    FSDP leave whole. The attention kernels run the rank's heads with the
    head offset, so the tp step draws the one-process step's masks.
  * sp / pp: the training forward is `parallel/stackgpt_sp.py` /
    `stackgpt_pp.py` (installed as the model's `transformer_train_forward`),
    the parameters stay whole on every rank, and the gradients that are
    partial over the axis are summed over it first (`parallel/shard.py`
    `AxisSum`). The blocks draw their dropout per sp / pp rank.

AdamW stays the fused kernel (#9) on each rank's shard or slice: the JAX
loop turns its fused AdamW off under tp because its Pallas call takes
unsharded leaves, while #9 is elementwise, so a shard gives the bits the
whole leaf would. A checkpoint holds whole leaves (`state_dict` gathers the
tp shards); `load_state_dict` cuts a whole state to the rank's shards, so a
`--tp 2` checkpoint loads in one process and back. On CUDA the tp step is
captured as DDP's is (NCCL); the sp and pp steps and every gloo step run
eagerly. Validation and the loop's image grids run on the whole f32
masters (`master_weights` gathers the shards and runs the blocks dense).

The epoch loop, checkpoints and data loading live in `train/loop.py`.
"""
from __future__ import annotations

import contextlib
import copy
import functools

import numpy as np
import torch
from torch import nn

from ..models.graphs import parameter_storage, runner_for
from ..nn.transformer import CausalSelfAttention
from ..ops.attention import attention_seed, mix_seed
from ..ops.fused_adamw import adamw_scalars, fused_adamw_step
from ..parallel import mesh
from ..parallel.dist import global_stats, split_world
from ..parallel.shard import SHARD_MIN_ELEMENTS, AxisSum, GradBuckets
from ..parallel.stackgpt_pp import check_microbatches, stackgpt_forward_pp
from ..parallel.stackgpt_sp import stackgpt_forward_sp
from ..utils.device import resolve_device
from .schedules import warmup_cosine

B1, B2, EPS = 0.9, 0.95, 1e-8
_LOSS_KEYS = ("content_loss", "position_loss", "coarse_position_loss", "fine_position_loss")
_LOG_NAMES = ("train_loss",) + tuple(f"train_{k}" for k in _LOSS_KEYS)
_ELEMENTWISE = 0xE1E  # stream tag of the embedding / residual dropout generator
AXES_EXCLUSIVE = ("--tp/--sp/--pp are mutually exclusive axes (supported matrix: "
                  "dp x {tp|sp|pp} x {ZeRO-1|FSDP}; see docs/PARALLELISM.md)")


def model_axis(tp=1, sp=1, pp=1):
    """("tp" | "sp" | "pp", size) of the one model axis above 1, or None;
    two raise, as the JAX launcher refuses them."""
    axes = [(name, int(n)) for name, n in (("tp", tp), ("sp", sp), ("pp", pp)) if int(n) > 1]
    if len(axes) > 1:
        raise ValueError(AXES_EXCLUSIVE)
    return axes[0] if axes else None


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


def _is_text(c) -> bool:
    """Whether a condition is captions (a list of strings, or of such lists
    with `accum > 1`), which no tensor holds."""
    return isinstance(c, (list, tuple)) and (not c or isinstance(c[0], (str, list, tuple)))


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
                 max_steps=1_000_000, accum=1, compute_dtype=None, device=None, seed=0,
                 world=None, shard=None, shard_min_elements=SHARD_MIN_ELEMENTS, tp=1, sp=1,
                 pp=1, pp_microbatches=2):
        if compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
        if shard is not None and world is None:
            raise ValueError("sharding the optimizer state needs a world of ranks")
        axis = model_axis(tp, sp, pp)
        if axis is not None and world is None:
            raise ValueError(f"--{axis[0]} {axis[1]} needs a world of ranks")
        self.world, self.shard = world, shard
        self.axis = None if axis is None else axis[0]
        self.pp_microbatches = int(pp_microbatches)
        # the dp group and the model-axis group (the dp group is the world
        # without a model axis)
        self.dp_world, self.axis_world = (world, None) if axis is None else split_world(
            world, axis[1])
        self.device = resolve_device(device if world is None else world.device)
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
        # {name: dim} of the leaves held as tensor-parallel shards
        self.tp_dims = mesh.shard_stage2(tf, self.axis_world) if self.axis == "tp" else {}
        model.transformer_train_forward = (
            functools.partial(stackgpt_forward_sp, tf, self.axis_world) if self.axis == "sp" else
            functools.partial(stackgpt_forward_pp, tf, self.axis_world, self.pp_microbatches)
            if self.axis == "pp" else None)
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
        self.buckets = None
        shapes = {k: p.shape for k, p in self.params.items()}
        # no buckets where one dp rank has nothing to average or slice
        if world is not None and (axis is None or self.dp_world.size > 1 or shard is not None):
            self.buckets = GradBuckets(shapes, self.dp_world, shard, shard_min_elements,
                                       self.device, len(_LOG_NAMES), keep_whole=self.tp_dims)
            if shard == "fsdp" and self.mixed:  # sharded leaves keep their masters' slices
                for k in self.buckets.sharded:
                    self.masters[k] = self.buckets.own_slice(self.masters[k], k).clone()
        self.axis_sum = None
        if self.axis == "sp":
            self.axis_sum = AxisSum(shapes, shapes, self.axis_world, self.device)
        elif self.axis == "pp":
            self.axis_sum = AxisSum(shapes, [k for k in shapes if k.startswith(
                "content_transformer.")], self.axis_world, self.device)
        self.m = {k: torch.zeros(self._moment_shape(k), device=self.device) for k in self.masters}
        self.v = {k: torch.zeros(self._moment_shape(k), device=self.device) for k in self.masters}
        self.count = 0
        self.epoch = 0
        self.base_seed = int(seed)
        self.generator = torch.Generator(device=self.device)
        self.n_layers = sum(isinstance(m, CausalSelfAttention) for m in tf.modules())
        self._step_states = {}  # batch signature -> _StepState
        self._dense = 0  # depth of `master_weights` scopes
        self.refresh_first_stage()

    def refresh_first_stage(self):
        """(Re)build `frozen_first_stage` from the model's first stage: a bf16
        copy under bf16, the module itself under f32."""
        fs = self.model.first_stage_model
        self.frozen_first_stage = cast_copy(fs) if self.mixed else fs

    # ------------------------------------------------------------- state
    def _sharded(self, name) -> bool:
        return self.buckets is not None and name in self.buckets.own

    def _moment_shape(self, name):
        return (self.buckets.own_len(name),) if self._sharded(name) else self.params[name].shape

    def _master_sharded(self, name) -> bool:
        return self.shard == "fsdp" and self.mixed and self._sharded(name)

    def _full(self, tensors: dict, sharded) -> dict:
        """`tensors` with the leaves for which `sharded(name)` holds gathered
        from every rank's slices (a collective: every rank calls it)."""
        names = [k for k in tensors if sharded(k)]
        return {**tensors, **(self.buckets.gathered({k: tensors[k] for k in names})
                              if names else {})}

    def _own(self, name, full):
        return self.buckets.own_slice(full, name) if self._sharded(name) else full

    def _whole(self, tensors: dict) -> dict:
        """`tensors` with the tensor-parallel shards gathered whole (a
        collective over the tp group)."""
        return {k: mesh.gather(t, self.tp_dims[k], self.axis_world) if k in self.tp_dims else t
                for k, t in tensors.items()}

    def _tp_shard(self, name, full):
        """The rank's tensor-parallel shard of a whole leaf (the leaf itself
        when it is not split)."""
        dim = self.tp_dims.get(name)
        return full if dim is None else mesh.shard(full, dim, self.axis_world)

    def state_dict(self):
        """The whole training state: f32 masters, both moments, the step
        count, the epoch and the base seed of the dropout streams; sharded
        leaves and tensor-parallel shards gathered whole from every rank
        (every rank calls it)."""
        return {"masters": self._whole(self._full(dict(self.masters), self._master_sharded)),
                "m": self._whole(self._full(dict(self.m), self._sharded)),
                "v": self._whole(self._full(dict(self.v), self._sharded)),
                "count": self.count, "epoch": self.epoch, "seed": self.base_seed}

    def load_state_dict(self, state):
        """Continue from a `state_dict()`: the masters (and from them the
        bf16 working copy, which is their rounding), the moments, the counts
        and the base seed."""
        if set(state["masters"]) != set(self.masters):
            raise KeyError("training state does not match the transformer's parameters")
        with torch.no_grad():
            for k, p in self.params.items():
                full = self._tp_shard(k, state["masters"][k].to(self.device))
                if self._master_sharded(k):
                    self.masters[k].copy_(self._own(k, full.to(self.device)))
                else:
                    self.masters[k].copy_(full)
                if self.mixed:
                    p.copy_(full)
        self.load_optimizer_state(state["count"], state["m"], state["v"])
        self.epoch = int(state["epoch"])
        self.base_seed = int(state["seed"])

    def load_optimizer_state(self, count: int, m: dict, v: dict):
        """Continue from a (count, m, v) state keyed by parameter name, e.g.
        `utils.weights.adamw_state_from_optax` of a JAX training state."""
        if set(m) != set(self.masters) or set(v) != set(self.masters):
            raise KeyError("optimizer state does not match the transformer's parameters")
        for k in self.masters:
            self.m[k].copy_(self._own(k, self._tp_shard(k, m[k].to(self.device))))
            self.v[k].copy_(self._own(k, self._tp_shard(k, v[k].to(self.device))))
        self.count = int(count)

    # -------------------------------------------------------------- steps
    def _to_device(self, x):
        if _is_text(x):  # captions stay on the host: the model's text encoder reads them
            return x
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
            generator = self._seeded_generator()
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
            with global_stats(self.dp_world):
                self._check_batch(xi)
                total, out = self._losses(xi, ci, True, generator, self._seed(i),
                                          self.frozen_first_stage)
                g = self._grad(total, params)
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

    def _grad(self, total, params):
        """d total / d params; under pp another stage's layers get zeros."""
        if self.axis != "pp":
            return torch.autograd.grad(total, params)
        g = torch.autograd.grad(total, params, allow_unused=True)
        return [torch.zeros_like(p) if t is None else t for p, t in zip(params, g)]

    def _check_batch(self, x):
        """Under pp, JAX's conditions on the global batch and the microbatches."""
        if self.axis == "pp":
            leaf = next(iter(x.values())) if isinstance(x, dict) else x
            dp = self.dp_world.size
            check_microbatches(leaf.shape[0] * dp, self.pp_microbatches, dp)

    def _seed(self, microbatch):
        """The attention seed of a training forward; the dp rank mixed in
        over several dp ranks, so each draws its own masks (the ranks of one
        model group draw alike)."""
        seed = attention_seed(self.base_seed, self.count, microbatch)
        dp = self.dp_world
        return seed if dp is None or dp.size == 1 else mix_seed(seed, dp.rank)

    def _seeded_generator(self):
        """The trainer's elementwise-dropout generator, re-seeded for this
        step (and dp rank)."""
        seed = mix_seed(self.base_seed, self.count, _ELEMENTWISE)
        dp = self.dp_world
        if dp is not None and dp.size > 1:
            seed = mix_seed(seed, dp.rank)
        self.generator.manual_seed(seed >> 1)
        return self.generator

    def _update(self, grads, lr, c1=None, c2=None):
        """AdamW over every parameter: lr, c1, c2 as floats, or as the (3,)
        device tensor `lr` the kernels read on the device. Over several ranks
        `grads` are the averaged ones, a sharded leaf's its rank's slice: the
        kernel updates that slice, then every rank's updated slices are
        gathered into the full leaves."""
        for name, p in self.params.items():
            wd = self.weight_decay if name in self.decayed else 0.0
            if not self._sharded(name):
                fused_adamw_step(grads[name].contiguous(), self.masters[name], self.m[name],
                                 self.v[name], lr, c1, c2, B1, B2, EPS, wd,
                                 copy=p.data if self.mixed else None)
            elif self.buckets.own_len(name):
                master = (self.masters[name] if self._master_sharded(name)
                          else self._own(name, self.masters[name]))
                fused_adamw_step(grads[name], master, self.m[name], self.v[name], lr, c1, c2,
                                 B1, B2, EPS, wd,
                                 copy=self._own(name, p.data) if self.mixed else None)
        if self.buckets is not None and self.buckets.sharded:
            self._gather_updated()

    def _gather_updated(self):
        """Every rank's updated slices into the full leaves: the bf16 working
        copy under FSDP, the f32 masters (then their bf16 rounding) under
        ZeRO-1, the f32 parameters under f32."""
        b = self.buckets
        if self.mixed and self.shard == "fsdp":
            full = {k: self.params[k].data for k in b.sharded}
        else:
            full = {k: self.masters[k] for k in b.sharded}
        b.gather(full, {k: b.own_slice(full[k], k) for k in b.sharded})
        if self.mixed and self.shard != "fsdp":
            torch._foreach_copy_([self.params[k].data for k in b.sharded],
                                 [self.masters[k] for k in b.sharded])

    def _reduce(self, grads, logs):
        """(gradients, logs) summed over the model axis where partial, then
        averaged over the dp ranks (see `_update`)."""
        if self.axis_sum is not None:
            grads = self.axis_sum(grads)
        if self.buckets is None:
            return grads, logs
        return self.buckets.reduce(grads, logs)

    def apply_update(self, grads, logs=None):
        """One AdamW update of every parameter from `grads` (this rank's:
        over several ranks they and the stacked `logs` are averaged first);
        returns the logs as they were applied."""
        grads, logs = self._reduce(grads, logs)
        self._update(grads, *adamw_scalars(self.count, self.schedule, B1, B2))
        self.count += 1
        return logs

    def seed_table(self):
        """The attention-dropout seeds of the next step, one per layer of the
        model, as `nn/transformer.py` mixes them from `attention_seed`
        (microbatch 0; the rank mixed in over several ranks), as int64 (their
        64 bits)."""
        seed = self._seed(0)
        return np.array([mix_seed(seed, i) for i in range(self.n_layers)],
                        dtype=np.uint64).view(np.int64)

    def _static_step(self, st: _StepState, generator):
        """One optimizer step that reads its inputs from `st` and writes its
        logs there: what a CUDA graph captures and replays."""
        names, params = zip(*self.params.items())
        # sp / pp run eagerly with the host seed (they mix in the rank and
        # the microbatch on the host)
        seeds = st.seeds if self.axis in (None, "tp") else self._seed(0)
        with global_stats(self.dp_world):
            self._check_batch(st.x)
            total, out = self._losses(st.x, st.c, True, generator, seeds)
            grads = dict(zip(names, self._grad(total, params)))
        for name, pad in self.pad_rows.items():
            grads[name][pad] = 0.0
        logs = torch.stack([total.detach().float()] + [out[k].detach().float() for k in _LOSS_KEYS])
        grads, logs = self._reduce(grads, logs)
        st.logs.copy_(logs)
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
            generator = self._seeded_generator()
        graphs = self.device.type == "cuda" and not eager and self.axis in (None, "tp") and (
            self.world is None or self.world.backend == "nccl")
        if graphs:
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
        if self.world is None:
            self.apply_update(grads)
            return logs
        stacked = self.apply_update(grads, torch.stack([logs[k] for k in _LOG_NAMES]))
        return dict(zip(_LOG_NAMES, stacked.clone().unbind()))

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
        parameters are the masters already. Under tp the masters are
        gathered whole and the blocks compute dense (the KV-cached sampler
        runs on whole weights). Nested scopes are the outer one."""
        if self._dense or not (self.mixed or self.tp_dims):
            self._dense += 1
            try:
                yield
            finally:
                self._dense -= 1
            return
        working = {k: p.data for k, p in self.params.items()}
        masters = self._full(dict(self.masters if self.mixed else working),
                             self._master_sharded)
        masters = self._whole(masters)
        self._dense += 1
        try:
            for k, p in self.params.items():
                p.data = masters[k]
            if self.tp_dims:
                mesh.set_tp_group(self.model.transformer, None)
            yield
        finally:
            self._dense -= 1
            for k, p in self.params.items():
                p.data = working[k]
            if self.tp_dims:
                mesh.set_tp_group(self.model.transformer, self.axis_world)

    @torch.no_grad()
    def eval_step(self, x, c=None):
        """The validation losses of `x` (and its labels `c`), computed with
        the f32 masters and encoded by the f32 first stage (the monitored
        `val_loss` ranks the checkpoints)."""
        c = None if c is None else self._to_device(c)
        with self.master_weights(), global_stats(self.dp_world):
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
