"""Gradient buckets and the ZeRO-1 / FSDP ownership of a trainer's leaves
(counterpart of `dynamicvectorquantization_tpu/parallel/mesh.py`
`opt_state_shardings` / `zero1_leaf_spec` / `fsdp_param_shardings` and of
`train/loop.py` `_state_shardings`, `shard_min_elements` = 65,536).

`GradBuckets` holds a trainer's gradients for the reduction over ranks in
two flat f32 buffers, not one collective per leaf:

  * the replicated bucket: every leaf that all ranks update whole (all of
    them without sharding; with it the leaves under `min_elements`, as the
    JAX rule keeps them replicated), followed by the step's logs; averaged
    over the ranks with one all-reduce;
  * with `mode` "zero1" or "fsdp", the sharded bucket: each leaf of at least
    `min_elements` elements is cut into `size` contiguous slices of its
    flattened elements (ceil(n / size) rounded up to 64 each, the last ones
    shorter or empty); rank r's slices of every sharded leaf lie together, so one
    reduce-scatter leaves each rank the summed gradient of its own slices.

The optimizer then updates each rank's own slices only (an elementwise
update, so a slice gives the bits the whole leaf would), and `gather` puts
the updated slices of every rank back into the full tensors with one
all-gather. Where the JAX package shards the first axis the device count
divides (and keeps the leaf replicated when none does), the port cuts the
flattened leaf, so every leaf of that size is sharded.

Collectives: all-reduce, reduce-scatter and all-gather into one tensor,
which NCCL and gloo both have.

Under a model axis (`parallel/dist.py` `split_world`) the buckets run over
the dp group, and `keep_whole` names the tensor-parallel shards, which
ZeRO-1 / FSDP leave as they are (their moments stay tp-split, as the JAX
loop's `tree_shardings_like`). Before the dp average, `AxisSum` sums the
gradients that are partial over the model axis in one flat f32 all-reduce:
every leaf under sp (each rank's rows' share), the pipelined layers under
pp (each on its own stage); under tp each rank's gradients are already
whole (the split leaves' shards, and the replicated leaves' equal copies).
"""
from __future__ import annotations

import math

import torch

MODES = (None, "zero1", "fsdp")
SHARD_MIN_ELEMENTS = 65536


class GradBuckets:
    def __init__(self, shapes: dict, world, mode=None, min_elements: int = SHARD_MIN_ELEMENTS,
                 device=None, n_logs: int = 0, keep_whole=()):
        if mode not in MODES:
            raise ValueError(f"shard mode must be one of {MODES}, got {mode!r}")
        self.world, self.mode = world, mode
        size, rank = world.size, world.rank
        device = torch.device(device or world.device)
        self.shapes = {k: torch.Size(s) for k, s in shapes.items()}
        numel = {k: math.prod(s) for k, s in self.shapes.items()}
        keep_whole = set(keep_whole)
        self.sharded = [k for k in shapes if mode is not None and numel[k] >= min_elements
                        and k not in keep_whole]
        shard_set = set(self.sharded)
        self.replicated = [k for k in shapes if k not in shard_set]
        # replicated bucket: leaves, then logs
        self.rep_off, off = {}, 0
        for k in self.replicated:
            self.rep_off[k] = off
            off += numel[k]
        self.n_rep = off
        self.n_logs = int(n_logs)
        self.rep = torch.zeros(off + self.n_logs, dtype=torch.float32, device=device)
        # sharded bucket: per rank a part of `part_len`, each sharded leaf at
        # `part_off` inside it with slices of `slice_len`
        self.slice_len, self.part_off, self.own, off = {}, {}, {}, 0
        for k in self.sharded:
            n = numel[k]
            # slices start at multiples of 64 elements, so a vectorised
            # elementwise update treats each element as the whole leaf's would
            per = -(-n // (size * 64)) * 64
            lo = min(rank * per, n)
            self.slice_len[k], self.part_off[k], self.own[k] = per, off, (lo, min(lo + per, n))
            off += per
        self.part_len = off
        if self.sharded:
            self.full = torch.zeros(size * off, dtype=torch.float32, device=device)
            self.part = torch.zeros(off, dtype=torch.float32, device=device)
        self._gather_bufs = {}
        self._rep_views = {k: self.rep[self.rep_off[k]:self.rep_off[k] + numel[k]]
                           .view(self.shapes[k]) for k in self.replicated}

    # ----------------------------------------------------------- layout
    def own_len(self, name) -> int:
        lo, hi = self.own[name]
        return hi - lo

    def own_slice(self, t: torch.Tensor, name) -> torch.Tensor:
        """This rank's slice of the full tensor `t` of a sharded leaf (a view)."""
        lo, hi = self.own[name]
        return t.reshape(-1)[lo:hi]

    def _columns(self, buf: torch.Tensor, name) -> torch.Tensor:
        """(size, slice_len) view of every rank's slice of `name` in a
        rank-major buffer."""
        off, per = self.part_off[name], self.slice_len[name]
        return buf.view(self.world.size, self.part_len)[:, off:off + per]

    def _scatter_in(self, buf, name, flat):
        """Write the flattened leaf `flat` into its slices of `buf`."""
        cols, per = self._columns(buf, name), self.slice_len[name]
        q, n = flat.numel() // per, flat.numel()
        if q:
            cols[:q].copy_(flat[:q * per].view(q, per))
        if n > q * per:
            cols[q, :n - q * per].copy_(flat[q * per:])

    def _scatter_out(self, buf, name, flat):
        """The inverse of `_scatter_in`: `flat` from its slices in `buf`."""
        cols, per = self._columns(buf, name), self.slice_len[name]
        q, n = flat.numel() // per, flat.numel()
        if q:
            flat[:q * per].view(q, per).copy_(cols[:q])
        if n > q * per:
            flat[q * per:].copy_(cols[q, :n - q * per])

    # ------------------------------------------------------- reduction
    def reduce(self, grads: dict, logs=None):
        """The gradients (and up to `n_logs` stacked logs) averaged over the
        ranks: returns ({name: the full averaged gradient (replicated leaves)
        or this rank's averaged slice (sharded ones)}, the averaged logs)."""
        names = self.replicated
        if names:
            torch._foreach_copy_([self._rep_views[k] for k in names], [grads[k] for k in names])
        n_logs = 0 if logs is None else logs.numel()
        if n_logs:
            self.rep[self.n_rep:self.n_rep + n_logs].copy_(logs)
        self.world.mean_(self.rep)
        out = {k: self._rep_views[k] for k in names}
        if self.sharded:
            for k in self.sharded:
                self._scatter_in(self.full, k, grads[k].reshape(-1))
            self.world.reduce_scatter(self.part, self.full)
            self.part.div_(self.world.size)
            for k in self.sharded:
                off = self.part_off[k]
                out[k] = self.part[off:off + self.own_len(k)]
        return out, (None if logs is None else self.rep[self.n_rep:self.n_rep + n_logs])

    # ----------------------------------------------------------- gather
    def _buffers(self, dtype):
        if dtype not in self._gather_bufs:
            dev = self.rep.device
            self._gather_bufs[dtype] = (
                torch.zeros(self.part_len, dtype=dtype, device=dev),
                torch.zeros(self.world.size * self.part_len, dtype=dtype, device=dev))
        return self._gather_bufs[dtype]

    def gather(self, full: dict, own: dict):
        """full[name] (every sharded leaf, one dtype) <- the slices `own[name]`
        of every rank, in one all-gather."""
        if not self.sharded:
            return
        dtype = full[self.sharded[0]].dtype
        part, whole = self._buffers(dtype)
        for k in self.sharded:
            off = self.part_off[k]
            part[off:off + self.own_len(k)].copy_(own[k])
        self.world.all_gather_into(whole, part)
        for k in self.sharded:
            self._scatter_out(whole, k, full[k].view(-1))

    def gathered(self, own: dict) -> dict:
        """New full tensors of the sharded leaves from every rank's `own` slices."""
        if not self.sharded:
            return {}
        dtype = own[self.sharded[0]].dtype
        full = {k: torch.empty(self.shapes[k], dtype=dtype, device=self.rep.device)
                for k in self.sharded}
        self.gather(full, own)
        return full


class AxisSum:
    """The gradients of `names` summed over a model-axis group `world` in
    one flat f32 all-reduce (see the module docstring)."""

    def __init__(self, shapes: dict, names, world, device):
        self.world = world
        self.names = [k for k in shapes if k in set(names)]
        numel = {k: math.prod(shapes[k]) for k in self.names}
        self.buf = torch.zeros(sum(numel.values()), dtype=torch.float32, device=device)
        self.views, off = {}, 0
        for k in self.names:
            self.views[k] = self.buf[off:off + numel[k]].view(shapes[k])
            off += numel[k]

    def __call__(self, grads: dict) -> dict:
        """`grads` with the named ones replaced by their f32 sums."""
        if not self.names:
            return grads
        torch._foreach_copy_([self.views[k] for k in self.names], [grads[k] for k in self.names])
        self.world.sum_(self.buf)
        return {**grads, **self.views}
