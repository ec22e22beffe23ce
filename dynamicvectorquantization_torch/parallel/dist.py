"""The data-parallel process group of the trainers (counterpart of the dp
half of `dynamicvectorquantization_tpu/parallel/mesh.py`: `make_mesh`,
`batch_sharding`, `make_mesh_multihost`).

The JAX package trains over a mesh inside one GSPMD program: the global
batch is sharded over "dp", and every mean, sum and gather of the step is
global by construction. The port runs one process per device instead
(`torchrun`, or the workers `train/cli.py` spawns) and makes the same
quantities global with explicit collectives:

  * a `World` is this process's rank, the world size, its device and the
    host name of every rank (`host_groups` groups ranks by host, in rank
    order, so that collectives that should stay on one host can be formed;
    `make_mesh_multihost` in the JAX package does not group by process);
  * `rows(n)` is this rank's contiguous share of a global batch of n rows
    (rank r holds rows [r n / N, (r + 1) n / N)), and a global batch the
    world size does not divide raises;
  * `sum_`, `mean_`, `all_gather` (rank order), `broadcast_`,
    `reduce_scatter` and `all_gather_into`: collectives that NCCL and gloo
    both have, so the CPU tests run the card's code path;
  * `global_stats(world)`: the scope in which the model's statistics are
    taken over the global batch. Inside it `global_sum` / `global_mean`
    (differentiable: the backward of a sum over ranks is the sum of the
    ranks' output gradients) and `global_count` reduce over the ranks, and
    are the identity outside it. The quantizer's EMA sums and restart pool,
    the discriminator's BatchNorm and ActNorm, the budget loss's ratio and
    stage 2's loss denominator call them.

NCCL on CUDA, gloo on the CPU (or on CUDA tensors when asked, as the card
runs two processes on one device). Host-side flags (the preemption guard)
travel over a gloo group of their own, so reading them never waits for the
device.

A second axis (counterpart of `make_mesh_2d`, the stage-2 model axes):
`split_world(world, n)` cuts the ranks into groups of n consecutive ranks
inside one host, the model axis (tp, sp or pp), and the groups of the ranks
at the same place of every model group, the dp axis; each is a `World` over
its own process group (`ranks`: its members' global ranks), and a model
axis that does not divide a host's ranks raises (`make_mesh_multihost`
lays devices without regard to hosts). The model axis's own operations:

  * `shift(t, step)`: rank r receives rank r - step's tensor, as `ppermute`
    with `perm = [(i, (i + step) % n)]`; `ring_shift` is its differentiable
    form, whose backward shifts the other way;
  * `copy_to_group` (identity forward, all-reduce backward) and
    `reduce_from_group` (all-reduce forward, identity backward), the two
    Megatron conjugates around a column- and a row-split Linear;
  * `gather_dim`: the group's tensors concatenated along a dim, whose
    backward keeps this rank's part.

Point to point goes through `batch_isend_irecv`. The backend table of
PyTorch lists gloo's send / recv, all-gather and reduce-scatter for CPU
tensors only, so under gloo a CUDA tensor takes those hops through pinned
host memory (`World.transport`): that is gloo's transport, chosen by the
backend, not a fallback; NCCL takes the device tensors.
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
import socket
from typing import Optional

import torch

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("dqvq_global_stats", default=None)


def _dist():
    import torch.distributed as dist

    return dist


def group_by_host(hosts) -> list:
    """[(ranks of one host, in rank order), ...], hosts in order of their
    first rank."""
    groups = {}
    for rank, host in enumerate(hosts):
        groups.setdefault(host, []).append(rank)
    return [tuple(r) for r in groups.values()]


class World:
    """One rank of a data-parallel group (see the module docstring)."""

    def __init__(self, rank: int, size: int, device, backend: str, hosts=None, group=None,
                 ranks=None):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.hosts = tuple(hosts or ("localhost",) * self.size)
        self.group = group  # None: the default process group
        self.ranks = tuple(range(self.size) if ranks is None else ranks)  # members' global ranks
        self.moved = {}  # bytes each collective of this world was handed, by operation
        self._host_group = None

    def __repr__(self):
        return f"World(rank={self.rank}, size={self.size}, {self.backend}, {self.device})"

    @property
    def transport(self) -> str:
        """How point-to-point hops, all-gathers and reduce-scatters move this
        world's tensors."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo via pinned host memory"
        return self.backend

    def _staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _count(self, op, t):
        self.moved[op] = self.moved.get(op, 0) + t.numel() * t.element_size()

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def host_groups(self) -> list:
        return group_by_host(self.hosts)

    def rows(self, n: int) -> slice:
        if n % self.size:
            raise ValueError(f"a global batch of {n} rows does not divide over "
                             f"{self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    # ------------------------------------------------------- collectives
    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        if self.backend == "gloo" and t.dtype == torch.bfloat16:  # summed in f32, rounded once
            return t.copy_(self.sum_(t.float()))
        self._count("all_reduce", t)
        _dist().all_reduce(t, group=self.group)
        return t

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        return self.sum_(t).div_(self.size)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """t <- member `src`'s t (src: the rank inside this world)."""
        self._count("broadcast", t)
        _dist().broadcast(t, self.ranks[src], group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors of one shape, concatenated along dim 0 in rank
        order."""
        t = t.contiguous()
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        self.all_gather_into(out, t)
        return out

    def all_gather_into(self, out: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
        self._count("all_gather", part)
        if self._staged():
            host = _pinned(out)
            _dist().all_gather_into_tensor(host, _pinned(part, copy=True), group=self.group)
            return out.copy_(host)
        _dist().all_gather_into_tensor(out, part, group=self.group)
        return out

    def reduce_scatter(self, out: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
        """out = this rank's part (its contiguous 1 / size) of the sum over
        ranks of `full`."""
        self._count("reduce_scatter", full)
        if self._staged():
            host = _pinned(out)
            _dist().reduce_scatter_tensor(host, _pinned(full, copy=True), group=self.group)
            return out.copy_(host)
        _dist().reduce_scatter_tensor(out, full, group=self.group)
        return out

    def shift(self, t: torch.Tensor, step: int = 1) -> torch.Tensor:
        """Every rank sends `t` to rank (r + step) % n and returns what rank
        (r - step) % n sent (`ppermute` with `perm = [(i, (i + step) % n)]`);
        one shape and dtype on every rank."""
        t = t.contiguous()
        if self.size == 1:
            return t.clone()
        dist = _dist()
        self._count("shift", t)
        staged = self._staged()
        src = _pinned(t, copy=True) if staged else t
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, self.ranks[(self.rank + step) % self.size],
                          group=self.group),
               dist.P2POp(dist.irecv, out, self.ranks[(self.rank - step) % self.size],
                          group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out.to(t.device) if staged else out

    def any(self, flag: bool) -> bool:
        """Whether any rank's host-side flag is set (over gloo: no device sync)."""
        if self.size == 1:
            return bool(flag)
        dist = _dist()
        if self._host_group is None:  # None: the default group, when that is gloo
            self._host_group = None if self.backend == "gloo" else dist.new_group(backend="gloo")
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._host_group)
        return bool(t.item())

    def barrier(self):
        _dist().barrier(group=self.group)


def _pinned(t: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """A pinned host tensor of `t`'s shape and dtype (holding `t` with `copy`)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t) if copy else host


def split_world(world: World, n: int):
    """(dp world, model-axis world) of this rank: model groups of `n`
    consecutive ranks inside each host (the inner axis, as `make_mesh_2d`
    lays it), dp groups of the ranks at one place of every model group.
    Every rank calls it (each group is made by every rank, in one order)."""
    if n < 1 or world.size % n:
        raise ValueError(f"a model axis of {n} does not divide {world.size} ranks")
    model_groups = []
    for ranks in world.host_groups():
        if len(ranks) % n:
            raise ValueError(f"a model axis of {n} does not divide the {len(ranks)} ranks of a "
                             f"host ({ranks}): its groups stay inside one host")
        model_groups += [ranks[i:i + n] for i in range(0, len(ranks), n)]
    dp_groups = [tuple(g[j] for g in model_groups) for j in range(n)]
    dist = _dist()
    mine = {}
    for kind, groups in (("model", model_groups), ("dp", dp_groups)):
        for ranks in groups:
            g = dist.new_group(list(ranks))
            if world.rank in ranks:
                mine[kind] = World(ranks.index(world.rank), len(ranks), world.device,
                                   world.backend, [world.hosts[r] for r in ranks], g, ranks)
    return mine["dp"], mine["model"]


# ---------------------------------------------------------------- setup
def env_world_size() -> Optional[int]:
    """WORLD_SIZE of a `torchrun` launch, or None outside one."""
    ws = os.environ.get("WORLD_SIZE")
    return int(ws) if ws and "RANK" in os.environ else None


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(device_type: str = "cuda", rank: Optional[int] = None,
               size: Optional[int] = None, init_method: Optional[str] = None,
               backend: Optional[str] = None, local_rank: Optional[int] = None) -> World:
    """Join (or start) the process group: from `torchrun`'s environment
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` / `MASTER_PORT`) when
    `rank` is None, else from the arguments (`init_method`
    `tcp://127.0.0.1:<port>`). NCCL on CUDA, gloo on the CPU unless
    `backend` says otherwise; the rank's device is `cuda:<local rank>`, or
    the CPU."""
    dist = _dist()
    if rank is None:
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        init_method = init_method or "env://"
    local_rank = rank if local_rank is None else local_rank
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        device = torch.device("cuda", local_rank % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    if not dist.is_initialized():
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size,
                                timeout=datetime.timedelta(minutes=10), **kw)
    hosts = [None] * size
    dist.all_gather_object(hosts, socket.gethostname())
    return World(rank, size, device, backend, hosts)


def shutdown():
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------- global statistics
@contextlib.contextmanager
def global_stats(world: Optional[World]):
    """Inside: the model's batch statistics are over every rank's rows."""
    token = _ACTIVE.set(world)
    try:
        yield world
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[World]:
    """The world of the enclosing `global_stats` scope, or None."""
    return _ACTIVE.get()


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, world):
        ctx.world = world
        return world.sum_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.world.sum_(g.contiguous().clone()), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, world):
        ctx.world = world
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.world.sum_(g.contiguous().clone()), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, world):
        return world.sum_(t.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, world, step):
        ctx.world, ctx.step = world, step
        return world.shift(t, step)

    @staticmethod
    def backward(ctx, g):
        return ctx.world.shift(g, -ctx.step), None, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, world, dim):
        ctx.world, ctx.dim, ctx.n = world, dim, t.shape[dim]
        return world.all_gather(t.movedim(dim, 0)).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.world.rank, ctx.n
        return g.narrow(ctx.dim, r * n, n), None, None


def copy_to_group(t: torch.Tensor, world: World) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over `world` (before
    a column-split Linear: every rank's slice of the output has its share of
    the input's gradient)."""
    return _CopyToGroup.apply(t, world)


def reduce_from_group(t: torch.Tensor, world: World) -> torch.Tensor:
    """Sum over `world` forward (after a row-split Linear); identity
    backward (the sum's consumers are replicated, so each rank's gradient is
    the whole one)."""
    return _ReduceFromGroup.apply(t, world)


def ring_shift(t: torch.Tensor, world: World, step: int = 1) -> torch.Tensor:
    """`World.shift` with its gradient: the backward shifts the other way."""
    return _RingShift.apply(t, world, step)


def gather_dim(t: torch.Tensor, world: World, dim: int) -> torch.Tensor:
    """The ranks' tensors concatenated along `dim` in rank order; the
    backward hands each rank its part of the gradient (the consumers are
    replicated over `world`)."""
    return _GatherDim.apply(t, world, dim)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks inside a `global_stats` scope (with its
    gradient), else `t`."""
    world = active()
    return t if world is None else _SumOverRanks.apply(t, world)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the ranks (equal shares of the global batch)."""
    world = active()
    return t if world is None else _SumOverRanks.apply(t, world) / world.size


def global_count(t: torch.Tensor) -> torch.Tensor:
    """A count (no gradient) summed over the ranks, else `t`."""
    world = active()
    return t if world is None else world.sum_(t.detach().clone())


def world_size() -> int:
    """The size of the active scope's world (1 outside one)."""
    world = active()
    return 1 if world is None else world.size


def all_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `t` concatenated in rank order (the global
    batch's rows), else `t`; no gradient."""
    world = active()
    return t if world is None else world.all_gather(t.detach())
