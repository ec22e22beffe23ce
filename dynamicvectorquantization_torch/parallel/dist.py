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

    def __init__(self, rank: int, size: int, device, backend: str, hosts=None):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.hosts = tuple(hosts or ("localhost",) * self.size)
        self._host_group = None

    def __repr__(self):
        return f"World(rank={self.rank}, size={self.size}, {self.backend}, {self.device})"

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
        _dist().all_reduce(t)
        return t

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        return self.sum_(t).div_(self.size)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        _dist().broadcast(t, src)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors of one shape, concatenated along dim 0 in rank
        order."""
        t = t.contiguous()
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        self.all_gather_into(out, t)
        return out

    def all_gather_into(self, out: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
        _dist().all_gather_into_tensor(out, part)
        return out

    def reduce_scatter(self, out: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
        """out = this rank's part (its contiguous 1 / size) of the sum over
        ranks of `full`."""
        _dist().reduce_scatter_tensor(out, full)
        return out

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
        _dist().barrier()


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
