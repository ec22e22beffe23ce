"""Ring attention: causal self-attention with the sequence sharded over a
model-axis group, the "sp" axis (counterpart of
`dynamicvectorquantization_tpu/parallel/ring_attention.py`
`ring_attention`).

Each rank holds a contiguous T / n slice of the sequence's q, k, v (rank i
positions [i T / n, (i + 1) T / n)); the K / V blocks hop around the ring
(`World.shift`, the JAX function's `ppermute`) and every rank folds the
visiting block into its rows. As the JAX function, the arithmetic is f32
whatever the inputs' dtype (q, k, v are cast first, the output back), and
there is no attention-probability dropout.

Where the JAX function is plain `jax.lax` (an online softmax over einsums),
each tick here is a call of the port's own attention kernels
(`ops/attention.py`, f32 at hd 64 / 128 on the 3xTF32 family): at tick r
rank i holds the block of rank src = (i - r) mod n, and

  * src == i, the diagonal block: a causal call;
  * src < i, an earlier block: a call without the causal mask;
  * src > i, a later block: skipped. Every one of its keys lies after every
    local query, so the JAX function gives it zero weight (its scores are
    the f32 minimum and its exp underflows to 0 once the diagonal is in).

Each call returns its rows' log-sum-exp, and the ticks merge by it in f32:
lse = logsumexp_r(lse_r), Y = sum_r exp(lse_r - lse) Y_r.

The backward (`_RingAttention.backward`) runs the kernels' backward per tick
with the merged Y and lse: P = exp(S scale - lse) is then the global
probability of each visited key, and D = rowsum(dY o Y) the global delta,
so each tick's dQ adds into this rank's, and its dK / dV add into
accumulators that travel with the block and reach its owner after the last
tick. On the CPU the same calls run the kernels' plain versions.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from ..ops.attention import fused_attention_backward, fused_attention_forward

_SEQUENCE: contextvars.ContextVar = contextvars.ContextVar("dqvq_sequence_parallel",
                                                           default=None)


@contextlib.contextmanager
def sequence_parallel(world):
    """Inside: the blocks' full-sequence attention is ring attention over
    `world` (the sp group), on each rank's rows."""
    token = _SEQUENCE.set(world)
    try:
        yield world
    finally:
        _SEQUENCE.reset(token)


def active_sequence_world():
    """The sp group of the enclosing `sequence_parallel` scope, or None."""
    return _SEQUENCE.get()


def _merge(parts, b, t, n_head, hd):
    """Y, lse of the ticks' (Y_r, lse_r): Y (B, T, D) f32, lse (B, H, T)."""
    lse = torch.logsumexp(torch.stack([p[1] for p in parts]), dim=0)
    y = 0
    for y_r, lse_r in parts:
        w = torch.exp(lse_r - lse).transpose(1, 2)[..., None]  # (B, T, H, 1)
        y = y + y_r.view(b, t, n_head, hd) * w
    return y.reshape(b, t, n_head * hd), lse


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_head, world, scale):
        dtype = q.dtype
        qf, kf, vf = (z.float().contiguous() for z in (q, k, v))
        b, t, d = qf.shape
        n, i = world.size, world.rank
        parts = []
        k_cur, v_cur = kf, vf
        for r in range(n):
            src = (i - r) % n
            if src <= i:
                parts.append(fused_attention_forward(qf, k_cur, v_cur, n_head, scale,
                                                     causal=src == i, return_lse=True))
            if r + 1 < n:  # the last tick needs no hop
                k_cur, v_cur = world.shift(k_cur), world.shift(v_cur)
        y, lse = _merge(parts, b, t, n_head, d // n_head)
        ctx.save_for_backward(qf, kf, vf, y, lse.contiguous())
        ctx.world, ctx.n_head, ctx.scale, ctx.dtype = world, n_head, scale, dtype
        return y.to(dtype)

    @staticmethod
    def backward(ctx, dy):
        qf, kf, vf, y, lse = ctx.saved_tensors
        world, n_head, scale = ctx.world, ctx.n_head, ctx.scale
        n, i = world.size, world.rank
        dy = dy.float().contiguous()
        dq = torch.zeros_like(qf)
        k_cur, v_cur = kf, vf
        dk_acc, dv_acc = torch.zeros_like(kf), torch.zeros_like(vf)
        for r in range(n):
            src = (i - r) % n
            if src <= i:
                dq_r, dk_r, dv_r = fused_attention_backward(qf, k_cur, v_cur, y, lse, dy, n_head,
                                                            scale, causal=src == i)
                dq += dq_r
                dk_acc += dk_r
                dv_acc += dv_r
            if r + 1 < n:
                k_cur, v_cur = world.shift(k_cur), world.shift(v_cur)
            # the accumulators travel with their block; after the last tick one
            # more hop takes them home (n hops in all)
            dk_acc, dv_acc = world.shift(dk_acc), world.shift(dv_acc)
        dtype = ctx.dtype
        return dq.to(dtype), dk_acc.to(dtype), dv_acc.to(dtype), None, None, None


def ring_attention(q, k, v, n_head: int, world, scale=None):
    """Causal attention over a sequence sharded on `world` (the sp group):
    q, k, v the local (B, T / n, D) rows of this rank, heads carved from D;
    returns the local (B, T / n, D) output in q's dtype, differentiable."""
    if scale is None:
        scale = 1.0 / float(q.shape[2] // n_head) ** 0.5
    return _RingAttention.apply(q, k, v, n_head, world, float(scale))
