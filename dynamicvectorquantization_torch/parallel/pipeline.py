"""GPipe pipeline parallelism over a stack of blocks (counterpart of
`dynamicvectorquantization_tpu/parallel/pipeline.py` `gpipe_apply` and
`sequential_apply`).

S stages (the ranks of a pp group) hold contiguous groups of the stack's
layers; M microbatches flow through the M + S - 1 tick schedule: at tick t
stage s runs microbatch t - s (when 0 <= t - s < M) and every stage then
hands its output one stage on (`World.shift`, the JAX function's ring
`ppermute`; what wraps round to stage 0 is not read). The last stage's
outputs are summed over the group with the other stages' zeros, so every
rank returns them, as JAX's `psum` of one-hot copies. A stage skips its
bubble ticks (JAX runs them on zeros and masks them out).

The backward runs the ticks in reverse: at each tick the gradient of a
stage's output comes from the next stage (its input's gradient, one stage
back) or, on the last stage, from the outputs' gradient; each stage
differentiates the graph it kept for that microbatch. The gradient of the
pipeline's input exists on stage 0 only and is summed over the group, so
every rank's replicated producer of it gets the same one. The stage's layer
parameters are the Function's inputs and get their stage's gradients;
another stage's layers get none (the trainer sums them over the group).
"""
from __future__ import annotations

import torch


def sequential_apply(block_fn, layers, x):
    """Ground truth: the blocks one after the other, no pipeline."""
    for layer in layers:
        x = block_fn(layer, x)
    return x


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, stage_fn, world, n_params, *params):
        m, s, n = xs.shape[0], world.rank, world.size
        kept = {}
        carry = torch.zeros_like(xs[0])
        ys = torch.zeros_like(xs)
        for t in range(m + n - 1):
            mb = t - s
            out = torch.zeros_like(xs[0])
            if 0 <= mb < m:
                h_in = (xs[mb] if s == 0 else carry).detach().requires_grad_(True)
                with torch.enable_grad():
                    h_out = stage_fn(h_in, mb)
                kept[mb] = (h_in, h_out)
                out = h_out.detach()
                if s == n - 1:
                    ys[mb] = out
            carry = world.shift(out)
        ctx.kept, ctx.world, ctx.params, ctx.m = kept, world, params, m
        return world.sum_(ys)

    @staticmethod
    def backward(ctx, dys):
        world, params, m, kept = ctx.world, ctx.params, ctx.m, ctx.kept
        s, n = world.rank, world.size
        grads = [torch.zeros_like(p) for p in params]
        dxs = torch.zeros_like(dys)
        send = torch.zeros_like(dys[0])
        for t in reversed(range(m + n - 1)):
            # the gradient of this tick's output: the next stage's input
            # gradient of tick t + 1, one stage back
            recv = world.shift(send, -1)
            mb = t - s
            send = torch.zeros_like(dys[0])
            if 0 <= mb < m:
                h_in, h_out = kept.pop(mb)
                g_out = dys[mb] if s == n - 1 else recv
                got = torch.autograd.grad(h_out, (h_in,) + tuple(params), g_out,
                                          allow_unused=True)
                send = got[0]
                for acc, g in zip(grads, got[1:]):
                    if g is not None:
                        acc += g
                if s == 0:
                    dxs[mb] = send
        world.sum_(dxs)  # stage 0's input gradient to every stage
        return (dxs, None, None, None) + tuple(grads)


def gpipe_apply(stage_fn, xs, world, params=()):
    """Run the M microbatches `xs` (M, mb, ...) through the stages of the pp
    group `world`: `stage_fn(h, microbatch)` applies this rank's layer group
    to one microbatch, `params` are that group's parameters. Returns (M,
    mb, ...) outputs, the same on every rank; differentiable with respect to
    `xs` and `params`."""
    params = tuple(params)
    return _GPipe.apply(xs, stage_fn, world, len(params), *params)
