"""Sequence parallelism for the StackGPT training forward (counterpart of
`dynamicvectorquantization_tpu/parallel/stackgpt_sp.py`
`stackgpt_train_losses_sp`).

`StackGPT.embed_training_inputs` runs on the whole sequence, the same on
every sp rank (its lookups need global positions; its dropout draws once,
from the step's elementwise generator, which every sp rank seeds alike).
Each rank then takes its contiguous T / sp rows into
`forward_from_embeddings`, whose attention is ring attention over the sp
group (`parallel/ring_attention.py`). The block dropouts draw per sp rank,
as JAX folds the sp index into the blocks' key: the rank's generator is
seeded from the step's and its sp index.

The losses are JAX's `losses_from_logits` over the whole sequence: the
logits are gathered over the group (the coarse / fine split at
`coarse_length` falls inside some rank's rows), so every rank computes the
same losses, and the gather's backward hands each rank its rows' gradient.
A parameter's gradient on one rank is then its rows' share, and the trainer
sums it over the sp group. A sequence the group does not divide raises, as
in JAX: at p6c18 T = 805 = 5 * 7 * 23, so `--sp 2` on the shipped config
raises in both packages.
"""
from __future__ import annotations

import torch

from ..ops.attention import mix_seed
from .dist import gather_dim
from .ring_attention import sequence_parallel

_SP = 0x5E9  # stream tag of the blocks' per-rank dropout generator


def require_divisible(t: int, n: int):
    if t % n:
        raise ValueError(f"sequence length {t} must divide the sp axis ({n}); pad the "
                         "permuter capacities accordingly")


def rank_generator(generator, world, tag):
    """A generator of this rank's own stream, seeded from `generator`'s
    seed and the rank (None stays None)."""
    if generator is None:
        return None
    seed = mix_seed(generator.initial_seed(), world.rank, tag)
    return torch.Generator(device=generator.device).manual_seed(seed >> 1)


def stackgpt_forward_sp(sgpt, world, coarse_content, fine_content, coarse_position,
                        fine_position, coarse_seg=None, fine_seg=None, content_target=None,
                        coarse_position_target=None, fine_position_target=None, train=False,
                        generator=None, seed=None):
    """`StackGPT.forward` (same arguments and outputs) with the block stacks
    sequence-sharded over the sp group `world`."""
    if sgpt.mask_pad_attention:
        raise ValueError("mask_pad_attention is not supported under sp")
    x, shifted = sgpt.embed_training_inputs(
        coarse_content, fine_content, coarse_position, fine_position, coarse_seg, fine_seg,
        train=train, generator=generator)
    t, n = x.shape[1], world.size
    require_divisible(t, n)
    rows = slice(world.rank * t // n, (world.rank + 1) * t // n)
    if isinstance(seed, int):
        seed = mix_seed(seed, world.rank)
    with sequence_parallel(world):
        out = sgpt.forward_from_embeddings(
            x[:, rows].contiguous(), shifted[:, rows].contiguous(), train=train,
            generator=rank_generator(generator, world, _SP), seed=seed)
    position_logits = gather_dim(out["position_logits"], world, 1)
    content_logits = gather_dim(out["content_logits"], world, 1)
    if content_target is None:
        return {"position_logits": position_logits, "content_logits": content_logits}
    return sgpt.losses_from_logits(position_logits, content_logits, content_target,
                                   coarse_position_target, fine_position_target,
                                   coarse_position.shape[1])
