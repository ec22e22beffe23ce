"""Pipeline parallelism for the StackGPT training forward (counterpart of
`dynamicvectorquantization_tpu/parallel/stackgpt_pp.py`
`stackgpt_train_losses_pp`).

The deep content stack (18 layers at p6c18) runs through the GPipe schedule
of `parallel/pipeline.py` over the pp group, stage s holding layers
[s L / S, (s + 1) L / S); the embeddings, the position stack, the heads and
the losses are shallow and run dense, the same on every pp rank (they draw
their dropout from the step's elementwise generator, which every pp rank
seeds alike). The parameters stay whole on every rank, as JAX keeps them
replicated over pp.

Gradients: the pipeline sums its input's gradient (which exists on stage 0
only) over the group, so the dense half's gradients are the same on every
rank; a content layer's gradient lives on its own stage, and the trainer
sums the content stack's gradients over the group, so every replica takes
the same update. The blocks' dropouts draw per stage and microbatch (the
stage's generator is seeded from the step's and its pp index; the
attention seed mixes in the microbatch), where JAX folds (layer, tick)
into its key.
"""
from __future__ import annotations

from ..ops.attention import mix_seed
from .pipeline import gpipe_apply
from .stackgpt_sp import rank_generator

_PP = 0x99  # stream tag of the stages' dropout generators


def check_microbatches(batch: int, microbatches: int, dp: int = 1):
    """JAX's conditions on the GLOBAL batch: M divides it, and the dp group
    divides each microbatch."""
    if batch % microbatches:
        raise ValueError(f"batch {batch} must divide pp microbatches ({microbatches})")
    if (batch // microbatches) % dp:
        raise ValueError(f"per-microbatch batch {batch // microbatches} must divide the dp "
                         f"axis ({dp}); raise the batch or lower --pp_microbatches")


def stage_layers(sgpt, world):
    """(first layer index in the content stack, this stage's blocks)."""
    n_layers, n = len(sgpt.content_transformer), world.size
    if n_layers % n:
        raise ValueError(f"{n_layers} layers not divisible by {n} stages")
    per = n_layers // n
    return world.rank * per, list(sgpt.content_transformer)[world.rank * per:
                                                            (world.rank + 1) * per]


def stackgpt_forward_pp(sgpt, world, microbatches, coarse_content, fine_content,
                        coarse_position, fine_position, coarse_seg=None, fine_seg=None,
                        content_target=None, coarse_position_target=None,
                        fine_position_target=None, train=False, generator=None, seed=None):
    """`StackGPT.forward` (same arguments and outputs) with the content stack
    pipelined over the pp group `world` in `microbatches` microbatches of
    this rank's rows."""
    if sgpt.mask_pad_attention:
        raise ValueError("mask_pad_attention is not supported under pp")
    x, shifted = sgpt.embed_training_inputs(
        coarse_content, fine_content, coarse_position, fine_position, coarse_seg, fine_seg,
        train=train, generator=generator)
    position_hidden = sgpt.position_transformer(x, train=train, generator=generator, seed=seed)
    h = position_hidden + shifted
    b = h.shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} must divide pp microbatches ({microbatches})")
    first, blocks = stage_layers(sgpt, world)
    stage_gen = rank_generator(generator, world, _PP)

    def stage_fn(hm, mb):
        for i, block in enumerate(blocks):
            layer = sgpt.position_layer + first + i
            layer_seed = None if seed is None else mix_seed(seed, mb, layer)
            hm = block(hm, train=train, generator=stage_gen, seed=layer_seed)
        return hm

    xs = h.reshape(microbatches, b // microbatches, *h.shape[1:])
    params = [p for blk in blocks for p in blk.parameters()]
    content_hidden = gpipe_apply(stage_fn, xs, world, params).reshape(h.shape)
    position_logits = sgpt.position_head(position_hidden)
    content_logits = sgpt.content_head(content_hidden)
    if content_target is None:
        return {"position_logits": position_logits, "content_logits": content_logits}
    return sgpt.losses_from_logits(position_logits, content_logits, content_target,
                                   coarse_position_target, fine_position_target,
                                   coarse_position.shape[1])
