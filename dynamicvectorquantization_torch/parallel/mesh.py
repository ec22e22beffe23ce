"""The tensor-parallel split of the stage-2 transformer (counterpart of
`dynamicvectorquantization_tpu/parallel/mesh.py` `stage2_param_shardings`,
and of `tree_shardings_like` / `zero1_leaf_spec` as the trainer applies them).

The Megatron rule of the JAX package, on the port's parameter names:

  * column-split: `attn.query`, `attn.key`, `attn.value` and the MLP's first
    Linear (`mlp.0`, JAX `mlp_fc`): the output dim over tp, biases too;
  * row-split: `attn.proj` and the MLP's second Linear (`mlp.2`, JAX
    `mlp_proj`): the input dim over tp; their biases stay replicated and
    are added once, after the sum;
  * embeddings, LayerNorms and heads stay replicated;
  * a leaf whose dim tp does not divide stays replicated (the JAX rule).

JAX kernels are (in, out) and `nn.Linear` weights (out, in): the JAX
column split `P(None, "tp")` is dim 0 of the port's weight, the row split
`P("tp", None)` dim 1.

The optimizer state follows: a tp-split leaf's masters and moments are its
rank's shard (they stay tp-split, and ZeRO-1 / FSDP do not cut them
further), while the replicated leaves are the ones ZeRO-1 / FSDP slice over
the dp group (`parallel/shard.py`), as the JAX loop's `_stage2_state_shardings`.
"""
from __future__ import annotations

import torch

_COLUMN = {("attn", "query"), ("attn", "key"), ("attn", "value"), ("mlp", "0")}
_ROW = {("attn", "proj"), ("mlp", "2")}


def tp_split_dims(shapes: dict, tp: int) -> dict:
    """{parameter name: the dim its tp shards cut} for the split leaves of a
    transformer's `{name: shape}`; the leaves left out stay replicated."""
    out = {}
    for name, shape in shapes.items():
        parts = name.split(".")
        if len(parts) < 3:
            continue
        place, leaf = tuple(parts[-3:-1]), parts[-1]
        if place in _COLUMN and leaf in ("weight", "bias") and shape[0] % tp == 0:
            out[name] = 0
        elif place in _ROW and leaf == "weight" and len(shape) == 2 and shape[1] % tp == 0:
            out[name] = 1
    return out


def shard(t: torch.Tensor, dim: int, world) -> torch.Tensor:
    """This rank's contiguous shard of the full tensor `t` along `dim`."""
    n = t.shape[dim] // world.size
    return t.narrow(dim, world.rank * n, n).contiguous()


def gather(t: torch.Tensor, dim: int, world) -> torch.Tensor:
    """The full tensor from every rank's shard `t` along `dim` (a collective)."""
    return world.all_gather(t.movedim(dim, 0).contiguous()).movedim(0, dim).contiguous()


def shard_stage2(transformer, world) -> dict:
    """Cut a StackGPT's blocks into this rank's tensor-parallel shards in
    place (the parameters' data become the shards) and set each block's
    group; returns `tp_split_dims`. Every block's heads must divide over
    the group: a rank runs whole heads."""
    from ..nn.transformer import Block

    tp = world.size
    for mod in transformer.modules():
        if isinstance(mod, Block) and mod.attn.n_head % tp:
            raise ValueError(f"--tp {tp} must divide the attention's {mod.attn.n_head} heads")
    dims = tp_split_dims({k: p.shape for k, p in transformer.named_parameters()}, tp)
    params = dict(transformer.named_parameters())
    with torch.no_grad():
        for name, dim in dims.items():
            params[name].data = shard(params[name].data, dim, world)
    set_tp_group(transformer, world)
    return dims


def set_tp_group(transformer, world):
    """Each block's tensor-parallel group set to `world` (None: the blocks
    compute on whole weights, as on one device)."""
    from ..nn.transformer import Block

    for mod in transformer.modules():
        if isinstance(mod, Block):
            mod.tp = mod.attn.tp = world
