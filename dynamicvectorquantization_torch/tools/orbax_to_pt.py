"""Convert a checkpoint of the JAX package's training loop (Orbax, a step
directory `checkpoints/<step>/` or the `checkpoints/` root, whose newest
step is read) into this package's trainer checkpoint, so the port's loop
resumes it (`--resume`) and `utils.model_loading` loads it:

  python -m dynamicvectorquantization_torch.tools.orbax_to_pt <orbax dir> --out <run dir>
      [--first_stage <stage-1 Orbax dir | torch file>] [--seed 23]

It writes `<run dir>/checkpoints/step_<step>.pt` in `utils/checkpoint.py`'s
layout. A stage-2 state (`Stage2State`: params, AdamW state, step, epoch)
becomes the f32 masters, both moments, the count and the epoch, keyed by
the port's StackGPT names (`utils.weights.stackgpt_state_dict_from_flax`),
with the trainer's dropout seed `--seed + 1` (what the port's loop gives
its stage-2 trainer) and the frozen first stage, which the JAX state does
not hold: `--first_stage` names a stage-1 Orbax checkpoint (its parameters
and EMA codebook) or a torch file of the port or of the reference. A
stage-1 state (`Stage1State`) becomes the model's state_dict (autoencoder,
EMA codebook, LPIPS, discriminator and its BatchNorm statistics), both Adam
states, the step and the epoch (`utils.weights.stage1_state_from_flax`).

The checkpoint is read without Orbax, which would load JAX: its
`_METADATA` (JSON) names every leaf, and the arrays are zarr arrays in an
OCDBT store (Orbax's default layout, which the JAX loop writes) that
`tensorstore` reads. `tensorstore` is imported only when a checkpoint is read
(`restore_tree`), never at module load; it is installed beside Orbax, so
this runs where the JAX run's checkpoints are (the card's machine has
neither). The file it writes is plain torch.
"""
from __future__ import annotations

import argparse
import json
import os
from types import SimpleNamespace
from urllib.parse import quote

import numpy as np
import torch

from ..utils.checkpoint import CheckpointManager
from ..utils.weights import (adamw_state_from_optax, dqvae_state_dict_from_flax,
                             stackgpt_state_dict_from_flax, stage1_state_from_flax)


def step_directory(path: str) -> str:
    """The Orbax item directory of a step directory or of the newest step of
    a `checkpoints/` root (the JAX package's `load_first_stage_variables`
    rule)."""
    path = os.path.abspath(path)
    if os.path.isdir(path) and not os.path.exists(os.path.join(path, "_METADATA")):
        steps = sorted((d for d in os.listdir(path) if d.isdigit()), key=int)
        if steps:
            path = os.path.join(path, steps[-1])
        if os.path.exists(os.path.join(path, "default", "_METADATA")):
            path = os.path.join(path, "default")
    if not os.path.exists(os.path.join(path, "_METADATA")):
        raise FileNotFoundError(f"no Orbax checkpoint at {path!r}")
    return path


# leaves that Orbax records in `_METADATA` alone, with no array behind them
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list}
_SEQUENCE_KEY = 1  # Orbax's key_type of a list / tuple index (2: a dict key)


def restore_tree(path: str):
    """The raw tree of an Orbax checkpoint, as Orbax's `StandardCheckpointer`
    restores it without a target: nested dicts and lists of numpy arrays (a
    NamedTuple state comes back as a dict of its fields)."""
    import tensorstore as ts

    path = step_directory(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(f"{path!r}: only Orbax's default layout (zarr arrays in an OCDBT "
                         "store), which the JAX loop writes, is read")
    store = f"file://{quote(path)}/|ocdbt:"
    root = {}
    for leaf in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in leaf["key_metadata"]]
        kind = leaf["value_metadata"]["value_type"]
        if kind in _EMPTY:
            value = _EMPTY[kind]()
        elif leaf["value_metadata"].get("skip_deserialize"):
            raise ValueError(f"leaf {keys} of type {kind!r} holds no array")
        else:
            url = f"{store}{quote('.'.join(k for k, _ in keys))}/|zarr2:"
            value = np.asarray(ts.open(url, open=True, read=True).result().read().result())
        node = root
        for (key, _), (_, child_type) in zip(keys, keys[1:]):
            node = node.setdefault((key, child_type == _SEQUENCE_KEY), {})
        node[keys[-1][0]] = value
    return _nested(root)


def _nested(node):
    """`{(key, is_sequence): child}` -> dicts, and lists ordered by index."""
    if not isinstance(node, dict):
        return node
    out = {}
    for key, child in node.items():
        if isinstance(key, tuple):
            key, is_sequence = key
            child = _nested(child)
            if is_sequence:
                child = [child[i] for i in sorted(child, key=int)]
        out[key] = child
    return out


def _adam(tree):
    """The optax Adam state (`count`, `mu`, `nu`) inside a restored
    optimizer state, as an object read by attribute."""
    if isinstance(tree, dict) and "mu" in tree and "nu" in tree:
        return SimpleNamespace(**tree)
    for node in tree.values() if isinstance(tree, dict) else tree or ():
        if isinstance(node, (dict, list)):
            found = _adam(node)
            if found is not None:
                return found
    return None


def _first_stage(path: str) -> dict:
    """The first stage's state_dict from a stage-1 Orbax checkpoint or a torch
    file (the port's or the reference's)."""
    from ..utils.model_loading import first_stage_state_dict, is_orbax

    if is_orbax(path):
        tree = restore_tree(path)
        if "ae_params" not in tree:
            raise ValueError(f"{path!r} is not a stage-1 checkpoint")
        return dqvae_state_dict_from_flax({"params": tree["ae_params"], "ema": tree["ema"]})
    return first_stage_state_dict(path)


def convert(tree, first_stage=None, seed: int = 23) -> dict:
    """A restored JAX training state -> the port's checkpoint content
    (`{"stage", "trainer", ...}`)."""
    if "ae_params" in tree:
        c = stage1_state_from_flax(SimpleNamespace(**{
            **tree, "ae_opt": _adam(tree["ae_opt"]), "disc_opt": _adam(tree["disc_opt"])}))
        from ..nn.lpips import _ScalingLayer  # constants the JAX tree does not hold

        model = dict(c["state_dict"])
        for k, v in _ScalingLayer().state_dict().items():
            model[f"loss.perceptual_loss.scaling_layer.{k}"] = v
        opt = {name: dict(zip(("count", "m", "v"), c[name])) for name in ("ae_opt", "disc_opt")}
        return {"stage": 1, "trainer": {"model": model, **opt, "step": c["step"],
                                        "epoch": c["epoch"]}}
    if "params" not in tree or "opt" not in tree:
        raise ValueError("not a training state of the JAX loop (neither Stage1State nor "
                         "Stage2State)")
    if first_stage is None:
        raise ValueError("a stage-2 state holds no first stage: pass --first_stage")
    count, m, v = adamw_state_from_optax(_adam(tree["opt"]))
    if count != int(tree["step"]):
        raise ValueError(f"AdamW count {count} differs from the step {int(tree['step'])}")
    return {"stage": 2,
            "trainer": {"masters": stackgpt_state_dict_from_flax(tree["params"]), "m": m, "v": v,
                        "count": count, "epoch": int(tree["epoch"]), "seed": int(seed) + 1},
            "first_stage": {k: torch.as_tensor(t) for k, t in first_stage.items()}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("orbax", help="a step directory or the checkpoints/ root of a JAX run")
    p.add_argument("--out", required=True, help="the port run's logdir to write into")
    p.add_argument("--first_stage", default=None,
                   help="stage 2: a stage-1 Orbax checkpoint or a torch file")
    p.add_argument("--seed", type=int, default=23, help="the port loop's --seed")
    opt = p.parse_args(argv)
    tree = restore_tree(opt.orbax)
    fs = _first_stage(opt.first_stage) if opt.first_stage else None
    state = convert(tree, fs, opt.seed)
    step = int(tree["step"])
    mngr = CheckpointManager(os.path.join(opt.out, "checkpoints"), save_top_k=1)
    mngr.save(step, state)
    mngr.wait()
    print(mngr.path(step))
    return mngr.path(step)


if __name__ == "__main__":
    main()
