"""Model loading (counterpart of
`dynamicvectorquantization_tpu/utils/model_loading.py`): the stage-2 model
(`load_model_and_variables`) and, for evaluation, a stage-1 config's DQ-VAE
(`load_first_stage_model`).

`model_path`:
  * None -> seeded random init (explicit `torch.Generator`), with the first
    stage loaded from its config `ckpt_path` where that is set;
  * a reference torch `.ckpt`/`.pth`/`.pt` (Lightning `{"state_dict": ...}`
    or a bare state_dict) or a file the port wrote with
    `torch.save(model.state_dict())` — the two share one key layout
    (`transformer.*`, `first_stage_model.*`);
  * a checkpoint of the port's trainer (`train/loop.py`): one
    `checkpoints/step_<n>.pt` file, or the `checkpoints/` directory itself
    (or the run's logdir holding it), whose newest step is read. Its f32
    masters are the transformer, its `first_stage` the first stage.

A first-stage `ckpt_path` resolves through `load_first_stage`, the one
resolver the training loop uses too: a torch file, or a stage-1 run's
`checkpoints/` directory (newest step). A `ckpt_path` that exists but cannot
be read raises; it never leaves seeded first-stage weights in silence (the
JAX package's r04 bug, `utils/model_loading.py:21-23` there). Orbax
checkpoints of the JAX package (which its loader reads) are not read here:
one given raises, naming the converter `tools/orbax_to_pt.py`, whose output
loads.
"""
from __future__ import annotations

import os

import torch

from ..config.yaml_config import load_config
from .checkpoint import CheckpointManager
from .device import resolve_device
from .instantiate import instantiate_from_config

_TORCH_SUFFIXES = (".ckpt", ".pth", ".pt")


def load_torch_state_dict(path: str) -> dict:
    # Lightning checkpoints pickle more than tensors: load trusted files only
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def load_into(module: torch.nn.Module, sd: dict, prefix: str = ""):
    """Load the entries of `sd` under `prefix` into `module`. Every key the
    module owns must be present; keys it does not own (the encode half, the
    GAN loss, EMA statistics) are ignored."""
    own = module.state_dict()
    picked = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix) and k[len(prefix):] in own}
    missing = sorted(set(own) - set(picked))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. {missing[:5]}")
    module.load_state_dict(picked, strict=True)


def is_orbax(path: str) -> bool:
    """Whether `path` is an Orbax checkpoint of the JAX loop: a step directory
    (`_METADATA`, or its `default/` item) or a root of numbered steps."""
    if not os.path.isdir(path):
        return False
    if any(os.path.exists(os.path.join(path, *p, "_METADATA")) for p in ((), ("default",))):
        return True
    steps = [d for d in os.listdir(path) if d.isdigit()]
    return bool(steps) and is_orbax(os.path.join(path, max(steps, key=int)))


def refuse_orbax(path: str):
    if is_orbax(path):
        raise ValueError(
            f"{path!r} is an Orbax checkpoint of the JAX package, which this package does not "
            "read: convert it with `python -m dynamicvectorquantization_torch.tools.orbax_to_pt "
            f"{path} --out <run dir>` and pass the run dir")


def _checkpoint_dir(path: str):
    """The `checkpoints/` directory a path names (itself, or the one inside a
    run's logdir), or None."""
    for d in (path, os.path.join(path, "checkpoints")):
        if os.path.isdir(d) and CheckpointManager(d).latest() is not None:
            return d
    return None


def _trainer_state(path: str):
    """The content of a trainer checkpoint (a `step_<n>.pt` file, or the
    newest step of a `checkpoints/` directory), or None if `path` is a plain
    torch weights file."""
    if os.path.isdir(path):
        d = _checkpoint_dir(path)
        if d is None:
            raise FileNotFoundError(f"no trainer checkpoint under {path!r}")
        return CheckpointManager(d).restore()
    state = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "stage" in state and "trainer" in state:
        return state
    return None


def first_stage_state_dict(path: str) -> dict:
    """The first stage's weights from a reference torch file, a stage-1
    trainer checkpoint (file or directory: its model) or a stage-2 one (its
    frozen first stage)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"first-stage checkpoint {path!r} does not exist")
    refuse_orbax(path)
    state = _trainer_state(path)
    if state is None:
        return load_torch_state_dict(path)
    return state["trainer"]["model"] if state["stage"] == 1 else state["first_stage"]


def load_first_stage(fs_model, path: str):
    """Stage-1 weights for a frozen first stage from its config `ckpt_path`:
    a reference torch `.ckpt` / `.pth` / `.pt`, or the `checkpoints/`
    directory of a stage-1 run of this package (its newest step): the stage-1
    -> stage-2 handoff. Raises where `path` cannot be read."""
    load_into(fs_model, first_stage_state_dict(path))


DUMMY_LOSS = {"target": "modules.losses.vqperceptual.DummyLoss"}


def load_first_stage_model(yaml_path, model_path=None, device=None):
    """A stage-1 config's DQ-VAE for evaluation, on `device` (CUDA unless
    the caller passes another device), in eval mode: its GAN loss replaced by
    the `DummyLoss` placeholder (evaluation needs none), its weights from
    `model_path` through `load_first_stage` (a reference torch file or a
    stage-1 run's checkpoints) or, without one, seeded (seed 0, as the JAX
    scripts' `PRNGKey(0)`)."""
    device = resolve_device(device)
    config = load_config([yaml_path])["model"]
    config = {**config, "params": {**config["params"], "lossconfig": DUMMY_LOSS}}
    with torch.device(device):
        model = instantiate_from_config(config)
    if model_path:
        load_first_stage(model, model_path)
    else:
        model.init_weights(torch.Generator(device=device).manual_seed(0))
    return model.eval()


def stage2_state_dict(path: str) -> dict:
    """The whole Dualformer's weights (`transformer.*`,
    `first_stage_model.*`) from a torch file or a stage-2 trainer checkpoint
    (file or directory: the f32 masters and the frozen first stage)."""
    state = _trainer_state(path)
    if state is None:
        return load_torch_state_dict(path)
    if state["stage"] != 2:
        raise ValueError(f"{path!r} is a stage-{state['stage']} checkpoint, not a stage-2 one")
    return {**{f"transformer.{k}": v for k, v in state["trainer"]["masters"].items()},
            **{f"first_stage_model.{k}": v for k, v in state["first_stage"].items()}}


def load_model_and_variables(yaml_path, model_path=None, seed=0, kv_cache_dtype=None,
                             device=None):
    """Returns (model, state_dict): the Dualformer on `device` (CUDA unless
    the caller passes another device) and its state_dict, the port's
    counterpart of the JAX package's variables."""
    device = resolve_device(device)
    config = load_config([yaml_path])
    if kv_cache_dtype:
        config["model"]["params"]["transformer_config"]["params"]["kv_cache_dtype"] = \
            kv_cache_dtype
    with torch.device(device):
        model = instantiate_from_config(config["model"])
    if model_path:
        if not os.path.exists(model_path):
            raise FileNotFoundError(f"checkpoint {model_path!r} does not exist")
        refuse_orbax(model_path)
        if not (os.path.isdir(model_path) or model_path.endswith(_TORCH_SUFFIXES)):
            raise ValueError(f"unsupported checkpoint {model_path!r}: expected a torch "
                             f"{'/'.join(_TORCH_SUFFIXES)} file or a trainer's checkpoints/ "
                             "directory")
        load_into(model, stage2_state_dict(model_path))
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        model.init_weights(gen)
        # as the JAX package: a ckpt_path that does not exist (the shipped
        # configs hold a placeholder) leaves the seeded weights; one that
        # exists is loaded or raises
        fs_path = str(model.first_stage_model.ckpt_path or "")
        if fs_path and os.path.exists(fs_path):
            load_first_stage(model.first_stage_model, fs_path)
    model.eval()
    return model, model.state_dict()
