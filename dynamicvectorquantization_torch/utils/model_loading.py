"""Stage-2 model loading (counterpart of
`dynamicvectorquantization_tpu/utils/model_loading.py`).

`model_path`:
  * None -> seeded random init (explicit `torch.Generator`), with the first
    stage loaded from its config `ckpt_path` when that names an existing
    reference torch `.ckpt`;
  * a reference torch `.ckpt`/`.pth`/`.pt` (Lightning `{"state_dict": ...}`
    or a bare state_dict) or a file the port wrote with
    `torch.save(model.state_dict())` — the two share one key layout
    (`transformer.*`, `first_stage_model.*`).
Orbax checkpoints of the JAX package are not read here.
"""
from __future__ import annotations

import os

import torch

from ..config.yaml_config import load_config
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
    if model_path and model_path.endswith(_TORCH_SUFFIXES):
        load_into(model, load_torch_state_dict(model_path))
    elif model_path:
        raise ValueError(f"unsupported checkpoint {model_path!r}: expected a torch "
                         f"{'/'.join(_TORCH_SUFFIXES)} file")
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        model.init_weights(gen)
        fs_path = str(model.first_stage_model.ckpt_path or "")
        if fs_path.endswith(_TORCH_SUFFIXES) and os.path.exists(fs_path):
            load_into(model.first_stage_model, load_torch_state_dict(fs_path))
    model.eval()
    return model, model.state_dict()
