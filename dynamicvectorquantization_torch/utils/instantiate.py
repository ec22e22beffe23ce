"""Reflection-based instantiation from `{target, params}` config dicts
(counterpart of `dynamicvectorquantization_tpu/utils/instantiate.py`)."""
from __future__ import annotations

import importlib
from typing import Any, Mapping

from ..config.registry import resolve_target


def get_obj_from_str(string: str):
    module, cls = resolve_target(string).rsplit(".", 1)
    return getattr(importlib.import_module(module), cls)


def instantiate_from_config(config: Mapping[str, Any], **extra):
    if config is None:
        return None
    if "target" not in config:
        raise KeyError(f"Expected key `target` to instantiate, got {config!r}")
    params = dict(config.get("params") or {})
    params.update(extra)
    return get_obj_from_str(config["target"])(**params)
