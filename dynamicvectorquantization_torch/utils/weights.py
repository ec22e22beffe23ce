"""JAX-package variables (nested dicts of arrays) -> this package's torch
state_dicts.

The port's modules carry the reference torch parameter names, so these are
the inverses of the JAX package's `convert_stackgpt_state_dict` and of its
`export_dqvae_state_dict` (`utils/torch_ckpt.py`) for the dual-grain DQ-VAE,
written anew here: flax `kernel`s become `weight`s with conv kernels HWIO -> OIHW and
dense kernels (in, out) -> (out, in); `scale` -> `weight`; `embedding` ->
`weight`; flax's `GroupNorm_0` wrapper level disappears.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _leaf(name: str, value: np.ndarray):
    """flax leaf -> (torch leaf name, array in torch layout)."""
    if name == "kernel":
        if value.ndim == 4:
            return "weight", np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
        return "weight", np.transpose(value, (1, 0))  # (in, out) -> (out, in)
    if name in ("scale", "embedding"):
        return "weight", value
    return name, value


def _tensor(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable contiguous copy


def stackgpt_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """StackGPT flax params (or `{"params": ...}`) -> the port's StackGPT
    state_dict (no `transformer.` prefix)."""
    params = params.get("params", params)
    sd = {}
    for path, v in _flatten(params).items():
        root = path[0]
        if root == "pos_emb":
            sd["pos_emb"] = _tensor(v)
            continue
        tleaf, tv = _leaf(path[-1], v)
        if root in ("content_emb", "content_coarse_pos_emb", "content_fine_pos_emb", "seg_emb"):
            key = f"{root}.{tleaf}"
        elif root in ("position_transformer", "content_transformer"):
            i = re.fullmatch(r"h_(\d+)", path[1]).group(1)
            mod = path[2]
            if mod in ("ln1", "ln2"):
                key = f"{root}.{i}.{mod}.{tleaf}"
            elif mod == "attn":
                key = f"{root}.{i}.attn.{path[3]}.{tleaf}"
            elif mod in ("mlp_fc", "mlp_proj"):
                key = f"{root}.{i}.mlp.{0 if mod == 'mlp_fc' else 2}.{tleaf}"
            else:
                raise KeyError(f"unmapped StackGPT param {'/'.join(path)}")
        elif root in ("position_head_ln", "content_head_ln"):
            key = f"{root[:-3]}.0.{tleaf}"
        elif root in ("position_head", "content_head"):
            key = f"{root}.1.{tleaf}"
        else:
            raise KeyError(f"unmapped StackGPT param {'/'.join(path)}")
        sd[key] = _tensor(tv)
    return sd


_MID = {"mid_block_1": "block_1", "mid_attn_1": "attn_1", "mid_block_2": "block_2"}


def _encoder_key(mods, tleaf, path) -> str:
    sub = mods[1]
    if sub == "down" and mods[2] == "conv_in":
        return f"encoder.conv_in.{tleaf}"
    if sub == "down":
        m = re.fullmatch(r"down_(\d+)_(block|attn|downsample)(?:_(\d+))?", mods[2])
        if m is None:
            raise KeyError(f"unmapped encoder param {'/'.join(path)}")
        i, kind, j = m.groups()
        rest = [*mods[3:], tleaf]
        if kind == "downsample":
            return ".".join([f"encoder.down.{i}.downsample", *rest])
        return ".".join([f"encoder.down.{i}.{kind}.{j}", *rest])
    if sub in ("head_coarse", "head_fine"):
        grain = sub.split("_")[1]
        inner = mods[2]
        if inner in _MID:
            return ".".join([f"encoder.mid_{grain}.{_MID[inner]}", *mods[3:], tleaf])
        if inner in ("norm_out", "conv_out"):
            return f"encoder.{inner}_{grain}.{tleaf}"
    if sub == "router":
        name = mods[2]
        if name in ("gate_0", "gate_2"):
            return f"encoder.router.gate.{name[-1]}.{tleaf}"
        return f"encoder.router.{name}.{tleaf}"  # gate, feature_norm_{fine,coarse}
    raise KeyError(f"unmapped encoder param {'/'.join(path)}")


def dqvae_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """DQ-VAE flax variables `{"params", "ema"}` -> the port's
    DualGrainVQModel state_dict (`encoder.*`, `quant_conv.*`, `decoder.*`,
    `post_quant_conv.*`, `quantize.codebook.weight`)."""
    sd = {}
    for path, v in _flatten(variables.get("params", {})).items():
        mods = [m for m in path[:-1] if m != "GroupNorm_0"]
        tleaf, tv = _leaf(path[-1], v)
        root = mods[0]
        if root in ("quant_conv", "post_quant_conv"):
            key = f"{root}.{tleaf}"
        elif root == "encoder":
            key = _encoder_key(mods, tleaf, path)
        elif root == "decoder":
            sub = mods[1]
            if sub in ("conv_in", "conv_out", "norm_out"):
                key = f"decoder.{sub}.{tleaf}"
            elif sub in _MID:
                key = ".".join(["decoder.mid", _MID[sub], *mods[2:], tleaf])
            elif sub == "position_bias_fourier":
                key = f"decoder.position_bias_fourier.lff.ffm.conv.{tleaf}"
            elif sub == "position_bias_learned":
                key = f"decoder.position_bias_learned.{mods[2]}.{tleaf}"
            else:
                m = re.fullmatch(r"up_(\d+)_(block|attn|upsample)(?:_(\d+))?", sub)
                if m is None:
                    raise KeyError(f"unmapped decoder param {'/'.join(path)}")
                i, kind, j = m.groups()
                rest = [*mods[2:], tleaf]
                if kind == "upsample":
                    key = ".".join([f"decoder.up.{i}.upsample", *rest])
                else:
                    key = ".".join([f"decoder.up.{i}.{kind}.{j}", *rest])
        else:
            raise KeyError(f"unmapped DQ-VAE param {'/'.join(path)}")
        sd[key] = _tensor(tv)
    codebook = variables.get("ema", {}).get("quantize", {}).get("codebook")
    if codebook is not None:
        sd["quantize.codebook.weight"] = _tensor(codebook)
    return sd
