"""JAX-package variables (nested dicts of arrays) -> this package's torch
state_dicts.

The port's modules carry the reference torch parameter names, so these are
the inverses of the JAX package's `convert_stackgpt_state_dict`,
`convert_dqvae_state_dict`, `convert_discriminator_state_dict` and
`convert_lpips_weights` (`utils/torch_ckpt.py`) for the dual-grain DQ-VAE
and its GAN loss, and `stage1_state_from_flax` for a whole stage-1 training
state, written anew here: flax `kernel`s become `weight`s with conv kernels HWIO -> OIHW and
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


def adamw_state_from_optax(opt_state):
    """The optimizer state of the JAX package's stage-2 trainer (the optax
    `adamw` chain, or its `ScaleByAdamState` alone) -> `(count, m, v)` with
    the moments keyed by the port's StackGPT parameter names, for
    `Stage2Trainer.load_optimizer_state`. Read by attribute, so optax is not
    imported."""
    adam = opt_state if hasattr(opt_state, "mu") else opt_state[0]
    return (int(adam.count), stackgpt_state_dict_from_flax(adam.mu),
            stackgpt_state_dict_from_flax(adam.nu))


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
    `post_quant_conv.*`, `quantize.codebook.{weight,cluster_size_ema,embed_ema}`)."""
    sd = _dqvae_params_from_flax(variables.get("params", {}))
    ema = variables.get("ema", {}).get("quantize", {})
    for name, key in (("codebook", "weight"), ("cluster_size_ema", "cluster_size_ema"),
                      ("embed_ema", "embed_ema")):
        if name in ema:
            sd[f"quantize.codebook.{key}"] = _tensor(ema[name])
    return sd


def dualformer_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX Dualformer's `model.init` result `{"transformer": {"params"},
    "first_stage": {"params", "ema"}}` -> the port Dualformer's state_dict
    (`transformer.*`, `first_stage_model.*`), so both training loops can
    start from one state."""
    sd = {f"transformer.{k}": v for k, v in
          stackgpt_state_dict_from_flax(variables["transformer"]["params"]).items()}
    sd.update({f"first_stage_model.{k}": v for k, v in
               dqvae_state_dict_from_flax(variables["first_stage"]).items()})
    return sd


def _dqvae_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """The DQ-VAE's flax `params` tree (or a tree of that shape, such as
    Adam moments) keyed by the port's parameter names."""
    sd = {}
    for path, v in _flatten(params).items():
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
    return sd


def _disc_index(name: str) -> int:
    """JAX discriminator module name -> its index in the reference's `main`
    Sequential: conv, lrelu, then (conv, norm, lrelu) per layer, then conv."""
    kind, n = name.rsplit("_", 1)
    if name == "conv_0":
        return 0
    if kind == "conv":
        return 2 + 3 * (int(n) - 1)
    return 3 + 3 * (int(n) - 1)


def discriminator_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """NLayerDiscriminator flax params (or moments of that shape) ->
    `main.{i}.{weight,bias}`."""
    n_layers = sum(1 for k in params if k.startswith("norm_"))
    sd = {}
    for path, v in _flatten(params).items():
        tleaf, tv = _leaf(path[-1], v)
        index = 2 + 3 * n_layers if path[0] == "conv_out" else _disc_index(path[0])
        sd[f"main.{index}.{tleaf}"] = _tensor(tv)
    return sd


def discriminator_state_dict_from_flax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """Parameters plus the BatchNorm `batch_stats` (`mean`, `var`) as
    `running_mean`, `running_var` (and a zero `num_batches_tracked`)."""
    sd = discriminator_params_from_flax(params)
    for name, stats in batch_stats.items():
        prefix = f"main.{_disc_index(name)}"
        sd[f"{prefix}.running_mean"] = _tensor(stats["mean"])
        sd[f"{prefix}.running_var"] = _tensor(stats["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


# JAX LPIPS conv_i -> torchvision VGG16 `features` index
_VGG_FEATURE_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG_SLICE_ENDS = (4, 9, 16, 23, 30)


def lpips_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """LPIPS flax params (`net.conv_i`, `lin{i}`) -> the port's LPIPS
    state_dict without its two constant `scaling_layer` buffers."""
    sd = {}
    for path, v in _flatten(params).items():
        tleaf, tv = _leaf(path[-1], v)
        if path[0] == "net":
            fi = _VGG_FEATURE_INDEX[int(path[1].split("_")[1])]
            s = next(i for i, end in enumerate(_VGG_SLICE_ENDS) if fi < end) + 1
            sd[f"net.slice{s}.{fi}.{tleaf}"] = _tensor(tv)
        else:
            sd[f"{path[0]}.model.1.{tleaf}"] = _tensor(tv)
    return sd


def adam_state_from_optax(opt_state, convert):
    """The `optax.adam` state of the JAX stage-1 trainer (the chain's state,
    or its `ScaleByAdamState` alone) -> `(count, m, v)` with the moments
    keyed by the port's names through `convert` (`_dqvae_params_from_flax`
    or `discriminator_params_from_flax`). Read by attribute, so optax is not
    imported."""
    adam = opt_state if hasattr(opt_state, "mu") else opt_state[0]
    return int(adam.count), convert(adam.mu), convert(adam.nu)


def stage1_state_from_flax(state) -> dict:
    """A JAX `Stage1State` (read by attribute: `ae_params`, `ema`,
    `loss_params`, `loss_stats`, `ae_opt`, `disc_opt`, `step`, `epoch`) ->
    `{"state_dict", "ae_opt", "disc_opt", "step", "epoch"}`: the state_dict
    of a port `DualGrainVQModel` built with the same GAN lossconfig (loads
    with `strict=True` once the model's own constant LPIPS scaling buffers are
    added, as `load_stage1_state` does) and the two `(count, m, v)` Adam
    states for `Stage1Trainer.load_optimizer_state`."""
    sd = dqvae_state_dict_from_flax({"params": state.ae_params, "ema": state.ema})
    loss_params = state.loss_params
    for k, v in lpips_state_dict_from_flax(loss_params["perceptual_loss"]).items():
        sd[f"loss.perceptual_loss.{k}"] = v
    stats = (state.loss_stats or {}).get("discriminator", {})
    for k, v in discriminator_state_dict_from_flax(loss_params["discriminator"], stats).items():
        sd[f"loss.discriminator.{k}"] = v
    return {"state_dict": sd,
            "ae_opt": adam_state_from_optax(state.ae_opt, _dqvae_params_from_flax),
            "disc_opt": adam_state_from_optax(state.disc_opt, discriminator_params_from_flax),
            "step": int(state.step), "epoch": int(state.epoch)}


def load_stage1_state(trainer, converted: dict):
    """Put a `stage1_state_from_flax` result into a port `Stage1Trainer`."""
    model = trainer.model
    sd = dict(converted["state_dict"])
    for k, v in model.state_dict().items():
        if k.startswith("loss.perceptual_loss.scaling_layer."):
            sd[k] = v
    model.load_state_dict(sd, strict=True)
    trainer.load_optimizer_state(converted["ae_opt"], converted["disc_opt"])
    trainer.step, trainer.epoch = converted["step"], converted["epoch"]
