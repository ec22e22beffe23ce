"""JAX-package variables (nested dicts of arrays) -> this package's torch
state_dicts.

The port's modules carry the reference torch parameter names, so these are
the inverses of the JAX package's `convert_stackgpt_state_dict` (with the
text-to-image cross-attention's `xattn`, `ln_x` and `text_proj`),
`convert_dqvae_state_dict`, `convert_discriminator_state_dict` and
`convert_lpips_weights` (`utils/torch_ckpt.py`) for the dual- and
triple-grain DQ-VAEs (every router's `gate`, `gate_0` / `gate_2` and
`feature_norm_{fine,median,coarse}`) and their GAN loss, and
`stage1_state_from_flax` for a whole stage-1 training state, written anew
here; `vqgan_state_dict_from_flax` for the fixed-length baselines and the
two StyleGAN discriminators' converters (the inverses of
`convert_stylegan2_disc_state_dict` / `convert_lucidrains_disc_state_dict`):
flax `kernel`s become `weight`s with conv kernels HWIO -> OIHW and dense
kernels (in, out) -> (out, in); `scale` -> `weight`; `embedding` ->
`weight`; flax's `GroupNorm_0` wrapper level disappears. The CLIP text
tower has two: `clip_text_state_dict_from_flax` (the JAX tower's params)
and `clip_text_state_dict_from_openai`, the port's copy of the JAX
package's `convert_clip_text_state_dict` (an OpenAI CLIP file, read from
`DQVQ_CLIP_WEIGHTS`).
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
        if root in ("content_emb", "content_coarse_pos_emb", "content_fine_pos_emb", "seg_emb",
                    "text_proj"):
            key = f"{root}.{tleaf}"
        elif root in ("position_transformer", "content_transformer"):
            i = re.fullmatch(r"h_(\d+)", path[1]).group(1)
            mod = path[2]
            if mod in ("ln1", "ln2", "ln_x"):
                key = f"{root}.{i}.{mod}.{tleaf}"
            elif mod in ("attn", "xattn"):
                key = f"{root}.{i}.{mod}.{path[3]}.{tleaf}"
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


def clip_text_state_dict_from_openai(sd, prefix: str = "", layers=None) -> Dict[str, torch.Tensor]:
    """An OpenAI CLIP state_dict (or the reference `CLIPTextEmbedding`'s,
    under `prefix`) -> the port's `nn.clip_text.CLIPTextTransformer`
    state_dict: the text tower's entries, the visual tower and `logit_scale`
    dropped, every value an f32 tensor (the port's copy of the JAX package's
    `convert_clip_text_state_dict`, whose tree keeps these names). A block
    index at or past `layers`, or an entry of no known name, raises."""
    top = {"token_embedding.weight", "positional_embedding", "text_projection",
           "ln_final.weight", "ln_final.bias"}
    inner = {"attn.in_proj_weight", "attn.in_proj_bias", "attn.out_proj.weight",
             "attn.out_proj.bias", "ln_1.weight", "ln_1.bias", "ln_2.weight", "ln_2.bias",
             "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias"}
    out = {}
    for key, v in sd.items():
        if not key.startswith(prefix):
            continue
        k = key[len(prefix):]
        if k.startswith("visual.") or k == "logit_scale":
            continue
        m = re.fullmatch(r"transformer\.resblocks\.(\d+)\.(.+)", k)
        if m is not None:
            if layers is not None and int(m.group(1)) >= layers:
                raise KeyError(f"resblock {m.group(1)} beyond configured {layers} layers")
            if m.group(2) not in inner:
                raise KeyError(f"unmapped clip key {key}")
        elif k not in top:
            raise KeyError(f"unmapped clip key {key}")
        out[k] = _tensor(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
    return out


def clip_text_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX `CLIPTextTransformer`'s params (or `{"params": ...}`) -> the
    port's state_dict (OpenAI names)."""
    params = params.get("params", params)
    sd = {}
    for path, v in _flatten(params).items():
        root = path[0]
        if root in ("positional_embedding", "text_projection"):
            sd[root] = _tensor(v)
            continue
        tleaf, tv = _leaf(path[-1], v)
        if root == "token_embedding":
            key = "token_embedding.weight"
        elif root == "ln_final":
            key = f"ln_final.{tleaf}"
        elif root.startswith("resblock_"):
            i, mod = root[len("resblock_"):], path[1]
            if mod == "in_proj":
                key = f"transformer.resblocks.{i}.attn.in_proj_{tleaf}"
            elif mod == "out_proj":
                key = f"transformer.resblocks.{i}.attn.out_proj.{tleaf}"
            elif mod in ("c_fc", "c_proj"):
                key = f"transformer.resblocks.{i}.mlp.{mod}.{tleaf}"
            elif mod in ("ln_1", "ln_2"):
                key = f"transformer.resblocks.{i}.{mod}.{tleaf}"
            else:
                raise KeyError(f"unmapped CLIP param {'/'.join(path)}")
        else:
            raise KeyError(f"unmapped CLIP param {'/'.join(path)}")
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
    if sub in ("head_coarse", "head_median", "head_fine"):
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
        return f"encoder.router.{name}.{tleaf}"  # gate, feature_norm_{fine,median,coarse}
    raise KeyError(f"unmapped encoder param {'/'.join(path)}")


def dqvae_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """DQ-VAE flax variables `{"params", "ema"}` -> the port's
    DualGrainVQModel / TripleGrainVQModel state_dict (`encoder.*`,
    `quant_conv.*`, `decoder.*`, `post_quant_conv.*`,
    `quantize.codebook.{weight,cluster_size_ema,embed_ema}`)."""
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


def _is_actnorm(leaves) -> bool:
    return "loc" in leaves


def discriminator_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """NLayerDiscriminator flax params (or moments of that shape) ->
    `main.{i}.{weight,bias}`, and an ActNorm's (C,) `loc` / `scale` as
    (1, C, 1, 1) `main.{i}.{loc,scale}`."""
    n_layers = sum(1 for k in params if k.startswith("norm_"))
    sd = {}
    for path, v in _flatten(params).items():
        index = 2 + 3 * n_layers if path[0] == "conv_out" else _disc_index(path[0])
        if _is_actnorm(params[path[0]]):
            sd[f"main.{index}.{path[-1]}"] = _tensor(v).reshape(1, -1, 1, 1)
            continue
        tleaf, tv = _leaf(path[-1], v)
        sd[f"main.{index}.{tleaf}"] = _tensor(tv)
    return sd


def discriminator_params_to_flax(sd) -> dict:
    """The inverse of `discriminator_params_from_flax`: a port
    NLayerDiscriminator's `main.{i}.*` parameters (buffers are skipped) ->
    its flax params tree, ActNorm's `loc` / `scale` as (C,)."""
    n_layers = sum(1 for k in sd if k.endswith((".running_mean", ".loc")))
    names = {0: "conv_0", 2 + 3 * n_layers: "conv_out"}
    for n in range(1, n_layers + 1):
        names[2 + 3 * (n - 1)], names[3 + 3 * (n - 1)] = f"conv_{n}", f"norm_{n}"
    out: dict = {}
    for key, v in sd.items():
        _, index, leaf = key.split(".")
        name, a = names[int(index)], np.asarray(v)
        if leaf in ("running_mean", "running_var", "num_batches_tracked", "initialized"):
            continue
        if leaf in ("loc", "scale"):
            out.setdefault(name, {})[leaf] = a.reshape(-1)
        elif name.startswith("conv") and leaf == "weight":
            out.setdefault(name, {})["kernel"] = np.transpose(a, (2, 3, 1, 0))  # OIHW -> HWIO
        else:
            out.setdefault(name, {})["scale" if leaf == "weight" else leaf] = a
    return out


def discriminator_state_dict_from_flax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """Parameters plus the BatchNorm `batch_stats` (`mean`, `var`) as
    `running_mean`, `running_var` (and a zero `num_batches_tracked`); an
    ActNorm, set from data when the JAX module was initialised, with its
    `initialized` flag 1."""
    sd = discriminator_params_from_flax(params)
    for name, leaves in params.items():
        if _is_actnorm(leaves):
            sd[f"main.{_disc_index(name)}.initialized"] = torch.ones((), dtype=torch.uint8)
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


_TOWER = re.compile(r"(down|up)_(\d+)_(block|attn|downsample|upsample)(?:_(\d+))?")
# flax EMA / parameter leaves of the quantizers -> the port's buffer names
_EMA_LEAF = {"codebook": "codebook.weight", "cluster_size_ema": "codebook.cluster_size_ema",
             "embed_ema": "codebook.embed_ema"}


def _vqgan_tower_key(tower, mods, tleaf, path) -> str:
    sub = mods[0]
    if sub in ("conv_in", "conv_out", "norm_out"):
        return f"{tower}.{sub}.{tleaf}"
    if sub in _MID:
        return ".".join([f"{tower}.mid", _MID[sub], *mods[1:], tleaf])
    m = _TOWER.fullmatch(sub)
    if m is None:
        raise KeyError(f"unmapped VQGAN {tower} param {'/'.join(path)}")
    level, i, kind, j = m.groups()
    head = f"{tower}.{level}.{i}.{kind}" + ("" if j is None else f".{j}")
    return ".".join([head, *mods[1:], tleaf])


def _quantizer_key(path, gumbel=False) -> str:
    """The port name of a flax quantizer leaf (`path` below `quantize`)."""
    if path[-1] == "embedding":  # a gradient-trained codebook parameter
        owner = "embed" if gumbel and len(path) == 1 else "embedding"
        return ".".join(["quantize", *path[:-1], owner, "weight"])
    if path[-1] in _EMA_LEAF:
        return ".".join(["quantize", *path[:-1], _EMA_LEAF[path[-1]]])
    return ".".join(["quantize", *path])  # lucidrains' embed / embed_avg / cluster_size / initted


def vqgan_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX `VQGANNet` variables `{"params", "ema"}` of a `VQModel`,
    `MultiVQModel` or `RQModel` -> the port model's state_dict: `encoder.*`,
    `decoder.*` (taming's names), `quant_conv.*`, `post_quant_conv.*` and the
    quantizer's `quantize.*`: a gradient-trained codebook as
    `quantize.embedding.weight` (GumbelQuantize: `quantize.proj.*`,
    `quantize.embed.weight`), an EMA codebook as `quantize[.<inner |
    codebook_shared | codebook_d>].codebook.{weight,cluster_size_ema,embed_ema}`,
    lucidrains' buffers under their own names."""
    params = variables.get("params", {})
    gumbel = "proj" in params.get("quantize", {})
    sd = {}
    for path, v in _flatten(params).items():
        mods = [m for m in path[:-1] if m != "GroupNorm_0"]
        tleaf, tv = _leaf(path[-1], v)
        root = path[0]
        if root in ("quant_conv", "post_quant_conv"):
            key = f"{root}.{tleaf}"
        elif root in ("encoder", "decoder"):
            key = _vqgan_tower_key(root, mods[1:], tleaf, path)
        elif root == "quantize" and path[1] == "proj":
            key = f"quantize.proj.{tleaf}"
        elif root == "quantize":
            key = _quantizer_key(path[1:], gumbel)
        else:
            raise KeyError(f"unmapped VQGAN param {'/'.join(path)}")
        sd[key] = _tensor(tv)
    for path, v in _flatten(variables.get("ema", {}).get("quantize", {})).items():
        key = _quantizer_key(path)
        sd[key] = (torch.from_numpy(np.array(v)) if np.asarray(v).dtype == np.bool_
                   else _tensor(v))
    return sd


def _conv_or_dense(prefix, leaves) -> Dict[str, torch.Tensor]:
    out = {}
    for name, v in leaves.items():
        tleaf, tv = _leaf(name, np.asarray(v))
        out[f"{prefix}.{tleaf}"] = _tensor(tv)
    return out


_SG2_BLOCK = {"conv_res": "conv_res", "net_conv1": "net.0", "net_conv2": "net.2",
              "down_conv": "downsample.1"}
_SG2_ATTN = {"to_q": "0.fn.fn.to_q", "to_kv_dw": "0.fn.fn.to_kv.net.0",
             "to_kv_pw": "0.fn.fn.to_kv.net.1", "to_out": "0.fn.fn.to_out"}
_SG2_FF = {"attn_norm": "0.fn.norm", "ff_norm": "1.fn.norm", "ff_conv1": "1.fn.fn.0",
           "ff_conv2": "1.fn.fn.2"}


def stylegan2_disc_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """`StyleGAN2Discriminator` flax params -> the reference state_dict names
    (the inverse of the JAX package's `convert_stylegan2_disc_state_dict`),
    the Blur buffers `blocks.{i}.downsample.0.f` included; the dense head's
    rows go from the NHWC flatten order (h, w, c) to torch's (c, h, w)."""
    params = params.get("params", params)
    sd = {}
    for name, sub in params.items():
        if name.startswith("blocks_"):
            i = name.split("_")[1]
            for part, leaves in sub.items():
                sd.update(_conv_or_dense(f"blocks.{i}.{_SG2_BLOCK[part]}", leaves))
            if "down_conv" in sub:
                sd[f"blocks.{i}.downsample.0.f"] = torch.tensor([1.0, 2.0, 1.0])
        elif name.startswith("attn_"):
            i = name.split("_")[1]
            for part, leaves in sub.items():
                if part == "attn":
                    for conv, cl in leaves.items():
                        sd.update(_conv_or_dense(f"attn_blocks.{i}.{_SG2_ATTN[conv]}", cl))
                elif part.endswith("_norm"):
                    for leaf, v in leaves.items():
                        sd[f"attn_blocks.{i}.{_SG2_FF[part]}.{leaf}"] = \
                            _tensor(v).reshape(1, -1, 1, 1)
                else:
                    sd.update(_conv_or_dense(f"attn_blocks.{i}.{_SG2_FF[part]}", leaves))
        elif name == "final_conv":
            sd.update(_conv_or_dense("final_conv", sub))
        elif name == "to_logit":
            k = np.asarray(sub["kernel"])  # (4c, 1) in (h, w, c) order
            c = k.shape[0] // 4
            sd["to_logit.weight"] = _tensor(np.transpose(k.reshape(2, 2, c, 1),
                                                         (3, 2, 0, 1)).reshape(1, 4 * c))
            sd["to_logit.bias"] = _tensor(sub["bias"])
        else:
            raise KeyError(f"unmapped StyleGAN2 discriminator param {name}")
    return sd


def lucidrains_disc_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """`LucidrainsDiscriminator` flax params -> the reference state_dict
    names (the inverse of `convert_lucidrains_disc_state_dict`)."""
    params = params.get("params", params)
    sd = {}
    for name, sub in params.items():
        if name == "layer0_cross_embed":
            for conv, leaves in sub.items():
                sd.update(_conv_or_dense(f"layers.0.0.convs.{conv.split('_')[1]}", leaves))
            continue
        m = re.fullmatch(r"layers_(\d+)_(conv|norm|res_groupnorm|res_project)", name)
        if m is not None:
            i, part = int(m.group(1)) + 1, m.group(2)
            tail = {"conv": "0", "norm": "2", "res_groupnorm": "3.block.groupnorm",
                    "res_project": "3.block.project"}[part]
            sd.update(_conv_or_dense(f"layers.{i}.{tail}", sub))
        elif name in ("logits_conv1", "logits_conv2"):
            sd.update(_conv_or_dense(f"to_logits.{0 if name == 'logits_conv1' else 2}", sub))
        else:
            raise KeyError(f"unmapped lucidrains discriminator param {name}")
    return sd


def stage1_state_from_flax(state) -> dict:
    """A JAX `Stage1State` (read by attribute: `ae_params`, `ema`,
    `loss_params`, `loss_stats`, `ae_opt`, `disc_opt`, `step`, `epoch`) ->
    `{"state_dict", "ae_opt", "disc_opt", "step", "epoch"}`: the state_dict
    of a port `DualGrainVQModel` (or, for a JAX `VQGANNet`, a `models/vqgan.py`
    model) built with the same GAN lossconfig (loads
    with `strict=True` once the model's own constant LPIPS scaling buffers are
    added, as `load_stage1_state` does) and the two `(count, m, v)` Adam
    states for `Stage1Trainer.load_optimizer_state`."""
    if "conv_in" in state.ae_params.get("encoder", {}):  # a fixed-length VQGANNet

        def ae_params(tree):
            return vqgan_state_dict_from_flax({"params": tree})

        sd = vqgan_state_dict_from_flax({"params": state.ae_params, "ema": state.ema})
    else:
        ae_params = _dqvae_params_from_flax
        sd = dqvae_state_dict_from_flax({"params": state.ae_params, "ema": state.ema})
    loss_params = state.loss_params
    for k, v in lpips_state_dict_from_flax(loss_params["perceptual_loss"]).items():
        sd[f"loss.perceptual_loss.{k}"] = v
    stats = (state.loss_stats or {}).get("discriminator", {})
    for k, v in discriminator_state_dict_from_flax(loss_params["discriminator"], stats).items():
        sd[f"loss.discriminator.{k}"] = v
    return {"state_dict": sd,
            "ae_opt": adam_state_from_optax(state.ae_opt, ae_params),
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


_HEAD = re.compile(r"(position|value)_head(_ln)?")
_LEGACY_RENAMES = (
    (re.compile(r"(down|up)_(\d+)_(block|attn)_(\d+)"), r"\1.\2.\3.\4"),
    (re.compile(r"(down|up)_(\d+)_(downsample|upsample)"), r"\1.\2.\3"),
    (re.compile(r"mid_(block_1|attn_1|block_2)"), r"mid.\1"),
    (re.compile(r"temb_dense(\d)"), r"temb.dense.\1"),
    (re.compile(r"model_(\d+)"), r"model.\1"),
    (re.compile(r"res_(\d+)_(\d+)"), r"res_blocks.\1.\2"),
    (re.compile(r"upsample_(\d+)"), r"upsample_blocks.\1"),
    (re.compile(r"(attn|res|block)_(\d+)"), None),  # ModuleList children, below
)


def _legacy_module(mods) -> str:
    """A flax module path of the legacy stage-2 family -> the port's."""
    out, in_stack = [], False
    for m in mods:
        if m == "GroupNorm_0":
            continue
        if re.fullmatch(r"h_(\d+)", m):  # a TransformerStack block
            out.append(m[2:])
            in_stack = True
            continue
        if in_stack and m in ("mlp_fc", "mlp_proj"):
            out.append("mlp.0" if m == "mlp_fc" else "mlp.2")
            continue
        head = _HEAD.fullmatch(m)
        if head is not None:
            out.append(f"{head.group(1)}_head.{0 if head.group(2) else 1}")
            continue
        for pattern, repl in _LEGACY_RENAMES:
            hit = pattern.fullmatch(m)
            if hit is None:
                continue
            if repl is None:  # attn_i / res_i (TokenReconstruction), block_i (ViT)
                name = "blocks" if hit.group(1) == "block" else hit.group(1)
                m = f"{name}.{hit.group(2)}"
            else:
                m = pattern.sub(repl, m)
            break
        out.append(m)
    return ".".join(out)


def legacy_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The flax params (or `{"params": ...}`) of a module of the legacy
    stage-2 family -> the port module's state_dict: `GPT`, `RQTransformer`,
    `StackedPositionGPT`, `PositionAwareGPT`, the ViT encoder / decoder,
    `MaskedSelfAttnBlock` / `TokenReconstruction` / `AttnDecoder`, the DDPM
    UNets. Stack blocks `h_{i}` -> `{i}` with `mlp_fc` / `mlp_proj` ->
    `mlp.0` / `mlp.2`; the codec towers' `down_{i}_block_{j}` ->
    `down.{i}.block.{j}` and the like; `(position|value)_head[_ln]` ->
    `..._head.{1|0}`; leaves as `_leaf` (learned position tables as they
    are)."""
    params = params.get("params", params)
    sd = {}
    for path, v in _flatten(params).items():
        if len(path) == 1 and path[0].startswith("pos_emb"):
            sd[path[0]] = _tensor(v)
            continue
        tleaf, tv = _leaf(path[-1], v)
        module = _legacy_module(path[:-1])
        sd[f"{module}.{tleaf}" if module else tleaf] = _tensor(tv)
    return sd


def legacy_stage2_state_dict_from_flax(variables, model) -> Dict[str, torch.Tensor]:
    """The JAX variables `{"transformer", "first_stage"}` of a legacy stage-2
    model (`UncondTransformer` and its subclasses, `RQTransformerTrainer`)
    -> the state_dict of the port `model` (its permuter's order buffers
    are the model's own: the JAX permuters hold none)."""
    sd = {f"transformer.{k}": v
          for k, v in legacy_state_dict_from_flax(variables["transformer"]).items()}
    sd.update({f"first_stage_model.{k}": v
               for k, v in vqgan_state_dict_from_flax(variables["first_stage"]).items()})
    sd.update({k: v for k, v in model.state_dict().items() if k.startswith("permuter.")})
    return sd
