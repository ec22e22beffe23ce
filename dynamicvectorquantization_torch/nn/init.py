"""Seeded initializers of the port that follow the JAX package's flax
defaults (the JAX package is the reference the port is held to)."""
from __future__ import annotations

import math

import torch
from torch import nn

# flax `variance_scaling(..., "truncated_normal")` divides by the standard
# deviation of a unit normal truncated at +-2, so the drawn variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's `lecun_normal()`: a normal truncated at two standard deviations
    with variance 1/fan_in, fan_in = everything but the output channel."""
    std = (1.0 / math.sqrt(weight[0].numel())) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def flax_default_(mod: nn.Module, generator: torch.Generator) -> None:
    """A `Conv2d` / `Linear` as flax's `nn.Conv` / `nn.Dense` draw it:
    lecun-normal kernel, zero bias."""
    lecun_normal_(mod.weight, generator)
    if mod.bias is not None:
        mod.bias.zero_()


@torch.no_grad()
def flax_defaults_(module: nn.Module, generator: torch.Generator) -> None:
    """Every `Conv2d` / `Linear` of `module` as `flax_default_`, every
    GroupNorm the identity: flax's defaults for a conv tower."""
    for mod in module.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            flax_default_(mod, generator)
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


@torch.no_grad()
def normal_(weight: torch.Tensor, generator: torch.Generator, std: float = 0.02) -> torch.Tensor:
    """The JAX package's `normal_init(std)`: N(0, std^2)."""
    return weight.normal_(0.0, std, generator=generator)


@torch.no_grad()
def trunc_normal_(weight: torch.Tensor, generator: torch.Generator, std: float = 1.0,
                  mean: float = 0.0, a: float = -2.0, b: float = 2.0) -> torch.Tensor:
    """The JAX package's `trunc_normal_init` (the timm / torch recipe): a
    uniform draw over [2 cdf(a') - 1, 2 cdf(b') - 1], a' = (a - mean) / std,
    through erfinv, scaled, shifted and clipped to the absolute bounds
    [a, b]."""

    def cdf(z):
        return (1.0 + math.erf(z / math.sqrt(2.0))) / 2.0

    lo, hi = cdf((a - mean) / std), cdf((b - mean) / std)
    u = torch.rand(weight.shape, generator=generator, device=weight.device,
                   dtype=torch.float32)
    u = u * (2 * hi - 2 * lo) + (2 * lo - 1)
    x = torch.erfinv(u) * (std * math.sqrt(2.0)) + mean
    return weight.copy_(x.clamp_(a, b))


@torch.no_grad()
def gpt_init_(module: nn.Module, generator: torch.Generator, std: float = 0.02) -> None:
    """The JAX GPTs' init: every embedding row and Linear weight N(0, std^2),
    Linear biases zero, LayerNorms the identity; learned position tables
    (`pos_emb*` parameters) zero."""
    from .norm import LayerNorm

    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            normal_(mod.weight, generator, std)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for name, p in module.named_parameters():
        if name.rsplit(".", 1)[-1].startswith("pos_emb"):
            p.zero_()
