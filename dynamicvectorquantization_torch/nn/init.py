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
