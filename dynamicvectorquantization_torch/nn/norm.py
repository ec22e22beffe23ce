"""LayerNorm with f32 statistics (counterpart of
`dynamicvectorquantization_tpu/nn/norm.py` `FusedLayerNorm`).

eps 1e-5, statistics in f32, output in the input dtype. Dispatch follows the
JAX module: with 256 rows or more (the full-sequence training forward) it
goes through `ops.layernorm.fused_layernorm` — the CUDA kernels of
`csrc/layernorm.cu` on a CUDA tensor, forward and backward, or an error for
a width they do not take; their plain versions on a CPU tensor. With fewer
rows (KV-cached decode, rows = batch) it is the plain math, where a kernel
launch per token would buy nothing.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.layernorm import fused_layernorm, fused_layernorm_plain

MIN_ROWS = 256


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        if x.numel() // x.shape[-1] >= MIN_ROWS:
            return fused_layernorm(x.contiguous(), self.weight, self.bias, self.eps)
        return fused_layernorm_plain(x, self.weight, self.bias, self.eps)
