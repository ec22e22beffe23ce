"""LayerNorm with f32 statistics (counterpart of
`dynamicvectorquantization_tpu/nn/norm.py` `FusedLayerNorm`).

eps 1e-5, statistics in f32, output in the input dtype. On the decode path
rows = batch < 256, where the JAX package also skips its Pallas LayerNorm,
so this is plain PyTorch; the kernel (TPU kernels #6/#7) is queued in
ROADMAP.md with the training slice.
"""
from __future__ import annotations

import torch
from torch import nn


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        xc = xf - mean
        var = (xc * xc).mean(dim=-1, keepdim=True)
        y = xc * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)
