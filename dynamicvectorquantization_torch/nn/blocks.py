"""VQGAN conv/attention blocks, NCHW (counterpart of
`dynamicvectorquantization_tpu/nn/blocks.py`).

Swish nonlinearity; GroupNorm with 32 groups (or the largest divisor of the
channel count, for tiny test configs), eps 1e-6; Upsample = nearest x2 +
3x3 conv; Downsample = (0, 1), (0, 1) zero pad + 3x3 stride-2 conv (or a
2x2 average pool without the conv); ResnetBlock norm-swish-conv x2 with a
1x1 `nin_shortcut` (or 3x3 `conv_shortcut`); AttnBlock = one-head attention
over the H*W positions.

`AttnBlock` always goes through `ops.attention.fused_causal_attention`
(non-causal here), the differentiable pair of CUDA kernels for CUDA tensors
(any channel count the kernels take; the TPU's `c % 128` gate does not carry
over, and a shape the kernels cannot take raises) and their plain versions
for CPU tensors; under `torch.no_grad()` only the forward kernel runs.
`Downsample` goes through `ops.downsample.strided_conv3x3_down` the same way. The JAX package's
space-to-depth variant (`s2d`) is a measured dead end there and is not
ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_causal_attention
from ..ops.downsample import strided_conv3x3_down


def nonlinearity(x):
    return x * torch.sigmoid(x)  # swish


def num_groups(channels: int, target: int = 32) -> int:
    if channels % target == 0:
        return target
    g = min(target, channels)
    while channels % g:
        g -= 1
    return g


def Normalize(in_channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(num_groups(in_channels), in_channels, eps=1e-6, affine=True)


class Upsample(nn.Module):
    def __init__(self, in_channels: int, with_conv: bool = True):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x) if self.with_conv else x


class Downsample(nn.Module):
    def __init__(self, in_channels: int, with_conv: bool = True):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            # the pad is the kernel's own; the Conv2d holds the parameters
            self.conv = nn.Conv2d(in_channels, in_channels, 3, stride=2, padding=0)

    def forward(self, x):
        if self.with_conv:
            return strided_conv3x3_down(x, self.conv.weight, self.conv.bias)
        return F.avg_pool2d(x, 2, 2)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels=None, conv_shortcut=False,
                 dropout=0.0):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = Normalize(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = Normalize(out_channels)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            if conv_shortcut:
                self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 3, padding=1)
            else:
                self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(nonlinearity(self.norm1(x)))
        h = self.conv2(self.dropout(nonlinearity(self.norm2(h))))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        elif hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.norm = Normalize(in_channels)
        self.q = nn.Conv2d(in_channels, in_channels, 1)
        self.k = nn.Conv2d(in_channels, in_channels, 1)
        self.v = nn.Conv2d(in_channels, in_channels, 1)
        self.proj_out = nn.Conv2d(in_channels, in_channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        h_ = self.norm(x)

        def tokens(z):  # (B, C, H, W) -> (B, H*W, C)
            return z.flatten(2).transpose(1, 2).contiguous()

        y = fused_causal_attention(
            tokens(self.q(h_)), tokens(self.k(h_)), tokens(self.v(h_)),
            n_head=1, scale=c ** -0.5, causal=False)
        y = y.transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(y)
