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

Dtypes follow flax's rules, as the JAX modules have them. A layer built with
`compute_dtype` (the JAX modules' `dtype`, e.g. `torch.bfloat16` in the
DQ-VAE's bf16 compute mode) casts its input and its parameters to that dtype
at use; the parameters themselves keep theirs (f32), so their gradients are
f32. A layer without one computes in the promoted dtype of its input and its
parameters: bf16 throughout when the parameters were cast to bf16 (the
stage-2 trainer's frozen first stage), f32 when either is f32. GroupNorm
takes its statistics and normalises in f32 whatever the dtypes and rounds
once to its output dtype (QUIRKS #23); the residual adds run in the compute
dtype (`x.astype(dtype) + h`), or in the promoted one rounded back to the
input's dtype without one. `torch.autocast` is not used: it would keep the
norms in f32 and round elsewhere.
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


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def as_dtype(dtype):
    """A config's dtype (None, "bfloat16", "float32" or a torch dtype) as a
    torch dtype or None. The kernels take f32 and bf16 only: any other
    dtype raises."""
    if dtype is None or isinstance(dtype, torch.dtype) and dtype in _DTYPES.values():
        return dtype
    if dtype in _DTYPES:
        return _DTYPES[dtype]
    raise NotImplementedError(f"compute dtype {dtype!r}: the port runs float32 and bfloat16 only")


def layer_dtype(compute_dtype, x, weight):
    """flax's rule: the layer's own dtype when set, else the promoted dtype
    of its input and its parameters."""
    return compute_dtype or torch.promote_types(x.dtype, weight.dtype)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` that computes in `layer_dtype`: input, weight and bias are
    cast to it at use. In bf16 the bias is added after the convolution, each
    rounded to bf16, as flax's `Conv` adds it; in f32 it is part of the
    convolution."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = as_dtype(compute_dtype)

    def forward(self, x):
        dt = layer_dtype(self.compute_dtype, x, self.weight)
        if dt == torch.float32:
            return self._conv_forward(x.float(), self.weight.float(), self.bias.float())
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y + self.bias.to(dt)[:, None, None]


class GroupNorm(nn.GroupNorm):
    """`nn.GroupNorm` with flax's semantics: statistics and normalisation in
    f32, the result rounded once to `layer_dtype`."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 compute_dtype=None):
        super().__init__(num_groups, num_channels, eps=eps, affine=True)
        self.compute_dtype = as_dtype(compute_dtype)

    def forward(self, x):
        out = layer_dtype(self.compute_dtype, x, self.weight)
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                         self.eps)
        return y.to(out)


def Normalize(in_channels: int, compute_dtype=None) -> GroupNorm:
    return GroupNorm(num_groups(in_channels), in_channels, eps=1e-6, compute_dtype=compute_dtype)


class Upsample(nn.Module):
    def __init__(self, in_channels: int, with_conv: bool = True, compute_dtype=None):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = Conv2d(in_channels, in_channels, 3, padding=1,
                               compute_dtype=compute_dtype)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x) if self.with_conv else x


class Downsample(nn.Module):
    def __init__(self, in_channels: int, with_conv: bool = True, compute_dtype=None):
        super().__init__()
        self.with_conv = with_conv
        self.compute_dtype = as_dtype(compute_dtype)
        if with_conv:
            # the pad is the kernel's own; the Conv2d holds the parameters
            self.conv = nn.Conv2d(in_channels, in_channels, 3, stride=2, padding=0)

    def forward(self, x):
        if self.with_conv:
            # the JAX module's rule: its dtype when set, else the kernel's
            dt = self.compute_dtype or self.conv.weight.dtype
            return strided_conv3x3_down(x.to(dt), self.conv.weight.to(dt),
                                        self.conv.bias.to(dt))
        return F.avg_pool2d(x, 2, 2)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels=None, conv_shortcut=False,
                 dropout=0.0, compute_dtype=None):
        super().__init__()
        out_channels = out_channels or in_channels
        dt = self.compute_dtype = as_dtype(compute_dtype)
        self.norm1 = Normalize(in_channels, dt)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, compute_dtype=dt)
        self.norm2 = Normalize(out_channels, dt)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, compute_dtype=dt)
        if in_channels != out_channels:
            if conv_shortcut:
                self.conv_shortcut = Conv2d(in_channels, out_channels, 3, padding=1,
                                            compute_dtype=dt)
            else:
                self.nin_shortcut = Conv2d(in_channels, out_channels, 1, compute_dtype=dt)

    def forward(self, x):
        h = self.conv1(nonlinearity(self.norm1(x)))
        h = self.conv2(self.dropout(nonlinearity(self.norm2(h))))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        elif hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        if self.compute_dtype is None:
            return (x + h).to(x.dtype)
        return x.to(self.compute_dtype) + h


class AttnBlock(nn.Module):
    def __init__(self, in_channels: int, compute_dtype=None):
        super().__init__()
        dt = as_dtype(compute_dtype)
        self.norm = Normalize(in_channels, dt)
        self.q = Conv2d(in_channels, in_channels, 1, compute_dtype=dt)
        self.k = Conv2d(in_channels, in_channels, 1, compute_dtype=dt)
        self.v = Conv2d(in_channels, in_channels, 1, compute_dtype=dt)
        self.proj_out = Conv2d(in_channels, in_channels, 1, compute_dtype=dt)

    def forward(self, x):
        b, c, h, w = x.shape
        h_ = self.norm(x)

        def tokens(z):  # (B, C, H, W) -> (B, H*W, C)
            return z.flatten(2).transpose(1, 2).contiguous()

        y = fused_causal_attention(
            tokens(self.q(h_)), tokens(self.k(h_)), tokens(self.v(h_)),
            n_head=1, scale=c ** -0.5, causal=False)
        y = self.proj_out(y.transpose(1, 2).reshape(b, c, h, w))
        return x.to(y.dtype) + y
