"""Mask-aware attention decoder (counterpart of
`dynamicvectorquantization_tpu/nn/attn_decoder.py`), NCHW.

A VQGAN-style decoder whose middle is a `TokenReconstruction` stack,
[res_in, {attention, resnet} x n_layer], where the attention can be
reweighted by a per-position mask that anneals towards 1 across the layers
(`mask_update_mode` square / cube / linear / const). Names are the JAX
modules' (`conv_in`, `mid.res_in`, `mid.attn.{i}`, `mid.res.{i}`, the up
path as the codec's `up.{i}.block.{j}` / `up.{i}.attn.{j}` /
`up.{i}.upsample`, `norm_out`, `conv_out`).

Dropout (`dropout > 0`, in training mode) zeroes the activations before
each ResnetBlock's and `ResnetBlockK1`'s second convolution, as the JAX
module's `nn.Dropout`: the masks are `nn/blocks.py` `DropoutMasks` under one
seed drawn from the caller's `torch.Generator` (`forward(..., generator=)`),
keyed by each block's name, so the same generator state draws the same
masks; they follow torch's generator, not JAX's PRNG.

`MaskedSelfAttnBlock` is one-head attention over the H*W positions with
1x1 projections. Without a mask and at up to 512 channels it is the fused
attention, non-causal, as `AttnBlock` calls it: kernels #4 / #5 on a CUDA
tensor, the plain versions on a CPU tensor. Wider than 512 channels (one
head of hd > 512, which no kernel takes; the JAX class's defaults give
1,024) it is chosen by shape, before any launch, to be the einsum of the
JAX module, which runs no Pallas kernel there on any backend: the
reference's route, not a kernel's fallback. With a mask the probabilities
are multiplied by it after the softmax (and renormalised with `reweight`)
in the same einsum, as in the JAX module.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import fused_causal_attention
from .blocks import (AttnBlock, Conv2d, Normalize, ResnetBlock, Upsample, key_dropout_blocks,
                     nonlinearity, training_masks)
from .init import flax_defaults_


class ResnetBlockK1(nn.Module):
    """ResnetBlock with a configurable (1 or 3) conv kernel."""

    def __init__(self, in_channels: int, out_channels=None, conv_shortcut=False, dropout=0.0,
                 kernel_size=1):
        super().__init__()
        out_ch = out_channels or in_channels
        pad = kernel_size // 2
        self.norm1 = Normalize(in_channels)
        self.conv1 = Conv2d(in_channels, out_ch, kernel_size, padding=pad)
        self.norm2 = Normalize(out_ch)
        self.dropout_rate = float(dropout)
        self.dropout_key = 0
        self.conv2 = Conv2d(out_ch, out_ch, kernel_size, padding=pad)
        if in_channels != out_ch:
            if conv_shortcut:
                self.conv_shortcut = Conv2d(in_channels, out_ch, kernel_size, padding=pad)
            else:
                self.nin_shortcut = Conv2d(in_channels, out_ch, 1)

    def forward(self, x, masks=None):
        """`masks`: `DropoutMasks` in a training forward with dropout, else None."""
        h = nonlinearity(self.norm2(self.conv1(nonlinearity(self.norm1(x)))))
        if masks is not None and self.dropout_rate > 0.0:
            keep = masks.keep(self, h.shape, h.device)
            h = torch.where(keep, h / (1.0 - self.dropout_rate), 0.0)
        h = self.conv2(h)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        elif hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


# the widest single head the attention kernels take (hd 512)
KERNEL_MAX_CHANNELS = 512


class MaskedSelfAttnBlock(nn.Module):
    """Self-attention over H*W; `mask` (B, H*W) weighs each KEY position
    after the softmax, `reweight` renormalises the rows afterwards."""

    def __init__(self, in_channels: int, reweight: bool = False):
        super().__init__()
        self.reweight = reweight
        self.norm = Normalize(in_channels)
        self.q = Conv2d(in_channels, in_channels, 1)
        self.k = Conv2d(in_channels, in_channels, 1)
        self.v = Conv2d(in_channels, in_channels, 1)
        self.proj_out = Conv2d(in_channels, in_channels, 1)

    def forward(self, x, mask=None):
        b, c, h, w = x.shape
        h_ = self.norm(x)

        def tokens(z):  # (B, C, H, W) -> (B, H*W, C)
            return z.flatten(2).transpose(1, 2).contiguous()

        q, k, v = tokens(self.q(h_)), tokens(self.k(h_)), tokens(self.v(h_))
        if mask is None and c <= KERNEL_MAX_CHANNELS:
            y = fused_causal_attention(q, k, v, n_head=1, scale=c ** -0.5, causal=False)
        else:
            att = torch.softmax(torch.einsum("bqc,bkc->bqk", q, k) * c ** -0.5, dim=2)
            if mask is not None:
                att = att * mask[:, None, :].to(att.dtype)
                if self.reweight:
                    att = att / att.sum(dim=-1, keepdim=True)
            y = torch.einsum("bqk,bkc->bqc", att, v)
        return x + self.proj_out(y.transpose(1, 2).reshape(b, c, h, w))


class TokenReconstruction(nn.Module):
    """[res_in, {attention, resnet} x n_layer] with mask annealing."""

    def __init__(self, n_layer: int, input_dim: int, dropout=0.0, attn_type="self-attn",
                 resnet_kernel_size=1, mask_update_mode="square", reweight=False, fix_bug=False):
        super().__init__()
        if attn_type not in ("self-attn", "bias-self-attn"):
            raise ValueError(f"attn_type {attn_type!r}")
        if mask_update_mode not in ("square", "cube", "linear", "const"):
            raise ValueError(mask_update_mode)
        self.n_layer = n_layer
        self.biased = attn_type == "bias-self-attn"
        self.mask_update_mode = mask_update_mode
        inner_k = resnet_kernel_size if fix_bug else 1
        self.res_in = ResnetBlockK1(input_dim, dropout=dropout, kernel_size=resnet_kernel_size)
        self.attn = nn.ModuleList(MaskedSelfAttnBlock(input_dim, reweight)
                                  for _ in range(n_layer))
        self.res = nn.ModuleList(ResnetBlockK1(input_dim, dropout=dropout, kernel_size=inner_k)
                                 for _ in range(n_layer))

    def forward(self, x, mask=None, masks=None):
        """`masks`: the ResnetBlocks' `DropoutMasks` in a training forward."""
        if mask is not None and self.mask_update_mode in ("square", "cube"):
            mask = mask + 0.02 * (1 - mask)
        original = mask
        gain = 1.0 / max(self.n_layer - 1, 1)
        x = self.res_in(x, masks)
        for i in range(self.n_layer):
            x = self.attn[i](x, mask if self.biased else None)
            x = self.res[i](x, masks)
            if mask is not None:
                if self.mask_update_mode == "square":
                    mask = torch.sqrt(mask)
                elif self.mask_update_mode == "cube":
                    mask = torch.pow(mask, 1.0 / 3.0)
                elif self.mask_update_mode == "linear":
                    mask = original + (i + 1) * gain * (1 - original)
        return x


class AttnDecoder(nn.Module):
    """VQGAN decoder with a `TokenReconstruction` middle; z (B, z_channels,
    h, w) -> (B, out_ch, H, W)."""

    def __init__(self, ch=128, out_ch=3, ch_mult=(1, 2, 4, 8), num_res_blocks=2,
                 attn_resolutions=(), dropout=0.0, resamp_with_conv=True, in_channels=3,
                 resolution=256, z_channels=256, give_pre_end=False, token_n_layer=6,
                 token_attn_type="self-attn", resnet_kernel_size=1, mask_update_mode="square",
                 reweight=False, fix_bug=False):
        super().__init__()
        num_res = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (num_res - 1)
        self.give_pre_end = give_pre_end
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = TokenReconstruction(token_n_layer, block_in, dropout, token_attn_type,
                                       resnet_kernel_size, mask_update_mode, reweight, fix_bug)
        up = [None] * num_res
        for i_level in reversed(range(num_res)):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_out = ch * ch_mult[i_level]
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out, dropout=dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != 0:
                level.upsample = Upsample(block_in, resamp_with_conv)
                curr_res *= 2
            up[i_level] = level
        self.up = nn.ModuleList(up)
        self.norm_out = Normalize(block_in)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1)
        self.dropout_rate = float(dropout)
        key_dropout_blocks(self)

    def init_weights(self, generator: torch.Generator):
        """flax's defaults, as the JAX module draws them (`flax_defaults_`)."""
        flax_defaults_(self, generator)

    def forward(self, z, mask=None, generator=None, masks=None):
        """`mask` (B, h*w). In training mode with `dropout > 0` the
        ResnetBlocks drop under `masks` (`DropoutMasks`), or under masks
        drawn from `generator` (see the module note)."""
        masks = training_masks(masks, self.dropout_rate, self.training, generator)
        h = self.mid(self.conv_in(z), mask, masks)
        for i_level in reversed(range(len(self.up))):
            level = self.up[i_level]
            for i_block, block in enumerate(level.block):
                h = block(h, masks)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        if self.give_pre_end:
            return h
        return self.conv_out(nonlinearity(self.norm_out(h)))
