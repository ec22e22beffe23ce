"""Single-grain VQGAN encoder and decoder, NCHW (counterpart of
`dynamicvectorquantization_tpu/nn/vqgan_codec.py` `VQGANEncoder` /
`VQGANDecoder`): taming-transformers' `Encoder` / `Decoder`, the codec of the
fixed-length VQGAN, multi-VQ and RQ-VAE baselines.

Built on the DQ-VAE's blocks (`nn/blocks.py`): every `AttnBlock` goes through
the attention kernels (#4 / #5), every `Downsample` through the strided-conv
kernel (#10). Reference state_dict names: `conv_in`, `down.{i}.{block|attn}.{j}`,
`down.{i}.downsample.conv`, `mid.{block_1,attn_1,block_2}`, `norm_out`,
`conv_out`; the decoder's `up.{i}.{block|attn}.{j}` and `up.{i}.upsample.conv`,
so a taming VQGAN checkpoint's `encoder.*` / `decoder.*` load with
`load_state_dict`.

`dtype` goes to the towers' convs, blocks and resamplers as in the JAX
modules; `norm_out` and `conv_out` have none. The decoder's `give_pre_end`
returns the up-stack's output, `return_pre_out` also the input of
`conv_out` (the stage-1 trainer's adaptive weight). ResnetBlock dropout in
training takes the caller's `dropout` masks (`DropoutMasks`); `remat` makes
each ResnetBlock, AttnBlock and Upsample one checkpointed segment.
"""
from __future__ import annotations

from torch import nn

from .blocks import (AttnBlock, Conv2d, Downsample, Normalize, ResnetBlock, Upsample, as_dtype,
                     key_dropout_blocks, nonlinearity, segment, training_masks)


def _mid(block_in, dropout, dtype):
    mid = nn.Module()
    mid.block_1 = ResnetBlock(block_in, dropout=dropout, compute_dtype=dtype)
    mid.attn_1 = AttnBlock(block_in, compute_dtype=dtype)
    mid.block_2 = ResnetBlock(block_in, dropout=dropout, compute_dtype=dtype)
    return mid


def _run_mid(mid, h, masks, remat):
    h = segment(remat, mid.block_1, h, masks)
    h = segment(remat, mid.attn_1, h)
    return segment(remat, mid.block_2, h, masks)


def _run_level(level, h, masks, remat):
    for i_block, block in enumerate(level.block):
        h = segment(remat, block, h, masks)
        if len(level.attn):
            h = segment(remat, level.attn[i_block], h)
    return h


class VQGANEncoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2, attn_resolutions=(16,),
                 dropout=0.0, resamp_with_conv=True, in_channels=3, resolution=256,
                 z_channels=256, double_z=False, dtype=None):
        super().__init__()
        dtype = as_dtype(dtype)
        self.resolution = resolution
        self.dropout = dropout
        num_res = len(ch_mult)
        in_ch_mult = (1,) + tuple(ch_mult)
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1, compute_dtype=dtype)
        curr_res = resolution
        levels = []
        for i_level in range(num_res):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            block_in = ch * in_ch_mult[i_level]
            block_out = ch * ch_mult[i_level]
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out, dropout=dropout,
                                               compute_dtype=dtype))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in, compute_dtype=dtype))
            if i_level != num_res - 1:
                level.downsample = Downsample(block_in, resamp_with_conv, compute_dtype=dtype)
                curr_res //= 2
            levels.append(level)
        self.down = nn.ModuleList(levels)
        self.mid = _mid(block_in, dropout, dtype)
        self.norm_out = Normalize(block_in)
        self.conv_out = Conv2d(block_in, 2 * z_channels if double_z else z_channels, 3, padding=1)
        key_dropout_blocks(self)

    def forward(self, x, train=False, dropout=None, generator=None, remat=False):
        """(B, C, H, W) images -> (B, z, H / 2^(L-1), W / 2^(L-1))."""
        masks = training_masks(dropout, self.dropout, train, generator)
        h = self.conv_in(x)
        for level in self.down:
            h = _run_level(level, h, masks, remat)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = _run_mid(self.mid, h, masks, remat)
        return self.conv_out(nonlinearity(self.norm_out(h)))


class VQGANDecoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2, attn_resolutions=(16,),
                 dropout=0.0, resamp_with_conv=True, in_channels=3, out_ch=3, resolution=256,
                 z_channels=256, give_pre_end=False, dtype=None):
        super().__init__()
        dtype = as_dtype(dtype)
        self.give_pre_end = give_pre_end
        self.dropout = dropout
        num_res = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (num_res - 1)
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1, compute_dtype=dtype)
        self.mid = _mid(block_in, dropout, dtype)
        levels = []
        for i_level in reversed(range(num_res)):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            block_out = ch * ch_mult[i_level]
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out, dropout=dropout,
                                               compute_dtype=dtype))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in, compute_dtype=dtype))
            if i_level != 0:
                level.upsample = Upsample(block_in, resamp_with_conv, compute_dtype=dtype)
                curr_res *= 2
            levels.insert(0, level)  # up[i_level], as in the reference
        self.up = nn.ModuleList(levels)
        self.norm_out = Normalize(block_in)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1)
        key_dropout_blocks(self)

    def _head(self, h):
        return nonlinearity(self.norm_out(h))

    def forward(self, z, train=False, return_pre_out=False, dropout=None, remat=False):
        """(B, z, h, w) latents -> (B, out_ch, H, W); with `return_pre_out`
        also the activation that feeds `conv_out`."""
        masks = training_masks(dropout, self.dropout, train)
        h = _run_mid(self.mid, self.conv_in(z), masks, remat)
        for level in reversed(self.up):
            h = _run_level(level, h, masks, remat)
            if hasattr(level, "upsample"):
                h = segment(remat, level.upsample, h)
        if self.give_pre_end:
            return h
        h = segment(remat, self._head, h)
        out = self.conv_out(h)
        return (out, h) if return_pre_out else out
