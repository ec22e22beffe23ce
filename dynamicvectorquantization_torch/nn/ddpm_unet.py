"""The DDPM UNet family of taming's `diffusionmodules/model.py`, NCHW
(counterpart of `dynamicvectorquantization_tpu/nn/ddpm_unet.py`): `Model`
(here `DDPMUNet`, timestep embedding and skip connections), `VUNet` (a
latent z joined at the middle), `SimpleDecoder` and `UpsampleDecoder`.
No reference config reaches them; they are on the registry, so they are
ported with the codec's blocks (`AttnBlock` on kernels #4 / #5,
`Downsample` on #10 for a CUDA tensor).

Taming's names: `temb.dense.{0,1}`, `conv_in`, `down.{i}.block.{j}`,
`down.{i}.attn.{j}`, `down.{i}.downsample`, `mid.{block_1,attn_1,block_2}`,
`up.{i}.block.{j}`, `up.{i}.attn.{j}`, `up.{i}.upsample`, `norm_out`,
`conv_out` (`z_in` in VUNet; a block's `temb_proj`); `SimpleDecoder`'s
`model.{0..5}`; `UpsampleDecoder`'s `res_blocks.{i}.{j}` and
`upsample_blocks.{i}`. `init_weights` draws flax's defaults (`nn/init.py`
`flax_defaults_`). ResnetBlock dropout in training draws its masks
from the forward's `generator` (`nn/blocks.py` `DropoutMasks`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .blocks import (AttnBlock, Conv2d, Downsample, Normalize, ResnetBlock, Upsample,
                     key_dropout_blocks, nonlinearity, training_masks)
from .init import flax_defaults_


def get_timestep_embedding(timesteps, embedding_dim: int):
    """Sinusoidal DDPM timestep embedding (B,) -> (B, embedding_dim)."""
    assert timesteps.dim() == 1
    half_dim = embedding_dim // 2
    scale = math.log(10000.0) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                   device=timesteps.device) * -scale)
    emb = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


class TembResnetBlock(ResnetBlock):
    """ResnetBlock with taming's timestep projection `temb_proj` (added
    after `conv1`) when `temb_channels > 0`."""

    def __init__(self, in_channels, out_channels=None, dropout=0.0, temb_channels=0):
        super().__init__(in_channels, out_channels, dropout=dropout)
        if temb_channels > 0:
            self.temb_proj = nn.Linear(temb_channels, out_channels or in_channels)

    def forward(self, x, temb=None, masks=None):
        if temb is None:
            return super().forward(x, masks)
        h = self.conv1(nonlinearity(self.norm1(x)))
        h = h + self.temb_proj(nonlinearity(temb))[:, :, None, None]
        h = nonlinearity(self.norm2(h))
        if masks is not None and self.dropout_rate > 0.0:
            keep = masks.keep(self, h.shape, h.device)
            h = torch.where(keep, h / (1.0 - self.dropout_rate), 0.0)
        h = self.conv2(h)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        elif hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class _UNet(nn.Module):
    """The down / mid / up stacks shared by `DDPMUNet` and `VUNet`."""

    def _build(self, ch, out_ch, ch_mult, num_res_blocks, attn_resolutions, dropout,
               resamp_with_conv, in_channels, resolution, temb_ch, mid_in):
        num_res = len(ch_mult)
        self.dropout = dropout
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1)
        curr_res = resolution
        in_ch_mult = (1,) + tuple(ch_mult)
        self.down = nn.ModuleList()
        block_in = ch
        for i_level in range(num_res):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_in = ch * in_ch_mult[i_level]
            block_out = ch * ch_mult[i_level]
            for _ in range(num_res_blocks):
                level.block.append(TembResnetBlock(block_in, block_out, dropout, temb_ch))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != num_res - 1:
                level.downsample = Downsample(block_in, resamp_with_conv)
                curr_res //= 2
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = TembResnetBlock(mid_in(block_in), block_in, dropout, temb_ch)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = TembResnetBlock(block_in, block_in, dropout, temb_ch)
        up = [None] * num_res
        for i_level in reversed(range(num_res)):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_out = ch * ch_mult[i_level]
            skip_in = ch * ch_mult[i_level]
            for i_block in range(num_res_blocks + 1):
                if i_block == num_res_blocks:
                    skip_in = ch * in_ch_mult[i_level]
                level.block.append(TembResnetBlock(block_in + skip_in, block_out, dropout,
                                                   temb_ch))
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
        key_dropout_blocks(self)

    def init_weights(self, generator: torch.Generator):
        flax_defaults_(self, generator)

    def _down(self, x, temb, masks):
        hs = [self.conv_in(x)]
        for level in self.down:
            for i_block, block in enumerate(level.block):
                h = block(hs[-1], temb, masks)
                if len(level.attn):
                    h = level.attn[i_block](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))
        return hs

    def _mid_up(self, h, hs, temb, masks):
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h, temb, masks)), temb, masks)
        for i_level in reversed(range(len(self.up))):
            level = self.up[i_level]
            for i_block, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=1), temb, masks)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(nonlinearity(self.norm_out(h)))


class DDPMUNet(_UNet):
    """Taming's `Model`: conv UNet with optional timestep conditioning."""

    def __init__(self, ch=64, out_ch=3, ch_mult=(1, 2, 4, 8), num_res_blocks=2,
                 attn_resolutions=(16,), dropout=0.0, resamp_with_conv=True, in_channels=3,
                 resolution=256, use_timestep=True):
        super().__init__()
        self.ch = ch
        self.use_timestep = use_timestep
        temb_ch = ch * 4 if use_timestep else 0
        if use_timestep:
            self.temb = nn.Module()
            self.temb.dense = nn.ModuleList([nn.Linear(ch, temb_ch), nn.Linear(temb_ch, temb_ch)])
        self._build(ch, out_ch, ch_mult, num_res_blocks, attn_resolutions, dropout,
                    resamp_with_conv, in_channels, resolution, temb_ch, lambda c: c)

    def forward(self, x, t=None, train=False, generator=None):
        """x (B, C, H, W); t (B,) timesteps when `use_timestep`."""
        temb = None
        if self.use_timestep:
            assert t is not None
            temb = self.temb.dense[0](get_timestep_embedding(t, self.ch))
            temb = self.temb.dense[1](nonlinearity(temb))
        masks = training_masks(None, self.dropout, train, generator)
        hs = self._down(x, temb, masks)
        return self._mid_up(hs[-1], hs, temb, masks)


class VUNet(_UNet):
    """Taming's `VUNet`: a UNet over x with a latent z (1x1 conv `z_in`)
    concatenated at the middle; no timestep."""

    def __init__(self, ch=64, out_ch=3, ch_mult=(1, 2, 4, 8), num_res_blocks=2,
                 attn_resolutions=(16,), dropout=0.0, resamp_with_conv=True, in_channels=3,
                 c_channels=3, z_channels=64, resolution=256):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.z_in = Conv2d(z_channels, block_in, 1)
        self._build(ch, out_ch, ch_mult, num_res_blocks, attn_resolutions, dropout,
                    resamp_with_conv, in_channels, resolution, 0, lambda c: 2 * c)

    def forward(self, x, z, train=False, generator=None):
        masks = training_masks(None, self.dropout, train, generator)
        hs = self._down(x, None, masks)
        h = torch.cat([hs[-1], self.z_in(z)], dim=1)
        return self._mid_up(h, hs, None, masks)


class SimpleDecoder(nn.Module):
    """Taming's `SimpleDecoder`: 1x1 conv, three ResnetBlocks, 1x1 conv,
    Upsample, norm, conv."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        c = in_channels
        self.model = nn.ModuleList([Conv2d(c, c, 1), ResnetBlock(c, 2 * c),
                                    ResnetBlock(2 * c, 4 * c), ResnetBlock(4 * c, 2 * c),
                                    Conv2d(2 * c, c, 1), Upsample(c, with_conv=True)])
        self.norm_out = Normalize(c)
        self.conv_out = Conv2d(c, out_channels, 3, padding=1)

    def init_weights(self, generator: torch.Generator):
        flax_defaults_(self, generator)

    def forward(self, x):
        for layer in self.model:
            x = layer(x)
        return self.conv_out(nonlinearity(self.norm_out(x)))


class UpsampleDecoder(nn.Module):
    """Taming's `UpsampleDecoder`: per level num_res_blocks + 1
    ResnetBlocks, an Upsample between levels."""

    def __init__(self, in_channels, out_channels, ch, num_res_blocks, resolution,
                 ch_mult=(2, 2), dropout=0.0):
        super().__init__()
        self.dropout = dropout
        block_in = in_channels
        self.res_blocks = nn.ModuleList()
        self.upsample_blocks = nn.ModuleList()
        for i_level in range(len(ch_mult)):
            blocks = nn.ModuleList()
            block_out = ch * ch_mult[i_level]
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out, dropout=dropout))
                block_in = block_out
            self.res_blocks.append(blocks)
            if i_level != len(ch_mult) - 1:
                self.upsample_blocks.append(Upsample(block_in, with_conv=True))
        self.norm_out = Normalize(block_in)
        self.conv_out = Conv2d(block_in, out_channels, 3, padding=1)
        key_dropout_blocks(self)

    def init_weights(self, generator: torch.Generator):
        flax_defaults_(self, generator)

    def forward(self, x, train=False, generator=None):
        masks = training_masks(None, self.dropout, train, generator)
        for i_level, blocks in enumerate(self.res_blocks):
            for block in blocks:
                x = block(x, masks)
            if i_level < len(self.upsample_blocks):
                x = self.upsample_blocks[i_level](x)
        return self.conv_out(nonlinearity(self.norm_out(x)))
