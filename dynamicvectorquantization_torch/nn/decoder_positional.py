"""DQ-VAE decoder with position injection on the quantized latent, NCHW
(counterpart of `dynamicvectorquantization_tpu/nn/decoder_positional.py`).

Supported `position_type`: "fourier+learned" (the shipped configs) and
"none"; the others come with a later slice. Reference state_dict names:
`conv_in`, `mid.{block_1,attn_1,block_2}`, `up.{i}.block.{j}`,
`up.{i}.attn.{j}`, `up.{i}.upsample.conv`, `norm_out`, `conv_out`,
`position_bias_fourier.lff.ffm.conv`, `position_bias_learned.{row,col}_embed`.

`forward(..., return_pre_out=True)` also returns the activation that feeds
`conv_out` (`swish(norm_out(h))`): the stage-1 trainer takes the gradients of
the reconstruction and generator losses with respect to `conv_out.weight`
through `conv(pre_out.detach(), W)` for the adaptive discriminator weight,
without running the decoder again. ResnetBlock dropout in training is not
ported and raises.
"""
from __future__ import annotations

from torch import nn

from .blocks import AttnBlock, Normalize, ResnetBlock, Upsample, nonlinearity
from .fourier import FourierPositionEmbedding, PositionEmbedding2DLearned


class PositionalDecoder(nn.Module):
    def __init__(self, ch=128, in_ch=256, out_ch=3, ch_mult=(1, 1, 2, 2), num_res_blocks=2,
                 resolution=256, attn_resolutions=(32,), dropout=0.0, resamp_with_conv=True,
                 give_pre_end=False, latent_size=32, window_size=2,
                 position_type="fourier+learned"):
        super().__init__()
        if position_type not in ("fourier+learned", "none"):
            raise NotImplementedError(f"position_type {position_type!r} is not ported yet")
        if give_pre_end:
            raise NotImplementedError("give_pre_end is not ported")
        self.position_type = position_type
        self.dropout = dropout
        if position_type == "fourier+learned":
            self.position_bias_fourier = FourierPositionEmbedding(latent_size, in_ch)
            self.position_bias_learned = PositionEmbedding2DLearned(latent_size, in_ch)

        num_res = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (num_res - 1)
        self.conv_in = nn.Conv2d(in_ch, block_in, 3, padding=1)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, dropout=dropout)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, dropout=dropout)

        levels = []
        for i_level in reversed(range(num_res)):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            block_out = ch * ch_mult[i_level]
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out, dropout=dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != 0:
                level.upsample = Upsample(block_in, resamp_with_conv)
                curr_res *= 2
            levels.insert(0, level)  # up[i_level], as in the reference
        self.up = nn.ModuleList(levels)
        self.norm_out = Normalize(block_in)
        self.conv_out = nn.Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, h, train=False, return_pre_out=False):
        if train and self.dropout > 0:
            raise NotImplementedError("ResnetBlock dropout in training is not ported "
                                      "(0.0 in every shipped stage-1 config)")
        if self.position_type == "fourier+learned":
            h = self.position_bias_learned(self.position_bias_fourier(h))
        h = self.conv_in(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        h = nonlinearity(self.norm_out(h))
        out = self.conv_out(h)
        return (out, h) if return_pre_out else out
