"""DQ-VAE decoder with position injection on the quantized latent, NCHW
(counterpart of `dynamicvectorquantization_tpu/nn/decoder_positional.py`).

`position_type`: "fourier", "learned", "fourier+learned" (the shipped
configs), "learned-relative" (one `window_size`^2 learned table added to
every `window_size` x `window_size` window of the latent) and "none".
Reference state_dict names: `conv_in`, `mid.{block_1,attn_1,block_2}`,
`up.{i}.block.{j}`, `up.{i}.attn.{j}`, `up.{i}.upsample.conv`, `norm_out`,
`conv_out`, `position_bias_fourier.lff.ffm.conv`,
`position_bias_learned.{row,col}_embed` (window-sized for
"learned-relative"). `give_pre_end` returns the up-stack's output, before
`norm_out` and `conv_out`.

`dtype` (None, or bf16 for the DQ-VAE's compute dtype) goes to `conv_in`,
the mid and up blocks and the upsamples, as in the JAX module; the position
embeddings, `norm_out` and `conv_out` have none and compute in the promoted
dtype, so with f32 parameters the position adds, the last norm and the
output are f32 (see `nn/blocks.py`).

`forward(..., return_pre_out=True)` also returns the activation that feeds
`conv_out` (`swish(norm_out(h))`): the stage-1 trainer takes the gradients of
the reconstruction and generator losses with respect to `conv_out.weight`
through `conv(pre_out.detach(), W)` for the adaptive discriminator weight,
without running the decoder again. ResnetBlock dropout in training takes the
caller's `dropout` masks (`nn/blocks.py` `DropoutMasks`). `remat` makes each
ResnetBlock, AttnBlock and Upsample, and the last norm and swish, one
checkpointed segment (`nn/blocks.py` `segment`).
"""
from __future__ import annotations

from torch import nn

from .blocks import (AttnBlock, Conv2d, Normalize, ResnetBlock, Upsample, as_dtype,
                     key_dropout_blocks, nonlinearity, segment, training_masks)
from .fourier import FourierPositionEmbedding, PositionEmbedding2DLearned


POSITION_TYPES = ("fourier", "learned", "fourier+learned", "learned-relative", "none")


class PositionalDecoder(nn.Module):
    def __init__(self, ch=128, in_ch=256, out_ch=3, ch_mult=(1, 1, 2, 2), num_res_blocks=2,
                 resolution=256, attn_resolutions=(32,), dropout=0.0, resamp_with_conv=True,
                 give_pre_end=False, latent_size=32, window_size=2,
                 position_type="fourier+learned", dtype=None):
        super().__init__()
        dtype = as_dtype(dtype)
        if position_type not in POSITION_TYPES:
            raise NotImplementedError(f"position_type {position_type!r}")
        self.position_type = position_type
        self.give_pre_end = give_pre_end
        self.dropout = dropout
        self.window_size = window_size
        if "fourier" in position_type:
            self.position_bias_fourier = FourierPositionEmbedding(latent_size, in_ch)
        if "learned" in position_type:
            n = window_size if position_type == "learned-relative" else latent_size
            self.position_bias_learned = PositionEmbedding2DLearned(n, in_ch)

        num_res = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (num_res - 1)
        self.conv_in = Conv2d(in_ch, block_in, 3, padding=1, compute_dtype=dtype)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, dropout=dropout, compute_dtype=dtype)
        self.mid.attn_1 = AttnBlock(block_in, compute_dtype=dtype)
        self.mid.block_2 = ResnetBlock(block_in, dropout=dropout, compute_dtype=dtype)

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

    def add_positions(self, h):
        """The latent (B, C, H, W) with its position embeddings added."""
        if "fourier" in self.position_type:
            h = self.position_bias_fourier(h)
        if self.position_type == "learned-relative":
            b, c, hh, ww = h.shape
            w = self.window_size
            windows = h.reshape(b, c, hh // w, w, ww // w, w)
            return self.position_bias_learned.add_to_windows(windows).reshape(b, c, hh, ww)
        if "learned" in self.position_type:
            h = self.position_bias_learned(h)
        return h

    def _head(self, h):
        return nonlinearity(self.norm_out(h))

    def forward(self, h, train=False, return_pre_out=False, dropout=None, remat=False):
        """`dropout`: the `DropoutMasks` of a training forward when the
        decoder has dropout; `remat` checkpoints the blocks."""
        masks = training_masks(dropout, self.dropout, train)
        h = self.conv_in(self.add_positions(h))
        h = segment(remat, self.mid.block_1, h, masks)
        h = segment(remat, self.mid.attn_1, h)
        h = segment(remat, self.mid.block_2, h, masks)
        for level in reversed(self.up):
            for i_block, block in enumerate(level.block):
                h = segment(remat, block, h, masks)
                if len(level.attn):
                    h = segment(remat, level.attn[i_block], h)
            if hasattr(level, "upsample"):
                h = segment(remat, level.upsample, h)
        if self.give_pre_end:
            return h
        h = segment(remat, self._head, h)
        out = self.conv_out(h)
        return (out, h) if return_pre_out else out
