"""Dual-grain encoder, NCHW (counterpart of
`dynamicvectorquantization_tpu/nn/encoder_dual.py` `DualGrainEncoder`).

A shared conv-ResNet down-stack (`down_stack`, the JAX package's
`DownStack`) taps the fine features after the blocks of level
`len(ch_mult) - 2`, before its downsample, and the coarse features at the
last level; each goes through its own mid Res-Attn-Res, GroupNorm, swish and
3x3 out conv (`grain_head`, the JAX package's `GrainHead`). The router's gate
picks a grain per coarse cell (`indices = argmax(gate)`, 0 coarse / 1 fine);
the coarse features are repeated 2x2 and merged with the fine ones at the
fine resolution, and the commitment weight is 0.25 on coarse and 1.0 on fine
positions.

Reference state_dict names: `conv_in`, `down.{i}.{block|attn}.{j}`,
`down.{i}.downsample.conv`, `mid_{coarse|fine}.{block_1,attn_1,block_2}`,
`norm_out_{coarse|fine}`, `conv_out_{coarse|fine}`, `router.*`.

`dtype` (None, or bf16 for the DQ-VAE's compute dtype) goes to every conv,
norm, ResnetBlock, AttnBlock and Downsample of the stack and of both grain
heads, `conv_out` included; the router has none (see `nn/blocks.py` for the
dtype rules).

Differentiable end to end; `train=True` is the training forward of a
router that takes no gradient (`update_router: false`, the shipped
fixed-entropy config). The router's Gumbel straight-through gate
(`train=True` with `update_router`) and ResnetBlock dropout in training are
not ported and raise (ROADMAP.md).
"""
from __future__ import annotations

import torch
from torch import nn

from ..utils.instantiate import instantiate_from_config
from .blocks import (AttnBlock, Conv2d, Downsample, Normalize, ResnetBlock, as_dtype,
                     nonlinearity)


def repeat2d(x, factor: int, h_dim: int, w_dim: int):
    """Nearest-neighbour repeat of the two spatial dims."""
    return x.repeat_interleave(factor, dim=h_dim).repeat_interleave(factor, dim=w_dim)


def _mid(block_in: int, dropout: float, dtype=None) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = ResnetBlock(block_in, dropout=dropout, compute_dtype=dtype)
    mid.attn_1 = AttnBlock(block_in, compute_dtype=dtype)
    mid.block_2 = ResnetBlock(block_in, dropout=dropout, compute_dtype=dtype)
    return mid


class DualGrainEncoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2,
                 attn_resolutions=(16, 32), dropout=0.0, resamp_with_conv=True, in_channels=3,
                 resolution=256, z_channels=256, router_config=None, update_router=True,
                 coarse_commit_weight=0.25, fine_commit_weight=1.0, dtype=None):
        super().__init__()
        dtype = as_dtype(dtype)
        self.resolution = resolution
        self.dropout = dropout
        self.update_router = update_router
        self.coarse_commit_weight = coarse_commit_weight
        self.fine_commit_weight = fine_commit_weight
        self.num_resolutions = len(ch_mult)
        in_ch_mult = (1,) + tuple(ch_mult)
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1, compute_dtype=dtype)
        curr_res = resolution
        levels = []
        for i_level in range(self.num_resolutions):
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
            if i_level != self.num_resolutions - 1:
                level.downsample = Downsample(block_in, resamp_with_conv, compute_dtype=dtype)
                curr_res //= 2
            levels.append(level)
        self.down = nn.ModuleList(levels)

        block_in = ch * ch_mult[-1]
        block_in_fine = block_in // (ch_mult[-1] // ch_mult[-2])
        self.mid_coarse = _mid(block_in, dropout, dtype)
        self.norm_out_coarse = Normalize(block_in, dtype)
        self.conv_out_coarse = Conv2d(block_in, z_channels, 3, padding=1, compute_dtype=dtype)
        self.mid_fine = _mid(block_in_fine, dropout, dtype)
        self.norm_out_fine = Normalize(block_in_fine, dtype)
        self.conv_out_fine = Conv2d(block_in_fine, z_channels, 3, padding=1, compute_dtype=dtype)
        self.router = instantiate_from_config(router_config)

    def down_stack(self, x):
        """The shared down-stack: {level: features after its blocks, before
        its downsample} and "final"."""
        h = self.conv_in(x)
        taps = {}
        for i_level, level in enumerate(self.down):
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i_block](h)
            taps[i_level] = h
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        taps["final"] = h
        return taps

    @staticmethod
    def grain_head(mid, norm_out, conv_out, h):
        h = mid.block_2(mid.attn_1(mid.block_1(h)))
        return conv_out(nonlinearity(norm_out(h)))

    def forward(self, x, x_entropy=None, train=False):
        """x: (B, C, H, W) with H = W = resolution; x_entropy: (B, Hc, Wc) for
        the entropy router. Returns `h_dual` (B, z, Hf, Wf), `indices`
        (B, Hc, Wc), `codebook_mask` (B, Hf, Wf, 1) and `gate` (B, Hc, Wc, 2)."""
        if x.shape[2] != self.resolution or x.shape[3] != self.resolution:
            raise ValueError(f"DualGrainEncoder: {self.resolution}^2 input expected, "
                             f"got {tuple(x.shape)}")
        if train and self.update_router:
            raise NotImplementedError(
                "the Gumbel router gate (train=True with update_router) is not ported "
                "(ROADMAP.md): train a config with update_router: false")
        if train and self.dropout > 0:
            raise NotImplementedError("ResnetBlock dropout in training is not ported "
                                      "(0.0 in every shipped stage-1 config)")
        taps = self.down_stack(x)
        h_coarse = self.grain_head(self.mid_coarse, self.norm_out_coarse, self.conv_out_coarse,
                                   taps["final"])
        h_fine = self.grain_head(self.mid_fine, self.norm_out_fine, self.conv_out_fine,
                                 taps[self.num_resolutions - 2])
        gate = self.router(h_fine=h_fine, h_coarse=h_coarse, entropy=x_entropy)
        indices = torch.argmax(gate, dim=-1)  # (B, Hc, Wc)
        coarse_rep = repeat2d(indices == 0, 2, 1, 2)  # (B, Hf, Wf)
        h_dual = torch.where(coarse_rep[:, None], repeat2d(h_coarse, 2, 2, 3), h_fine)
        codebook_mask = torch.where(coarse_rep, self.coarse_commit_weight,
                                    self.fine_commit_weight).to(h_dual.dtype)[..., None]
        return {"h_dual": h_dual, "indices": indices, "codebook_mask": codebook_mask,
                "gate": gate}
