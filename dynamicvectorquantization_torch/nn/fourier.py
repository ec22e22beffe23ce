"""Fourier ("LFF") and learned 2D position embeddings for the DQ-VAE decoder,
NCHW (counterpart of `dynamicvectorquantization_tpu/nn/fourier.py`).

Module nesting follows the reference state_dict: `lff.ffm.conv` for the
Fourier features, `row_embed` / `col_embed` for the learned tables.

As in the JAX modules, the coordinate grid is f32 and the Fourier conv
computes in the promoted dtype of the grid and its weight (f32 even with a
bf16 weight); the learned tables are summed in their own dtype and added to
x in the promoted one.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .blocks import Conv2d


def coord_grid(h: int, w: int, device=None, dtype=torch.float32):
    """(1, 2, H, W) grid; channel 0 = x = linspace(-1, 1) along the width,
    channel 1 = y along the height."""
    xs = torch.linspace(-1.0, 1.0, w, device=device, dtype=dtype)
    ys = torch.linspace(-1.0, 1.0, h, device=device, dtype=dtype)
    return torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)])[None]


class _Holder(nn.Module):
    """Empty container that reproduces one level of reference nesting."""


class FourierPositionEmbedding(nn.Module):
    """x + sin(Conv1x1(coords))."""

    def __init__(self, coord_size: int, hidden_size: int):
        super().__init__()
        self.coord_size = coord_size
        self.lff = _Holder()
        self.lff.ffm = _Holder()
        self.lff.ffm.conv = Conv2d(2, hidden_size, 1)

    @torch.no_grad()
    def init_weights(self, generator):
        lim = math.sqrt(9.0 / 2.0)  # reference ConLinear is_first init
        self.lff.ffm.conv.weight.uniform_(-lim, lim, generator=generator)
        self.lff.ffm.conv.bias.zero_()

    def forward(self, x):
        conv = self.lff.ffm.conv
        coords = coord_grid(self.coord_size, self.coord_size, x.device)
        return x + torch.sin(conv(coords))


class PositionEmbedding2DLearned(nn.Module):
    """x + row_embed(i)[:, None] + col_embed(j)[None, :]."""

    def __init__(self, n_row: int, feats_dim: int, n_col=None):
        super().__init__()
        self.row_embed = nn.Embedding(n_row, feats_dim)
        self.col_embed = nn.Embedding(n_col or n_row, feats_dim)

    @torch.no_grad()
    def init_weights(self, generator):
        for emb in (self.row_embed, self.col_embed):
            # truncated normal(0, 1) on [-2, 2], by resampling out-of-range draws
            w = emb.weight
            w.normal_(0.0, 1.0, generator=generator)
            bad = w.abs() > 2.0
            while bad.any():
                w[bad] = torch.randn(int(bad.sum()), generator=generator,
                                     device=w.device, dtype=w.dtype)
                bad = w.abs() > 2.0

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        row = self.row_embed.weight[:h]
        col = self.col_embed.weight[:w]
        pos = row[:, None, :] + col[None, :, :]  # (H, W, C)
        return x + pos.permute(2, 0, 1)[None]
