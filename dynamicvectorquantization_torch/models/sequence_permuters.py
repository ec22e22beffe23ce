"""Fixed-length sequence orders for the legacy transformers (counterpart of
`dynamicvectorquantization_tpu/models/sequence_permuters.py`).

Identity, AlternateParsing (boustrophedon), ZCurve (Morton), Subsample
(hierarchical 2x2), SpiralOut / SpiralIn and Random (a fixed order from a
seed). Each maps a raster (B, H*W) code sequence into its order
(`forward`) and back (`reverse=True`). The orders are the JAX module's,
computed with numpy at construction; they are held in the reference's
buffers `forward_shuffle_idx` / `backward_shuffle_idx` (sequence[i] =
raster[forward_shuffle_idx[i]]), so a taming checkpoint's permuter loads
with `load_state_dict`; applying one is a gather.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


class _OrderPermuter(nn.Module):
    def __init__(self, order: np.ndarray):
        super().__init__()
        order = np.asarray(order, np.int64)
        inverse = np.empty_like(order)
        inverse[order] = np.arange(len(order))
        self.register_buffer("forward_shuffle_idx", torch.from_numpy(order))
        self.register_buffer("backward_shuffle_idx", torch.from_numpy(inverse))

    def forward(self, x, reverse: bool = False):
        idx = self.backward_shuffle_idx if reverse else self.forward_shuffle_idx
        return x.index_select(1, idx.to(x.device))


class Identity(nn.Module):
    def __init__(self, H=None, W=None, **_):
        super().__init__()

    def forward(self, x, reverse: bool = False):
        return x


class AlternateParsing(_OrderPermuter):
    """Even rows left to right, odd rows right to left."""

    def __init__(self, H=32, W=32, **_):
        grid = np.arange(H * W).reshape(H, W)
        grid[1::2] = grid[1::2, ::-1]
        super().__init__(grid.reshape(-1))


class ZCurve(_OrderPermuter):
    """Morton order: row bits in the odd, column bits in the even places."""

    def __init__(self, H=32, W=32, **_):
        def mortonify(i, j):
            m = 0
            for bit in range(16):
                m |= ((i >> bit) & 1) << (2 * bit + 1)
                m |= ((j >> bit) & 1) << (2 * bit)
            return m

        keys = np.array([mortonify(i, j) for i in range(H) for j in range(W)])
        super().__init__(np.argsort(keys))


class Subsample(_OrderPermuter):
    """Every 2^k-th position first, then each finer level's new ones."""

    def __init__(self, H=32, W=32, **_):
        seen = np.zeros((H, W), bool)
        order, step = [], min(H, W)
        while step >= 1:
            for i in range(0, H, step):
                for j in range(0, W, step):
                    if not seen[i, j]:
                        order.append(i * W + j)
                        seen[i, j] = True
            step //= 2
        super().__init__(np.array(order))


def _spiral_order(H, W, out: bool):
    """The edge inwards, clockwise from the top left; reversed (centre
    outwards) when `out`."""
    coords = []
    top, bottom, left, right = 0, H - 1, 0, W - 1
    while top <= bottom and left <= right:
        coords += [(top, j) for j in range(left, right + 1)]
        coords += [(i, right) for i in range(top + 1, bottom + 1)]
        if top < bottom:
            coords += [(bottom, j) for j in range(right - 1, left - 1, -1)]
        if left < right:
            coords += [(i, left) for i in range(bottom - 1, top, -1)]
        top, bottom, left, right = top + 1, bottom - 1, left + 1, right - 1
    order = np.array([i * W + j for i, j in coords])
    return order[::-1].copy() if out else order


class SpiralOut(_OrderPermuter):
    def __init__(self, H=32, W=32, **_):
        super().__init__(_spiral_order(H, W, out=True))


class SpiralIn(_OrderPermuter):
    def __init__(self, H=32, W=32, **_):
        super().__init__(_spiral_order(H, W, out=False))


class Random(_OrderPermuter):
    """A fixed order: numpy's `default_rng(seed).permutation`."""

    def __init__(self, H=32, W=32, seed=1, **_):
        super().__init__(np.random.default_rng(seed).permutation(H * W))
