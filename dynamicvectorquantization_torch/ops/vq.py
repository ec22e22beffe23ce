"""The DQ-VAE's vector-quantizer codebook, decode half.

Counterpart of `dynamicvectorquantization_tpu/ops/vq.py` `VectorQuantizeEMA`
for the decode path: the codebook buffer of shape (K + 1, D), whose extra row
K is the stage-2 padding code and stays zero, and `get_codebook_entry`.
Nearest-code search (TPU kernels #1/#2) and the EMA update come with the
stage-1 slices (ROADMAP.md).

The buffer lives at `codebook.weight`, the reference's state_dict name
(`quantize.codebook.weight` inside the DQ-VAE).
"""
from __future__ import annotations

import torch
from torch import nn


class _Codebook(nn.Module):
    def __init__(self, rows: int, dim: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros(rows, dim))


class VectorQuantizeEMA(nn.Module):
    def __init__(self, codebook_size=1024, codebook_dim=256, accept_image_fmap=True,
                 commitment_beta=0.25, decay=0.99, restart_unused_codes=True,
                 channel_last=True, ema=True, eps=1e-5, use_pallas=None):
        super().__init__()
        # training-side settings are kept for config compatibility; the
        # decode half reads only the codebook
        self.codebook_size = codebook_size
        self.codebook_dim = codebook_dim
        self.codebook = _Codebook(codebook_size + 1, codebook_dim)

    @torch.no_grad()
    def init_codebook(self, generator: torch.Generator):
        """Reference init: uniform(-1/K, 1/K) for the K real codes; the
        padding row K stays zero."""
        k = self.codebook_size
        w = self.codebook.weight
        w.uniform_(-1.0 / k, 1.0 / k, generator=generator)
        w[k].zero_()

    def get_codebook_entry(self, indices):
        """Embed code indices (the padding code K included): (B, ...) -> (B, ..., D)."""
        return self.codebook.weight[indices]
