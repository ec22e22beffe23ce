"""Triple-grain encoder, NCHW (counterpart of
`dynamicvectorquantization_tpu/nn/encoder_triple.py` `TripleGrainEncoder`).

The dual-grain encoder's down-stack and heads (`nn/encoder_dual.py`
`GrainEncoder`) with three taps: coarse at the last level (F = 32 at the
shipped 6-level `ch_mult`), median at level `len(ch_mult) - 2` and fine at
`len(ch_mult) - 3`, each before its downsample. The router's gate picks a
grain per coarse cell (`indices`: 0 coarse, 1 median, 2 fine); coarse
features are repeated 4x4 and median ones 2x2 and merged at the fine
resolution, with commitment weights 0.0625 / 0.25 / 1.0.

Unlike the dual-grain encoder, every training forward gates through the
straight-through Gumbel softmax (there is no `update_router` flag, JAX
`nn/encoder_triple.py:4-8`), and scales the merged map by the gate's max.
The noise comes as in `DualGrainEncoder`: `gumbel_noise`, else drawn from
`generator` on the images' device; so do the dropout masks and `remat`.

Reference state_dict names: those of the dual-grain encoder with a third
head `mid_median`, `norm_out_median`, `conv_out_median`.
"""
from __future__ import annotations

import torch

from .encoder_dual import GrainEncoder, repeat2d


class TripleGrainEncoder(GrainEncoder):
    grains = ("coarse", "median", "fine")

    def __init__(self, ch=128, ch_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2,
                 attn_resolutions=(16, 32), dropout=0.0, resamp_with_conv=True, in_channels=3,
                 resolution=256, z_channels=256, router_config=None,
                 coarse_commit_weight=0.0625, median_commit_weight=0.25,
                 fine_commit_weight=1.0, dtype=None):
        super().__init__(ch, ch_mult, num_res_blocks, attn_resolutions, dropout,
                         resamp_with_conv, in_channels, resolution, z_channels, router_config,
                         dtype)
        self.commit_weights = (coarse_commit_weight, median_commit_weight, fine_commit_weight)

    def gumbel_in_training(self) -> bool:
        return True

    def forward(self, x, x_entropy=None, train=False, gumbel_noise=None, generator=None,
                dropout=None, remat=False):
        """x: (B, C, H, W) with H = W = resolution; x_entropy: (B, Hc, Wc) for
        the entropy router; `gumbel_noise` (B, Hc, Wc, 3) f32 or `generator`
        for the Gumbel gate; `dropout` and `remat` as in `DualGrainEncoder`.
        Returns `h_triple` (B, z, Hf, Wf), `indices` (B, Hc, Wc),
        `codebook_mask` (B, Hf, Wf, 1) and `gate` (B, Hc, Wc, 3)."""
        feats = self.grain_features(x, train, dropout, generator, remat)
        gate, gumbel = self.gate(feats, x_entropy, train, gumbel_noise, generator)
        indices = torch.argmax(gate, dim=-1)  # (B, Hc, Wc)
        rep = repeat2d(indices, 4, 1, 2)  # (B, Hf, Wf)
        h = torch.where(rep[:, None] == 0, repeat2d(feats["coarse"], 4, 2, 3),
                        repeat2d(feats["median"], 2, 2, 3))
        h = torch.where(rep[:, None] == 2, feats["fine"], h)
        if gumbel:  # the gate's gradient path
            h = h * repeat2d(gate.amax(dim=-1), 4, 1, 2)[:, None]
        coarse_w, median_w, fine_w = self.commit_weights
        codebook_mask = torch.where(rep == 0, coarse_w,
                                    torch.where(rep == 1, median_w, fine_w))
        return {"h_triple": h, "indices": indices,
                "codebook_mask": codebook_mask.to(h.dtype)[..., None], "gate": gate}
