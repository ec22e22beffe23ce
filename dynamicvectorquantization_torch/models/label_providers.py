"""Condition-prefix provider for unconditional stage 2 (counterpart of
`dynamicvectorquantization_tpu/models/label_providers.py`
`PositionAwareSOSProvider`): each stream is prefixed with its SOS token."""
from __future__ import annotations

import torch


class PositionAwareSOSProvider:
    def __init__(self, coarse_sos, coarse_pos_sos, fine_sos=None, fine_pos_sos=None,
                 coarse_seg_sos=None, fine_seg_sos=None):
        self.coarse_sos = coarse_sos
        self.fine_sos = fine_sos
        self.coarse_pos_sos = coarse_pos_sos
        self.fine_pos_sos = fine_pos_sos
        self.activate_seg = coarse_seg_sos is not None
        self.coarse_seg_sos = coarse_seg_sos
        self.fine_seg_sos = fine_seg_sos

    def encode(self, batch: int, device=None):
        """Six (batch, 1) int64 prefixes (None where a stream has no SOS):
        coarse/fine content, coarse/fine position, coarse/fine segment."""
        def full(v):
            if v is None:
                return None
            return torch.full((batch, 1), int(v), dtype=torch.long, device=device)

        segs = (full(self.coarse_seg_sos), full(self.fine_seg_sos)) \
            if self.activate_seg else (None, None)
        return (full(self.coarse_sos), full(self.fine_sos), full(self.coarse_pos_sos),
                full(self.fine_pos_sos)) + segs
