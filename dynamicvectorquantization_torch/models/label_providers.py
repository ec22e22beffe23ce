"""Condition-prefix providers for stage 2 (counterpart of
`dynamicvectorquantization_tpu/models/label_providers.py`).

Unconditional models prefix each stream with its SOS token
(`PositionAwareSOSProvider`). Class-conditional models use `label +
threshold`, which lies in the top range of each vocabulary, as the content
prefix and (`ClassAwareSOSProvider`) as the position prefixes too, or
(`ClassForContentOnlyPositionAwareSOSProvider`) with plain SOS positions.

Each `encode` returns six (B, 1) int64 prefixes, None where a stream has no
prefix: coarse / fine content, coarse / fine position, coarse / fine segment.
The class providers take (B,) or (B, 1) integer labels, or a batch size,
which means label 0 for every row (the JAX sampler, server and scripts pass
zeros).
"""
from __future__ import annotations

import torch


def _labels(c, device):
    """(B, 1) int64 labels from labels or a batch size (label 0)."""
    if not torch.is_tensor(c) and not hasattr(c, "__len__"):  # a batch size
        return torch.zeros((int(c), 1), dtype=torch.long, device=device)
    c = torch.as_tensor(c)
    return c.to(device=device if device is not None else c.device,
                dtype=torch.long).reshape(-1, 1)


def _segments(provider, ref):
    if not provider.activate_seg:
        return None, None
    return (torch.full_like(ref, int(provider.coarse_seg_sos)),
            torch.full_like(ref, int(provider.fine_seg_sos)))


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
        """The six prefixes for `batch` rows."""
        def full(v):
            if v is None:
                return None
            return torch.full((batch, 1), int(v), dtype=torch.long, device=device)

        segs = (full(self.coarse_seg_sos), full(self.fine_seg_sos)) \
            if self.activate_seg else (None, None)
        return (full(self.coarse_sos), full(self.fine_sos), full(self.coarse_pos_sos),
                full(self.fine_pos_sos)) + segs


class ClassAwareSOSProvider:
    """`label + threshold` as the content and the position prefixes. As in
    the JAX provider, the fine prefixes exist only when `fine_seg_sos` is
    set."""

    def __init__(self, n_classes, threshold_content, threshold_coarse_position,
                 threshold_fine_position, coarse_seg_sos=None, fine_seg_sos=None):
        self.n_classes = n_classes
        self.threshold_content = threshold_content
        self.threshold_coarse_position = threshold_coarse_position
        self.threshold_fine_position = threshold_fine_position
        self.activate_seg = coarse_seg_sos is not None
        self.coarse_seg_sos = coarse_seg_sos
        self.fine_seg_sos = fine_seg_sos

    def encode(self, c, device=None):
        x = _labels(c, device)
        fine = self.fine_seg_sos is not None
        return (x + self.threshold_content,
                x + self.threshold_content if fine else None,
                x + self.threshold_coarse_position,
                x + self.threshold_fine_position if fine else None) + _segments(self, x)


class ClassForContentOnlyPositionAwareSOSProvider:
    """`label + threshold` as the content prefix, plain SOS positions. As in
    the JAX provider, the fine content prefix exists only when
    `fine_pos_sos` is set."""

    def __init__(self, n_classes, threshold, coarse_pos_sos, fine_pos_sos=None,
                 coarse_seg_sos=None, fine_seg_sos=None):
        self.n_classes = n_classes
        self.threshold = threshold
        self.coarse_pos_sos = coarse_pos_sos
        self.fine_pos_sos = fine_pos_sos
        self.activate_seg = coarse_seg_sos is not None
        self.coarse_seg_sos = coarse_seg_sos
        self.fine_seg_sos = fine_seg_sos

    def encode(self, c, device=None):
        x = _labels(c, device)
        fine = self.fine_pos_sos is not None
        return (x + self.threshold,
                x + self.threshold if fine else None,
                torch.full_like(x, int(self.coarse_pos_sos)),
                torch.full_like(x, int(self.fine_pos_sos)) if fine else None) \
            + _segments(self, x)
