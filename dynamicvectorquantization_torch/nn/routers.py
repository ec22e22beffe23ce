"""Dual-grain routers (counterpart of
`dynamicvectorquantization_tpu/nn/routers.py`).

  * `DualGrainFeatureRouter`: optional GroupNorm per grain, 2x2 average pool
    of the fine map, channel concat, a 1- or 2-layer (SiLU) linear gate.
  * `DualGrainFixedEntropyRouter`: a hard one-hot gate, fine where the patch
    entropy exceeds a threshold taken from a percentile table (JSON key
    `str(int(100 - ratio * 100))`) or given directly as `threshold`.

Feature maps come in NCHW; the gate goes out NHWC, (B, Hc, Wc, 2), grain 0
coarse, as in the JAX package. The routers have no dtype of their own: the
feature router computes in the promoted dtype of the features and its
parameters (f32 parameters take bf16 features to f32, as flax promotes
them), and the entropy router compares the f32 entropy. Reference state_dict names: `gate` (Linear)
or `gate.0` / `gate.2` (Sequential), `feature_norm_{fine,coarse}`.

The configs' `json_path` (`scripts/tools/thresholds/...`) is not in the
repository; a missing path falls back to the port's own copy of the table of
that name under `assets/thresholds/`.
"""
from __future__ import annotations

import json
import os

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import GroupNorm

THRESHOLDS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "assets", "thresholds")


def threshold_path(json_path: str) -> str:
    """`json_path` if it exists, else the bundled table of the same name."""
    if os.path.exists(json_path):
        return json_path
    return os.path.join(THRESHOLDS_DIR, os.path.basename(json_path))


def load_threshold(json_path: str, fine_ratio: float) -> float:
    with open(threshold_path(json_path), "r", encoding="utf-8") as f:
        table = json.load(f)
    return float(table[str(int(100 - fine_ratio * 100))])


def _maybe_norm(normalization_type: str, channels: int):
    if normalization_type == "none":
        return None
    if "group" in normalization_type:
        groups = int(normalization_type.split("-")[-1])
        return GroupNorm(groups, channels, eps=1e-6)
    raise NotImplementedError(normalization_type)


class DualGrainFeatureRouter(nn.Module):
    def __init__(self, num_channels: int, normalization_type: str = "none",
                 gate_type: str = "1layer-fc"):
        super().__init__()
        self.feature_norm_fine = _maybe_norm(normalization_type, num_channels)
        self.feature_norm_coarse = _maybe_norm(normalization_type, num_channels)
        if gate_type == "1layer-fc":
            self.gate = nn.Linear(num_channels * 2, 2)
        elif gate_type == "2layer-fc-SiLu":
            self.gate = nn.Sequential(nn.Linear(num_channels * 2, num_channels * 2), nn.SiLU(),
                                      nn.Linear(num_channels * 2, 2))
        else:
            raise NotImplementedError(gate_type)

    def forward(self, h_fine=None, h_coarse=None, entropy=None):
        if self.feature_norm_fine is not None:
            h_fine = self.feature_norm_fine(h_fine)
            h_coarse = self.feature_norm_coarse(h_coarse)
        feats = torch.cat([h_coarse, F.avg_pool2d(h_fine, 2, 2)], dim=1)
        weight = next(self.gate.parameters())
        feats = feats.to(torch.promote_types(feats.dtype, weight.dtype))
        return self.gate(feats.permute(0, 2, 3, 1))  # (B, Hc, Wc, 2)


class DualGrainFixedEntropyRouter(nn.Module):
    """`fine_grain_ratito` keeps the reference config schema's spelling."""

    def __init__(self, json_path: str = "", fine_grain_ratito=None, fine_grain_ratio=None,
                 threshold=None):
        super().__init__()
        if threshold is not None:
            self.threshold = float(threshold)
        else:
            ratio = fine_grain_ratito if fine_grain_ratito is not None else fine_grain_ratio
            self.threshold = load_threshold(json_path, ratio)

    def forward(self, h_fine=None, h_coarse=None, entropy=None):
        fine = (entropy > self.threshold).long()
        return torch.stack([1 - fine, fine], dim=-1)  # (B, Hc, Wc, 2) one-hot
