"""Dtype-gated GELU (counterpart of `dynamicvectorquantization_tpu/nn/
activations.py`).

bf16 inputs take the tanh-form GELU written with a sigmoid,
``x * sigmoid(2*sqrt(2/pi) * (x + 0.044715 x^3))``; every other dtype takes
the exact erf GELU of the reference's `nn.GELU()`. The served transformer
runs in bf16, so both forms are on the sampling path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# 2 * sqrt(2 / pi)
_TWO_SQRT_2_OVER_PI = 1.5957691216057308


def gelu(x):
    if x.dtype == torch.bfloat16:
        return x * torch.sigmoid(_TWO_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x)))
    return F.gelu(x)


class GELU(nn.Module):
    def forward(self, x):
        return gelu(x)
