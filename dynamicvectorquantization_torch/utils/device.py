"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller names another device. Without a
card and without an explicit device they raise: nothing drifts to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain-PyTorch path on the CPU"
        )
    return torch.device("cuda")
