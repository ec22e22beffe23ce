"""3x3 stride-2 convolution with the VQGAN Downsample's asymmetric zero pad
(0, 1), (0, 1), NCHW (counterpart of `dynamicvectorquantization_tpu/ops/
downsample_pallas.py` `strided_conv3x3_down`).

`strided_conv3x3_down` launches the CUDA kernel `csrc/strided_conv_down.cu`
for CUDA tensors and runs `strided_conv3x3_down_plain` for CPU tensors. The
TPU kernel runs bf16 only; the port's encoder runs f32, so the kernel takes
f32 (FMA units, no TF32) and a CUDA tensor of another dtype raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib


def strided_conv3x3_down_plain(x, weight, bias):
    """Plain PyTorch version: pad (left 0, right 1, top 0, bottom 1), then a
    VALID 3x3 stride-2 convolution. x: (B, C, H, W), weight: (K, C, 3, 3)."""
    return F.conv2d(F.pad(x, (0, 1, 0, 1)), weight, bias, stride=2)


def strided_conv3x3_down(x, weight, bias):
    """(B, C, H, W) -> (B, K, (H - 2) // 2 + 1, (W - 2) // 2 + 1).
    `strided_conv3x3_down.launches` counts kernel launches."""
    tensors = (x, weight, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return strided_conv3x3_down_plain(x, weight, bias)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("strided_conv3x3_down: all inputs must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"strided_conv3x3_down: f32 inputs expected, got "
                        f"{[t.dtype for t in tensors]}")
    if x.dim() != 4 or x.shape[2] < 2 or x.shape[3] < 2:
        raise ValueError(f"strided_conv3x3_down: (B, C, H>=2, W>=2) input expected, "
                         f"got {tuple(x.shape)}")
    b, c, h, w = x.shape
    k = weight.shape[0]
    if tuple(weight.shape) != (k, c, 3, 3) or tuple(bias.shape) != (k,):
        raise ValueError(f"strided_conv3x3_down: weight (K, {c}, 3, 3) and bias (K,) expected, "
                         f"got {tuple(weight.shape)} and {tuple(bias.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("strided_conv3x3_down: inputs must be contiguous")
    out = torch.empty((b, k, (h - 2) // 2 + 1, (w - 2) // 2 + 1), dtype=x.dtype, device=x.device)
    err = cuda_lib.lib().dqvq_strided_conv_down(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c, h, w, k,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(err, "strided_conv3x3_down")
    strided_conv3x3_down.launches += 1
    return out


strided_conv3x3_down.launches = 0
