"""3x3 stride-2 convolution with the VQGAN Downsample's asymmetric zero pad
(0, 1), (0, 1), NCHW (counterpart of `dynamicvectorquantization_tpu/ops/
downsample_pallas.py` `strided_conv3x3_down`).

`strided_conv3x3_down` launches the CUDA kernel `csrc/strided_conv_down.cu`
for CUDA tensors and runs `strided_conv3x3_down_plain` for CPU tensors. The
kernel takes f32 (the f32 encoder: FMA units, no TF32) or bf16 (the DQ-VAE
in bf16, the TPU kernel's own dtype), x, weight and bias all of one dtype; a
CUDA tensor of another dtype raises. In bf16 it computes what the TPU kernel
computes: the products of the bf16 inputs summed in f32, the bf16 bias added
to that sum, one rounding to bf16 at the store. (The JAX package's XLA route
rounds twice, after the convolution and after the bias add; the port
follows the kernel.)

`strided_conv3x3_down` is differentiable. Its forward is the kernel; its
backward is the library's convolution gradients on the padded input
(`torch.nn.grad.conv2d_input` / `conv2d_weight` in the inputs' dtype, so
cuDNN's bf16 gradients for bf16; the bias gradient a sum),
because the JAX package computes this backward outside any Pallas kernel too,
as the `jax.vjp` of XLA's native convolution (`_s2_bwd` there). On CPU
tensors autograd differentiates the plain version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def strided_conv3x3_down_plain(x, weight, bias):
    """Plain PyTorch version: pad (left 0, right 1, top 0, bottom 1), then a
    VALID 3x3 stride-2 convolution. x: (B, C, H, W), weight: (K, C, 3, 3).
    bf16 inputs: the f32 convolution of their f32 casts plus the bias, then
    one rounding to bf16."""
    if x.dtype == torch.bfloat16:
        y = F.conv2d(F.pad(x.float(), (0, 1, 0, 1)), weight.float(), bias.float(), stride=2)
        return y.to(torch.bfloat16)
    return F.conv2d(F.pad(x, (0, 1, 0, 1)), weight, bias, stride=2)


class _StridedConvDown(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return _launch(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            h, w = x.shape[2:]
            padded = (x.shape[0], x.shape[1], h + 1, w + 1)
            dx = torch.nn.grad.conv2d_input(padded, weight, dy, stride=2)[:, :, :h, :w]
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(F.pad(x, (0, 1, 0, 1)), weight.shape, dy, stride=2)
        if ctx.needs_input_grad[2]:
            db = dy.sum(dim=(0, 2, 3))
        return dx, dw, db


def strided_conv3x3_down(x, weight, bias):
    """(B, C, H, W) -> (B, K, (H - 2) // 2 + 1, (W - 2) // 2 + 1),
    differentiable. `strided_conv3x3_down.launches` counts kernel launches,
    `.bf16_launches` those of them in bf16."""
    if all(t.device.type == "cpu" for t in (x, weight, bias)):
        return strided_conv3x3_down_plain(x, weight, bias)
    return _StridedConvDown.apply(x, weight, bias)


def _launch(x, weight, bias):
    tensors = (x, weight, bias)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("strided_conv3x3_down: all inputs must be on one CUDA device")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"strided_conv3x3_down: f32 or bf16 inputs of one dtype expected, "
                        f"got {[t.dtype for t in tensors]}")
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
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(err, "strided_conv3x3_down")
    strided_conv3x3_down.launches += 1
    strided_conv3x3_down.bf16_launches += x.dtype == torch.bfloat16
    return out


strided_conv3x3_down.launches = 0
strided_conv3x3_down.bf16_launches = 0  # those of `launches` in bf16
