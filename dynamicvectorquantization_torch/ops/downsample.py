"""3x3 stride-2 convolution with the VQGAN Downsample's asymmetric zero pad
(0, 1), (0, 1), NCHW (counterpart of `dynamicvectorquantization_tpu/ops/
downsample_pallas.py` `strided_conv3x3_down`).

`strided_conv3x3_down` launches a CUDA kernel for CUDA tensors and runs
`strided_conv3x3_down_plain` for CPU tensors. x, weight and bias are all f32
or all bf16; a CUDA tensor of another dtype raises. Three kernels, chosen by
dtype and channel count (`uses_tensor_cores`, `uses_blocked_f32`):
  * bf16 with C a multiple of 8 (every Downsample of the shipped configs):
    `csrc/strided_conv_down_tc.cu`, an implicit GEMM on the tensor cores that
    reads the weights packed by `pack_weight` (to [tap][K][C], with each
    output channel's sum of squares), and sums the outputs whose terms cancel
    (`CANCELLATION`) again in the FMA kernel's order, the plain version's;
  * f32 with C a multiple of 4 (every f32 Downsample of the shipped configs:
    the f32 encoder, FMA units, no TF32): `csrc/strided_conv_down_f32.cu`, a
    blocked implicit GEMM that reads the weights packed by `pack_weight_f32`
    (to [tap][C][K]) and sums each output in the FMA kernel's order;
  * f32 with another C, and bf16 with C not a multiple of 8:
    `csrc/strided_conv_down.cu`.
In bf16 both compute what the TPU kernel computes: the products of the bf16
inputs summed in f32, the bf16 bias added to that sum, one rounding to bf16
at the store. (The JAX package's XLA route rounds twice, after the
convolution and after the bias add; the port follows the kernel.)

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


# An output the tensor-core kernel sums to |y| < CANCELLATION * ||w_k|| ||x
# window|| (a bound on S = sum |w x|) is summed again in the FMA kernel's order:
# there an ulp of y may be less than what two f32 summation orders differ by.
CANCELLATION = 2.0 ** -11


def uses_tensor_cores(x) -> bool:
    """Whether `strided_conv3x3_down` sends x to the tensor-core kernel: bf16
    with C a multiple of 8 (its weight rows are copied 16 bytes at a time)."""
    return x.dtype == torch.bfloat16 and x.shape[1] % 8 == 0


def uses_blocked_f32(x, weight) -> bool:
    """Whether `strided_conv3x3_down` sends x to the blocked f32 kernel: f32
    with C a multiple of 4. Its pack reads each output channel's 9 C weights
    16 bytes at a time, so this raises on a weight tensor that does not start
    on a 16-byte boundary instead of sending it to the FMA kernel."""
    if x.dtype != torch.float32 or x.shape[1] % 4:
        return False
    if weight.data_ptr() % 16:
        raise ValueError("strided_conv3x3_down: f32 weights with C % 4 == 0 must start on a "
                         "16-byte boundary")
    return True


def pack_weight_f32_plain(weight):
    """Plain version of the blocked f32 kernel's weight pack: (K, C, 3, 3) ->
    (9, C, KP), tap 3 u + v major, the output channel innermost, KP = K
    rounded up to a multiple of 4 with zeros past K."""
    k, c = weight.shape[:2]
    packed = weight.new_zeros((9, c, -(-k // 4) * 4))
    packed[:, :, :k] = weight.permute(2, 3, 1, 0).reshape(9, c, k)
    return packed


def pack_weight_f32(weight):
    """`pack_weight_f32_plain` for CPU tensors; on the card the pack kernel of
    `csrc/strided_conv_down_f32.cu` (f32 weights, C a multiple of 4, on a
    16-byte boundary)."""
    if weight.device.type == "cpu":
        return pack_weight_f32_plain(weight)
    if (weight.dtype != torch.float32 or weight.dim() != 4 or not weight.is_contiguous()
            or weight.shape[1] % 4 or weight.data_ptr() % 16):
        raise ValueError(f"pack_weight_f32: contiguous f32 (K, C, 3, 3) weights with C % 4 == 0 "
                         f"on a 16-byte boundary expected, got {weight.dtype} "
                         f"{tuple(weight.shape)}")
    k, c = weight.shape[:2]
    kp = -(-k // 4) * 4
    packed = torch.empty((9, c, kp), dtype=weight.dtype, device=weight.device)
    err = cuda_lib.lib().dqvq_strided_conv_down_f32_pack(
        weight.data_ptr(), packed.data_ptr(), c, k, kp,
        torch.cuda.current_stream(weight.device).cuda_stream)
    cuda_lib.check(err, "pack_weight_f32")
    return packed


def pack_weight_plain(weight):
    """Plain version of the tensor-core kernel's weight pack: (K, C, 3, 3) ->
    (9, K, C), tap 3 u + v major and the input channel innermost, the layout
    the kernel reads its weights in; and each output channel's sum of squared
    weights in f32."""
    k, c = weight.shape[:2]
    packed = weight.permute(2, 3, 0, 1).reshape(9, k, c).contiguous()
    return packed, weight.float().square().sum(dim=(1, 2, 3))


def pack_weight(weight):
    """`pack_weight_plain` for CPU tensors; on the card the pack kernel of
    `csrc/strided_conv_down_tc.cu` (bf16 weights)."""
    if weight.device.type == "cpu":
        return pack_weight_plain(weight)
    if weight.dtype != torch.bfloat16 or weight.dim() != 4 or not weight.is_contiguous():
        raise ValueError(f"pack_weight: contiguous bf16 (K, C, 3, 3) weights expected, got "
                         f"{weight.dtype} {tuple(weight.shape)}")
    k, c = weight.shape[:2]
    packed = torch.empty((9, k, c), dtype=weight.dtype, device=weight.device)
    sq = torch.empty((k,), dtype=torch.float32, device=weight.device)
    err = cuda_lib.lib().dqvq_strided_conv_down_tc_pack(
        weight.data_ptr(), packed.data_ptr(), sq.data_ptr(), c, k,
        torch.cuda.current_stream(weight.device).cuda_stream)
    cuda_lib.check(err, "pack_weight")
    return packed, sq


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
    `.bf16_launches` those of them in bf16, `.tc_launches` those on the
    tensor cores, `.f32_blocked_launches` those on the blocked f32 kernel
    (each with its weight pack)."""
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tc = uses_tensor_cores(x)
    blocked = uses_blocked_f32(x, weight)
    if tc:
        packed, sq = pack_weight(weight)
        err = cuda_lib.lib().dqvq_strided_conv_down_tc(
            x.data_ptr(), packed.data_ptr(), sq.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c,
            h, w, k, CANCELLATION, stream)
    elif blocked:
        packed = pack_weight_f32(weight)
        err = cuda_lib.lib().dqvq_strided_conv_down_f32(
            x.data_ptr(), packed.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c, h, w, k,
            packed.shape[2], stream)
    else:
        err = cuda_lib.lib().dqvq_strided_conv_down(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c, h, w, k,
            _DTYPE_CODE[x.dtype], stream)
    cuda_lib.check(err, "strided_conv3x3_down")
    strided_conv3x3_down.launches += 1
    strided_conv3x3_down.bf16_launches += x.dtype == torch.bfloat16
    strided_conv3x3_down.tc_launches += tc
    strided_conv3x3_down.f32_blocked_launches += blocked
    return out


strided_conv3x3_down.launches = 0
strided_conv3x3_down.bf16_launches = 0  # those of `launches` in bf16
strided_conv3x3_down.tc_launches = 0  # those of `launches` on the tensor cores
strided_conv3x3_down.f32_blocked_launches = 0  # those on the blocked f32 kernel
