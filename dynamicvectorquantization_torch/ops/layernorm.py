"""LayerNorm over the last axis with a recompute-statistics backward.

Counterpart of `dynamicvectorquantization_tpu/ops/layernorm_pallas.py`
(`fused_layernorm`): f32 statistics (mean, then the centred variance), eps
inside the root, output in x's dtype; the backward keeps only x and gamma and
recomputes mean and rstd, returns dx in x's dtype and dgamma / dbeta summed in
f32 over all rows.

`layernorm_forward` and `layernorm_backward` launch the CUDA kernels of
`csrc/layernorm.cu` (forward) and `csrc/layernorm_bwd.cu` (backward) for CUDA
tensors and run the plain versions below for CPU tensors; `fused_layernorm` is
the `torch.autograd.Function` over the two. There is no fallback: a CUDA
tensor the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 2048


def fused_layernorm_plain(x, gamma, beta, eps: float = 1e-5):
    """Plain PyTorch version of the forward (differentiable by autograd)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def layernorm_backward_plain(x, gamma, dy, eps: float = 1e-5):
    """Plain PyTorch version of the backward: (dx in x's dtype, dgamma f32,
    dbeta f32), with mean and rstd recomputed from x."""
    xf, dyf = x.float(), dy.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    dyg = dyf * gamma.float()
    m1 = dyg.mean(dim=-1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    dx = ((dyg - m1 - xhat * m2) * rstd).to(x.dtype)
    d = x.shape[-1]
    return dx, (dyf * xhat).reshape(-1, d).sum(0), dyf.reshape(-1, d).sum(0)


def _check(name, x, params, others=()):
    tensors = (x, *params, *others)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for t in others):
        raise TypeError(f"{name}: f32 or bf16 rows of one dtype, got "
                        f"{[t.dtype for t in (x, *others)]}")
    if params[0].dtype not in _DTYPE_CODE or any(t.dtype != params[0].dtype for t in params):
        raise TypeError(f"{name}: gamma / beta must be f32 or bf16, got "
                        f"{[t.dtype for t in params]}")
    d = x.shape[-1]
    if x.dim() < 1 or d % 4 or d > MAX_DIM or x.numel() == 0:
        raise ValueError(f"{name}: the last axis must be a multiple of 4 up to {MAX_DIM}, "
                         f"got shape {tuple(x.shape)}")
    if any(t.shape != (d,) for t in params) or any(t.shape != x.shape for t in others):
        raise ValueError(f"{name}: shapes do not match x {tuple(x.shape)}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")


def layernorm_forward(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm of x (..., D) -> y in x's dtype. `layernorm_forward.launches`
    counts kernel launches."""
    if all(t.device.type == "cpu" for t in (x, gamma, beta)):
        return fused_layernorm_plain(x, gamma, beta, eps)
    _check("layernorm_forward", x, (gamma, beta))
    d = x.shape[-1]
    y = torch.empty_like(x)
    err = cuda_lib.lib().dqvq_layernorm_forward(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), x.numel() // d, d,
        float(eps), _DTYPE_CODE[x.dtype], _DTYPE_CODE[gamma.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(err, "layernorm_forward")
    layernorm_forward.launches += 1
    return y


layernorm_forward.launches = 0


@functools.lru_cache(maxsize=None)
def _backward_occupancy(device: torch.device, d: int, dtype_code: int):
    """(rows a block of the backward takes at once, blocks the card holds at
    once) at width d on `device`, queried from CUDA once per (device, d,
    dtype)."""
    groups, per_sm = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = cuda_lib.lib().dqvq_layernorm_backward_occupancy(
            d, dtype_code, ctypes.addressof(groups), ctypes.addressof(per_sm))
    cuda_lib.check(err, "layernorm_backward occupancy")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return groups.value, sms * max(per_sm.value, 1)


def layernorm_backward(x, gamma, dy, eps: float = 1e-5):
    """(dx in x's dtype, dgamma f32, dbeta f32) of `layernorm_forward`.
    `layernorm_backward.launches` counts kernel launches (the rows kernel,
    which leaves one partial row pair per block, and the reduction of those
    rows are one launch of the wrapper)."""
    if all(t.device.type == "cpu" for t in (x, gamma, dy)):
        return layernorm_backward_plain(x, gamma, dy, eps)
    _check("layernorm_backward", x, (gamma,), (dy,))
    d = x.shape[-1]
    rows = x.numel() // d
    # a persistent grid: as many blocks as the card holds, fewer where the rows are few
    groups, fit = _backward_occupancy(x.device, d, _DTYPE_CODE[x.dtype])
    n_partial = min(-(-rows // groups), fit)
    dx = torch.empty_like(x)
    dgamma = torch.empty(d, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(d, dtype=torch.float32, device=x.device)
    partial = torch.empty((n_partial, 2, d), dtype=torch.float32, device=x.device)
    err = cuda_lib.lib().dqvq_layernorm_backward(
        x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), partial.data_ptr(), n_partial, rows, d, float(eps),
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[gamma.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(err, "layernorm_backward")
    layernorm_backward.launches += 1
    return dx, dgamma, dbeta


layernorm_backward.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return layernorm_forward(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        # autograd may hand over a broadcast or transposed dy: make it
        # contiguous here, the kernel takes nothing else
        dx, dgamma, dbeta = layernorm_backward(x, gamma, dy.contiguous(), ctx.eps)
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None


def fused_layernorm(x, gamma, beta, eps: float = 1e-5):
    """Differentiable LayerNorm over the last axis of a contiguous x; on CUDA
    both directions are the kernels of `csrc/layernorm.cu` and
    `csrc/layernorm_bwd.cu`."""
    return _FusedLayerNorm.apply(x, gamma, beta, eps)
