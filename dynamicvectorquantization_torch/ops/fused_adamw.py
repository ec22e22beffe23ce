"""One-pass AdamW update of one parameter leaf.

Counterpart of `dynamicvectorquantization_tpu/ops/fused_adamw.py`
(`_fused_adamw_leaf` / `fused_adamw_apply`), with optax's arithmetic:

    m' = b1 m + (1 - b1) g            v' = b2 v + (1 - b2) g^2
    u  = (m' c1) / (sqrt(v' c2) + eps) + wd p        p' = p - lr u

c1 = 1 / (1 - b1^t), c2 = 1 / (1 - b2^t) with t = count + 1 and
lr = schedule(count), the count BEFORE the increment (`adamw_scalars`); eps
sits outside the root; the decoupled weight decay is multiplied by lr.

`fused_adamw_step` updates p, m, v IN PLACE (the JAX kernel aliases them) and
writes the bf16 working copy of p' in the same pass when given one. It
launches the CUDA kernel `csrc/fused_adamw.cu` for CUDA tensors and runs the
plain version, `fused_adamw_step_plain`, for CPU tensors; no fallback.
`lr`, `c1`, `c2` are floats, or one (3,) f32 tensor on p's device passed as
`lr` (with `c1`, `c2` None): the kernel then reads them on the device (C
entry `dqvq_fused_adamw_device_scalars`), as the TPU kernel reads them from
SMEM, so a CUDA graph of the optimizer step replays with each step's values.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib

_GRAD_CODE = {torch.float32: 0, torch.bfloat16: 1}


def adamw_scalars(count: int, schedule, b1: float = 0.9, b2: float = 0.95):
    """(lr, c1, c2) for the update that follows `count` finished ones, in
    f32 arithmetic as the JAX package computes them. `schedule`: a function
    of the count, or a constant."""
    lr = schedule(count) if callable(schedule) else schedule
    t = np.float32(count + 1)
    one = np.float32(1.0)
    c1 = one / (one - np.float32(b1) ** t)
    c2 = one / (one - np.float32(b2) ** t)
    return float(np.float32(lr)), float(c1), float(c2)


def _scalars(lr, c1, c2):
    """(lr, c1, c2, the (3,) tensor or None) from three floats or a (3,) f32
    tensor given as `lr`."""
    if not isinstance(lr, torch.Tensor):
        return lr, c1, c2, None
    if c1 is not None or c2 is not None or lr.dtype != torch.float32 or lr.shape != (3,):
        raise ValueError("fused_adamw_step: a tensor lr is the (3,) f32 triple (lr, c1, c2), "
                         "with c1 = c2 = None")
    return lr[0], lr[1], lr[2], lr.contiguous()


@torch.no_grad()
def fused_adamw_step_plain(g, p, m, v, lr, c1=None, c2=None, b1=0.9, b2=0.95, eps=1e-8, wd=0.0,
                           copy=None):
    """Plain PyTorch version: the same arithmetic in f32, p / m / v (and
    `copy`) written in place; a (3,) tensor `lr` is the triple (lr, c1, c2),
    each read as a 0-d f32 tensor."""
    lr, c1, c2, _ = _scalars(lr, c1, c2)
    gf = g.float()
    m.copy_(b1 * m + (1.0 - b1) * gf)
    v.copy_(b2 * v + (1.0 - b2) * (gf * gf))
    u = (m * c1) / (torch.sqrt(v * c2) + eps)
    if wd:
        u = u + wd * p
    p.copy_(p - lr * u)
    if copy is not None:
        copy.copy_(p)  # rounds to nearest even, as the kernel
    return p, m, v


@torch.no_grad()
def fused_adamw_step(g, p, m, v, lr, c1=None, c2=None, b1=0.9, b2=0.95, eps=1e-8, wd=0.0,
                     copy=None):
    """One AdamW update of the leaf p (f32) with gradient g (f32 or bf16) and
    moments m, v (f32), all of one shape, in place; `copy` (bf16, same shape)
    receives p' when given. `lr`, `c1`, `c2`: floats, or the (3,) f32 triple
    on p's device as `lr`. `fused_adamw_step.launches` counts kernel
    launches, `.device_scalar_launches` those that read the triple on the
    device."""
    tensors = (g, p, m, v) + (() if copy is None else (copy,))
    if all(x.device.type == "cpu" for x in tensors):
        return fused_adamw_step_plain(g, p, m, v, lr, c1, c2, b1, b2, eps, wd, copy)
    if any(x.device != p.device for x in tensors) or p.device.type != "cuda":
        raise ValueError("fused_adamw_step: all tensors must be on one CUDA device")
    if g.dtype not in _GRAD_CODE or any(x.dtype != torch.float32 for x in (p, m, v)) or (
            copy is not None and copy.dtype != torch.bfloat16):
        raise TypeError("fused_adamw_step: g f32 or bf16, p / m / v f32, copy bf16; got "
                        f"{[x.dtype for x in tensors]}")
    if any(x.shape != p.shape for x in tensors) or p.numel() == 0:
        raise ValueError(f"fused_adamw_step: one non-empty shape for all tensors, got "
                         f"{[tuple(x.shape) for x in tensors]}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("fused_adamw_step: tensors must be contiguous")
    ptrs = (g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
            None if copy is None else copy.data_ptr(), p.numel())
    rest = (b1, b2, 1.0 - b1, 1.0 - b2, eps, float(wd), _GRAD_CODE[g.dtype],
            torch.cuda.current_stream(p.device).cuda_stream)
    lr, c1, c2, triple = _scalars(lr, c1, c2)
    if triple is None:
        err = cuda_lib.lib().dqvq_fused_adamw(*ptrs, lr, c1, c2, *rest)
    else:
        if triple.device != p.device:
            raise ValueError("fused_adamw_step: the (lr, c1, c2) tensor must be on p's device")
        err = cuda_lib.lib().dqvq_fused_adamw_device_scalars(*ptrs, triple.data_ptr(), *rest)
    cuda_lib.check(err, "fused_adamw_step")
    fused_adamw_step.launches += 1
    fused_adamw_step.device_scalar_launches += triple is not None
    return p, m, v


fused_adamw_step.launches = 0
fused_adamw_step.device_scalar_launches = 0
