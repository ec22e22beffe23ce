"""Fused attention forward on (B, T, D) inputs with heads carved from D.

Counterpart of the forward of `dynamicvectorquantization_tpu/ops/
attention_pallas.py` (`fused_causal_attention`). `fused_attention_forward`
launches the CUDA kernel `csrc/fused_attention.cu` for CUDA tensors and runs
its plain version, `fused_attention_forward_plain`, for CPU tensors. There
is no fallback: a CUDA tensor the kernel cannot take raises.

The backward, and attention-probability dropout (`rate > 0`), come with the
stage-2 training slice (ROADMAP.md, TPU kernels #4/#5).
"""
from __future__ import annotations

import torch

from . import cuda_lib

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_forward_plain(q, k, v, n_head: int, scale=None, causal=False):
    """Plain PyTorch version: the same math as the TPU kernel (f32 scores,
    max-subtracted exp, normalisation after P V), computed in f32."""
    b, t, d = q.shape
    hd = d // n_head
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5

    def heads(z):
        return z.float().reshape(b, t, n_head, hd).transpose(1, 2)

    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    y = torch.matmul(p, heads(v)) / p.sum(dim=-1, keepdim=True)
    return y.transpose(1, 2).reshape(b, t, d).to(q.dtype)


def fused_attention_forward(q, k, v, n_head: int, scale=None, causal=False, rate=0.0):
    """softmax(Q K^T * scale) V per head; q/k/v: (B, T, D), D = n_head * hd
    with hd in {16, 32, 64, 128, 256, 512}; f32 or bf16. Returns (B, T, D) in
    q's dtype. `fused_attention_forward.launches` counts kernel launches."""
    if rate > 0.0:
        raise NotImplementedError(
            "attention-probability dropout comes with the stage-2 training slice")
    tensors = (q, k, v)
    if all(x.device.type == "cpu" for x in tensors):
        return fused_attention_forward_plain(q, k, v, n_head, scale, causal)
    if any(x.device != q.device for x in tensors) or q.device.type != "cuda":
        raise ValueError("fused_attention_forward: all inputs must be on one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention_forward: f32 or bf16 inputs of one dtype, got "
                        f"{[x.dtype for x in tensors]}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_attention_forward: q/k/v must share one (B, T, D) shape, "
                         f"got {[tuple(x.shape) for x in tensors]}")
    b, t, d = q.shape
    if n_head <= 0 or d % n_head or d // n_head not in (16, 32, 64, 128, 256, 512):
        raise ValueError(f"fused_attention_forward: unsupported D={d} with {n_head} heads")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("fused_attention_forward: inputs must be contiguous")
    if scale is None:
        scale = 1.0 / float(d // n_head) ** 0.5
    out = torch.empty_like(q)
    err = cuda_lib.lib().dqvq_fused_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, d, n_head,
        float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_lib.check(err, "fused_attention_forward")
    fused_attention_forward.launches += 1
    return out


fused_attention_forward.launches = 0
