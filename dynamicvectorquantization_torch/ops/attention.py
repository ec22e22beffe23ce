"""Fused attention on (B, T, D) inputs with heads carved from D, forward and
backward.

Counterpart of `dynamicvectorquantization_tpu/ops/attention_pallas.py`
(`fused_causal_attention` and its VJP). `fused_attention_forward` launches
the CUDA kernel `csrc/fused_attention.cu` for CUDA tensors and runs its plain
version, `fused_attention_forward_plain`, for CPU tensors;
`fused_attention_backward` does the same with `csrc/fused_attention_bwd.cu`
and `fused_attention_backward_plain`. `fused_causal_attention` is the
`torch.autograd.Function` over the two: the forward also returns each row's
log-sum-exp of the scaled scores, the Function saves q, k, v, y and it, and
the backward rebuilds the probabilities from them tile by tile. There is no
fallback: a CUDA tensor a kernel cannot take raises.

Attention-probability dropout (`rate > 0`) is not ported: it needs a
counter-based generator inside both kernels (ROADMAP.md, "Philox in-kernel
dropout for TPU kernels #4/#5"), and until then it raises.
"""
from __future__ import annotations

import torch

from . import cuda_lib

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FORWARD_HEAD_DIMS = (16, 32, 64, 128, 256, 512)
_BACKWARD_HEAD_DIMS = _FORWARD_HEAD_DIMS
_DROPOUT_MESSAGE = (
    "attention-probability dropout (rate > 0) is not ported: see ROADMAP.md, "
    "'Philox in-kernel dropout for TPU kernels #4/#5'; train with attn_pdrop = 0 until then")


def _heads(z, n_head):
    b, t, d = z.shape
    return z.float().reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _scores(q, k, n_head, scale, causal):
    """f32 scaled scores (B, H, T, T), -inf above the causal diagonal."""
    t = q.shape[1]
    s = torch.matmul(_heads(q, n_head), _heads(k, n_head).transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, float("-inf"))
    return s


def fused_attention_forward_plain(q, k, v, n_head: int, scale=None, causal=False,
                                  return_lse=False):
    """Plain PyTorch version: the same math as the TPU kernel (f32 scores,
    max-subtracted exp, normalisation after P V), computed in f32. With
    `return_lse` also the rows' log-sum-exp, (B, H, T) f32."""
    b, t, d = q.shape
    if scale is None:
        scale = 1.0 / float(d // n_head) ** 0.5
    s = _scores(q, k, n_head, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    y = (torch.matmul(p, _heads(v, n_head)) / l).transpose(1, 2).reshape(b, t, d).to(q.dtype)
    if return_lse:
        return y, (m + torch.log(l))[..., 0]
    return y


def fused_attention_backward_plain(q, k, v, y, lse, dy, n_head: int, scale=None, causal=True):
    """Plain PyTorch version of the backward, in f32: P = exp(S scale - lse),
    delta = rowsum(dY * Y), dV = P^T dY, dP = dY V^T, dS = P * (dP - delta),
    dQ = dS K scale, dK = dS^T Q scale; outputs in q's dtype."""
    b, t, d = q.shape
    if scale is None:
        scale = 1.0 / float(d // n_head) ** 0.5
    p = torch.exp(_scores(q, k, n_head, scale, causal) - lse[..., None])
    dyh = _heads(dy, n_head)
    delta = (dyh * _heads(y, n_head)).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), dyh)
    ds = p * (torch.matmul(dyh, _heads(v, n_head).transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, _heads(k, n_head)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q, n_head)) * scale
    return tuple(z.transpose(1, 2).reshape(b, t, d).to(q.dtype) for z in (dq, dk, dv))


def _check(name, tensors, n_head, head_dims):
    q = tensors[0]
    if any(x.device != q.device for x in tensors) or q.device.type != "cuda":
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if q.dtype not in _DTYPE_CODE or any(x.dtype != q.dtype for x in tensors):
        raise TypeError(f"{name}: f32 or bf16 inputs of one dtype, got "
                        f"{[x.dtype for x in tensors]}")
    if q.dim() != 3 or any(x.shape != q.shape for x in tensors):
        raise ValueError(f"{name}: the inputs must share one (B, T, D) shape, "
                         f"got {[tuple(x.shape) for x in tensors]}")
    d = q.shape[2]
    if n_head <= 0 or d % n_head or d // n_head not in head_dims:
        raise ValueError(f"{name}: unsupported D={d} with {n_head} heads "
                         f"(head dims {head_dims})")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def fused_attention_forward(q, k, v, n_head: int, scale=None, causal=False, rate=0.0,
                            return_lse=False):
    """softmax(Q K^T * scale) V per head; q/k/v: (B, T, D), D = n_head * hd
    with hd in {16, 32, 64, 128, 256, 512}; f32 or bf16. Returns (B, T, D) in
    q's dtype, and with `return_lse` also the rows' log-sum-exp (B, H, T) f32.
    `fused_attention_forward.launches` counts kernel launches."""
    if rate > 0.0:
        raise NotImplementedError(_DROPOUT_MESSAGE)
    tensors = (q, k, v)
    if all(x.device.type == "cpu" for x in tensors):
        return fused_attention_forward_plain(q, k, v, n_head, scale, causal, return_lse)
    _check("fused_attention_forward", tensors, n_head, _FORWARD_HEAD_DIMS)
    b, t, d = q.shape
    if scale is None:
        scale = 1.0 / float(d // n_head) ** 0.5
    out = torch.empty_like(q)
    lse = (torch.empty((b, n_head, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = cuda_lib.lib().dqvq_fused_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, b, t, d, n_head,
        float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_lib.check(err, "fused_attention_forward")
    fused_attention_forward.launches += 1
    return (out, lse) if return_lse else out


fused_attention_forward.launches = 0


def fused_attention_backward(q, k, v, y, lse, dy, n_head: int, scale=None, causal=True):
    """(dq, dk, dv) in q's dtype from the forward's inputs, its output y and
    its log-sum-exp; hd as in the forward. `fused_attention_backward.launches`
    counts launches (delta, dK/dV and dQ passes are one launch of the wrapper)."""
    tensors = (q, k, v, y, dy)
    if all(x.device.type == "cpu" for x in (*tensors, lse)):
        return fused_attention_backward_plain(q, k, v, y, lse, dy, n_head, scale, causal)
    _check("fused_attention_backward", tensors, n_head, _BACKWARD_HEAD_DIMS)
    b, t, d = q.shape
    if (lse.device != q.device or lse.dtype != torch.float32 or lse.shape != (b, n_head, t)
            or not lse.is_contiguous()):
        raise ValueError("fused_attention_backward: lse must be the forward's contiguous "
                         f"(B, H, T) f32 output, got {tuple(lse.shape)} {lse.dtype}")
    if scale is None:
        scale = 1.0 / float(d // n_head) ** 0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty_like(lse)
    err = cuda_lib.lib().dqvq_fused_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(), dy.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, d, n_head,
        float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_lib.check(err, "fused_attention_backward")
    fused_attention_backward.launches += 1
    return dq, dk, dv


fused_attention_backward.launches = 0


class _FusedCausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_head, scale, causal):
        y, lse = fused_attention_forward(q, k, v, n_head, scale, causal, return_lse=True)
        ctx.save_for_backward(q, k, v, y, lse)
        ctx.args = (n_head, scale, causal)
        return y

    @staticmethod
    def backward(ctx, dy):
        q, k, v, y, lse = ctx.saved_tensors
        # autograd often hands over a non-contiguous dy (a view of the
        # projection's input gradient): copy it, the kernel takes nothing else
        dq, dk, dv = fused_attention_backward(q, k, v, y, lse, dy.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None


def fused_causal_attention(q, k, v, n_head: int, scale=None, causal=True, rate=0.0):
    """Differentiable softmax(Q K^T * scale) V on contiguous (B, T, D)
    projection outputs (no head transpose); on CUDA both directions are
    hand-written kernels. Where no gradient is asked for (`torch.no_grad()`,
    or inputs that need none) only the forward runs and no log-sum-exp is
    kept. `rate > 0` raises (see the module docstring)."""
    if rate > 0.0:
        raise NotImplementedError(_DROPOUT_MESSAGE)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return fused_attention_forward(q, k, v, n_head, scale, causal)
    return _FusedCausalAttention.apply(q, k, v, n_head, scale, causal)
