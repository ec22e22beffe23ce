"""int8-quantized KV cache: quantizer and single-token decode attention.

Counterpart of `dynamicvectorquantization_tpu/ops/kv_int8.py`. Caches hold
int8 keys/values with one f32 absmax scale per (batch, head, position),
halving the bytes each decode step streams compared with bf16 caches.

`decode_attention_int8` launches the CUDA kernel
`csrc/decode_attention_int8.cu` for CUDA tensors and runs its plain version,
`decode_attention_int8_plain`, for CPU tensors. There is no fallback: a CUDA
tensor the kernel cannot take raises. `cache_index` is a host int or, as the
TPU kernel's scalar-prefetched index, an int32 tensor the kernel reads on the
device (a launch that stays valid as the index moves).
"""
from __future__ import annotations

import torch

from . import cuda_lib

CHUNK = 256  # cache capacity granule (the TPU kernel's chunk of positions)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def quantize_kv(x, eps=1e-8):
    """Per-(..., position) absmax int8 quantization over the head dim.

    x: (..., T, hd) float -> (int8 values (..., T, hd), f32 scales (..., T)).
    Rounds half to even and clips to [-127, 127], as the reference.
    """
    xf = x.float()
    s = xf.abs().amax(dim=-1).clamp_min(eps) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _host_index(cache_index) -> int:
    """`cache_index` as a Python int: an int, or a 0-d / one-element int32
    tensor (read on the host)."""
    if isinstance(cache_index, torch.Tensor):
        _check_index_tensor(cache_index)
        return int(cache_index.reshape(()).item())
    return int(cache_index)


def _check_index_tensor(idx):
    if idx.dtype != torch.int32:
        raise TypeError("decode_attention_int8: a cache_index tensor must be int32, "
                        f"got {idx.dtype}")
    if idx.numel() != 1:
        raise ValueError("decode_attention_int8: a cache_index tensor must hold one element, "
                         f"got shape {tuple(idx.shape)}")


def decode_attention_int8_plain(q, k_i8, v_i8, k_s, v_s, cache_index):
    """Plain PyTorch version (the counterpart of
    `_decode_attention_int8_ref`): chunked online softmax over the filled
    prefix with explicit dequantization, f32 accumulation. `cache_index`: an
    int or a 0-d / one-element int32 tensor."""
    cache_index = _host_index(cache_index)
    b, h, t, hd = k_i8.shape
    if t % CHUNK:
        raise ValueError(f"cache length {t} is not a multiple of {CHUNK}")
    scale = 1.0 / float(hd) ** 0.5
    neg = torch.finfo(torch.float32).min
    qf = q.float()
    m = torch.full((b, h, 1), neg, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, 1, hd), dtype=torch.float32, device=q.device)
    for start in range(0, (cache_index // CHUNK + 1) * CHUNK, CHUNK):
        sl = slice(start, start + CHUNK)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_i8[:, :, sl].float())
        s = s * k_s[:, :, None, sl] * scale
        pos = torch.arange(start, start + CHUNK, device=q.device)
        s = torch.where(pos <= cache_index, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p * v_s[:, :, None, sl], v_i8[:, :, sl].float()
        )
        m = m_new
    return (acc / l[..., None]).to(q.dtype)


def decode_attention_int8(q, k_i8, v_i8, k_s, v_s, cache_index):
    """Single-token decode attention over int8 caches.

    q: (B, H, 1, hd) f32 or bf16; k_i8/v_i8: (B, H, T, hd) int8;
    k_s/v_s: (B, H, T) f32; cache_index: the last valid position, a host int
    or a 0-d / one-element int32 tensor on q's device (read there by the
    kernel; outside [0, T) the output is NaN). Returns (B, H, 1, hd) in q's
    dtype. `decode_attention_int8.launches` counts kernel launches.
    """
    tensors = (q, k_i8, v_i8, k_s, v_s)
    on_device = isinstance(cache_index, torch.Tensor)
    if all(x.device.type == "cpu" for x in tensors + ((cache_index,) if on_device else ())):
        return decode_attention_int8_plain(q, k_i8, v_i8, k_s, v_s, cache_index)
    if any(x.device != q.device for x in tensors) or q.device.type != "cuda":
        raise ValueError("decode_attention_int8: all inputs must be on one CUDA device")
    b, h, t, hd = k_i8.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode_attention_int8: q must be f32 or bf16, got {q.dtype}")
    if k_i8.dtype != torch.int8 or v_i8.dtype != torch.int8:
        raise TypeError("decode_attention_int8: caches must be int8")
    if k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise TypeError("decode_attention_int8: scales must be f32")
    if (tuple(q.shape) != (b, h, 1, hd) or tuple(v_i8.shape) != (b, h, t, hd)
            or tuple(k_s.shape) != (b, h, t) or tuple(v_s.shape) != (b, h, t)):
        raise ValueError("decode_attention_int8: inconsistent shapes "
                         f"{[tuple(x.shape) for x in tensors]}")
    if hd not in (16, 32, 64, 128, 256) or t % CHUNK:
        raise ValueError(f"decode_attention_int8: unsupported hd={hd} or T={t}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("decode_attention_int8: inputs must be contiguous")
    if k_i8.data_ptr() % 16 or v_i8.data_ptr() % 16:
        raise ValueError("decode_attention_int8: the caches must start on a 16-byte boundary")
    if on_device:
        _check_index_tensor(cache_index)
        if cache_index.device != q.device:
            raise ValueError("decode_attention_int8: a cache_index tensor must be on q's device "
                             f"{q.device}, got {cache_index.device}")
    elif not 0 <= cache_index < t:
        raise ValueError(f"decode_attention_int8: cache_index {cache_index} outside [0, {t})")
    out = torch.empty_like(q)
    lib = cuda_lib.lib()
    args = (q.data_ptr(), k_i8.data_ptr(), v_i8.data_ptr(), k_s.data_ptr(), v_s.data_ptr(),
            out.data_ptr(), b, h, t, hd)
    tail = (1.0 / float(hd) ** 0.5, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if on_device:
        err = lib.dqvq_decode_attention_int8_device_index(*args, cache_index.data_ptr(), *tail)
    else:
        err = lib.dqvq_decode_attention_int8(*args, int(cache_index), *tail)
    cuda_lib.check(err, "decode_attention_int8")
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0
