"""Fused attention on (B, T, D) inputs with heads carved from D, forward and
backward.

Counterpart of `dynamicvectorquantization_tpu/ops/attention_pallas.py`
(`fused_causal_attention` and its VJP). `fused_attention_forward` launches a
CUDA kernel for CUDA tensors and runs its plain version,
`fused_attention_forward_plain`, for CPU tensors; `fused_attention_backward`
does the same with `fused_attention_backward_plain`. The kernel a call runs is
chosen by dtype and head dim (`_route`). bf16 at hd 64, 128, 256 and 512 runs
on the tensor cores (hd 64 / 128, the StackGPT's heads in stage-2 training:
`csrc/fused_attention_tc.cu`, `csrc/fused_attention_bwd_tc.cu`; hd 256 / 512,
the DQ-VAE's AttnBlocks in bf16: `csrc/fused_attention_tc_wide.cu`,
`csrc/fused_attention_bwd_tc_wide.cu`, through the same entry points). f32
at hd 64 and 128 (the StackGPT's f32 masters: stage-2 validation, and
training with `compute_dtype` float32) runs on the tensor cores as three TF32
products a product, f32 accuracy: the forward in
`csrc/fused_attention_f32_tc.cu`, the backward in
`csrc/fused_attention_bwd_f32_tc.cu`. Everything else (f32 at hd 256 / 512,
so the DQ-VAE's AttnBlocks in f32; f32 and bf16 at hd 16 and 32) runs on the
FMA units: f32 at hd 256 and 512 in the register-blocked
`csrc/fused_attention_wide.cu` and `csrc/fused_attention_bwd_wide.cu`
(`_wide_f32`), the rest on the square tiles of `csrc/fused_attention.cu` and
`csrc/fused_attention_bwd.cu`. In
bf16 both families round where the TPU kernel rounds: the probabilities to
bf16 before P V, relative to the row's final max (so the bf16 forwards are
two-pass), and D and dS before their products; the bf16 plain versions make
the same roundings.
A head dim no kernel takes below 512 (hd 104: taming's faces transformer,
1,664 channels over 16 heads) is zero-padded per head to the next one a
kernel takes (104 -> 128) with the real scale, and the output and the
gradients are cut back (`.padded_launches`). This is exact: zero columns add
nothing to Q K^T, so the lse is the same, the padded columns of dQ, dK and
dV are zero, and the dropout mask depends on (b, h, row, col) alone. It is
still the kernel's work, at 128 / 104 = 1.23x the bytes and operations of
the real head dim. Above 512 a CUDA tensor raises.
`fused_causal_attention` is the `torch.autograd.Function` over the two: the
forward also returns each row's log-sum-exp of the scaled scores, the
Function saves q, k, v, y and it, and the backward rebuilds the
probabilities from them tile by tile. There is no fallback: a CUDA tensor a
kernel cannot take raises.

Attention-probability dropout (`rate > 0`) runs inside both kernels, as in
the TPU kernels: Y = (P o M / keep) V with the softmax denominator summed
over the undropped P, and the backward redraws the mask M instead of storing
it. The keep bit of a probability is a pure function of `(seed, batch, head,
query row, key column)`: one Philox4x32-10 call with counter `(column // 4,
row, batch * n_head + head, 0)` and the seed's two 32-bit halves as key
gives four words, column `c` takes word `c % 4`, and the probability is kept
iff the word >= uint32(rate * 4294967295), the TPU kernel's rule. A call may
run a slice of a model's heads, `n_head` of `n_head_total` from `head0` (a
tensor-parallel rank's local heads): the counter's head is then the head's
index in the model, `batch * n_head_total + head0 + head`, so the slice
draws what a call over every head draws for those heads, as the JAX step
under GSPMD draws one mask over the global tensor. `head0 = 0` with
`n_head_total = n_head` (the default) is the call without an offset. Tile
sizes, blocks and threads do not enter, so the forward, both backward passes
and the plain version (`dropout_keep_mask`, the same Philox in torch integer
ops) agree bit for bit. `attention_seed` derives a layer's seed on the host
from (base seed, optimizer step, microbatch, layer), with no device sync.
The seed is a Python int, or a one-element int64 tensor on q's device (its
64 bits): a CUDA tensor goes to each kernel's `_device_seed` C entry, which
reads it on the device, as the TPU kernels read theirs from a device array,
so a CUDA graph replays the launch with whatever seed the tensor holds. The
plain versions read a tensor seed on the host.
"""
from __future__ import annotations

import torch

from . import cuda_lib

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FORWARD_HEAD_DIMS = (16, 32, 64, 128, 256, 512)
_BACKWARD_HEAD_DIMS = _FORWARD_HEAD_DIMS
_TC_HEAD_DIMS = (64, 128, 256, 512)  # bf16 head dims of the tensor-core family
_WIDE_F32_HEAD_DIMS = (256, 512)  # f32 head dims of the register-blocked kernels
_F32_TC_HEAD_DIMS = (64, 128)  # f32 head dims of the 3xTF32 forward and backward
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo32(a: int, b):
    """(high, low) 32-bit words of the 64-bit product of the constant `a` and
    the int64 tensor `b` of values below 2^32. (2^32 - 1)^2 overflows int64,
    so the product is assembled from 16-bit limbs, each partial below 2^33."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    low = a_lo * b_lo
    mid = a_hi * b_lo + a_lo * b_hi + (low >> 16)
    return a_hi * b_hi + (mid >> 16), ((mid & 0xFFFF) << 16) | (low & 0xFFFF)


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding 32-bit words: `counter` four
    broadcastable tensors, `key` two Python ints or two int64 tensors (read
    on their device, never on the host). Returns the four output words as
    int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = counter
    k0, k1 = (k & _MASK32 if isinstance(k, torch.Tensor) else int(k) & _MASK32 for k in key)
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _MASK32, (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    """A probability is kept iff its 32 random bits are >= this."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    return int(rate * 4294967295.0)


def _heads_of(n_head, head0, n_head_total):
    """(head0, n_head_total) checked: `n_head` heads from `head0` inside a
    model of `n_head_total` (None: `n_head`)."""
    total = n_head if n_head_total is None else int(n_head_total)
    head0 = int(head0)
    if n_head <= 0 or head0 < 0 or head0 + n_head > total:
        raise ValueError(f"heads {head0} .. {head0 + n_head - 1} do not lie in a model of "
                         f"{total} heads")
    return head0, total


def dropout_keep_mask(seed, b: int, n_head: int, t: int, rate: float, device=None,
                      head0: int = 0, n_head_total=None):
    """The keep mask both kernels draw, bool (B, H, T, T) [batch, head, query
    row, key column], from the same Philox counters in torch integer ops;
    for heads `head0 ..` of a model of `n_head_total` heads, the rows of
    those heads in the model's full mask (the module docstring). `seed` is
    an int, or a one-element int64 tensor on `device` whose 64 bits make the
    key by device ops (no host read: a CUDA graph captures the draw and
    replays it with whatever seed the tensor then holds)."""
    head0, total = _heads_of(n_head, head0, n_head_total)
    groups = (t + 3) // 4
    i64 = dict(dtype=torch.int64, device=device)
    col4 = torch.arange(groups, **i64).view(1, 1, groups)
    row = torch.arange(t, **i64).view(1, t, 1)
    bh = (torch.arange(b, **i64).view(b, 1) * total + head0
          + torch.arange(n_head, **i64).view(1, n_head)).view(b * n_head, 1, 1)
    if isinstance(seed, torch.Tensor):
        seed = seed.to(device=device, dtype=torch.int64).reshape(())
    else:
        seed = int(seed) & _MASK64
    words = philox4x32_10((col4, row, bh, torch.zeros((), **i64)), (seed, seed >> 32))
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = bits.reshape(b * n_head, t, 4 * groups)[..., :t]
    return (bits >= dropout_threshold(rate)).view(b, n_head, t, t)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def mix_seed(seed: int, *values: int) -> int:
    """A 64-bit seed from `seed` and further integers by a fixed mix
    (splitmix64 rounds), computed on the host."""
    out = _splitmix64(int(seed) & _MASK64)
    for v in values:
        out = _splitmix64(out ^ (int(v) & _MASK64))
    return out


def attention_seed(base_seed: int, step: int, microbatch: int = 0) -> int:
    """The seed of one training forward: a function of the base seed, the
    optimizer step and the microbatch index and of nothing else, so a resumed
    run redraws the masks of the uninterrupted one. Layers mix their index
    into it (`mix_seed(seed, layer)`)."""
    return mix_seed(base_seed, step, microbatch)


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


def _keep_scale(q, n_head, rate, seed, head0=0, n_head_total=None):
    """M / keep as f32 (B, H, T, T), or None at rate 0."""
    if rate <= 0.0:
        return None
    if seed is None:
        raise ValueError("attention dropout (rate > 0) needs a seed")
    b, t, _ = q.shape
    return dropout_keep_mask(seed, b, n_head, t, rate, q.device, head0,
                             n_head_total).float() / (1.0 - rate)


def fused_attention_forward_plain(q, k, v, n_head: int, scale=None, causal=False,
                                  return_lse=False, rate=0.0, seed=None, head0=0,
                                  n_head_total=None, bias=None):
    """Plain PyTorch version: the same math as the TPU kernel (f32 scores,
    max-subtracted exp, the denominator summed before the dropout mask,
    normalisation after P V), computed in f32; for bf16 inputs the
    probabilities are rounded to bf16 before P V, as the TPU kernel and the
    tensor-core kernel round them. With `return_lse` also the rows'
    log-sum-exp (of the undropped scores), (B, H, T) f32. `head0`,
    `n_head_total`: the heads' place in the model, for the dropout mask (the
    module docstring). `bias`, added to the scaled scores (broadcast to
    (B, H, T, T)), is `masked_causal_attention`'s; the kernels take none.
    Differentiable by autograd (the row max is held constant: the result
    does not depend on it)."""
    b, t, d = q.shape
    if scale is None:
        scale = 1.0 / float(d // n_head) ** 0.5
    s = _scores(q, k, n_head, scale, causal)
    if bias is not None:
        s = s + bias.float()
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    keep = _keep_scale(q, n_head, rate, seed, head0, n_head_total)
    if q.dtype == torch.bfloat16:
        # the TPU kernel's rounding: the kept, unnormalised probabilities to
        # bf16 before P V (`p.astype(v.dtype)`), 1 / keep after it
        if keep is not None:
            p = torch.where(keep > 0, p, 0.0)
        y = torch.matmul(p.to(torch.bfloat16).float(), _heads(v, n_head)) / l
        if keep is not None:
            y = y * (1.0 / (1.0 - rate))
    else:
        if keep is not None:
            p = p * keep
        y = torch.matmul(p, _heads(v, n_head)) / l
    y = y.transpose(1, 2).reshape(b, t, d).to(q.dtype)
    if return_lse:
        return y, (m + torch.log(l))[..., 0]
    return y


def fused_attention_backward_plain(q, k, v, y, lse, dy, n_head: int, scale=None, causal=True,
                                   rate=0.0, seed=None, head0=0, n_head_total=None):
    """Plain PyTorch version of the backward, in f32: P = exp(S scale - lse),
    delta = rowsum(dY * Y), D = P * M / keep, dV = D^T dY, dP = (dY V^T) * M /
    keep, dS = P * (dP - delta), dQ = dS K scale, dK = dS^T Q scale (M = 1,
    keep = 1 at rate 0); outputs in q's dtype. For bf16 inputs D and dS are
    rounded to bf16 before their products, where the TPU kernel rounds."""
    b, t, d = q.shape
    if scale is None:
        scale = 1.0 / float(d // n_head) ** 0.5
    p = torch.exp(_scores(q, k, n_head, scale, causal) - lse[..., None])
    dyh = _heads(dy, n_head)
    delta = (dyh * _heads(y, n_head)).sum(dim=-1, keepdim=True)
    dp = torch.matmul(dyh, _heads(v, n_head).transpose(-1, -2))
    keep = _keep_scale(q, n_head, rate, seed, head0, n_head_total)
    dropped = p
    if keep is not None:
        dropped, dp = p * keep, dp * keep
    bf16 = q.dtype == torch.bfloat16
    if bf16:  # the TPU kernel's `dropped.astype(dy.dtype)`
        dropped = dropped.to(torch.bfloat16).float()
    dv = torch.matmul(dropped.transpose(-1, -2), dyh)
    ds = p * (dp - delta)
    if bf16:  # `ds.astype(k.dtype)`
        ds = ds.to(torch.bfloat16).float()
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


def _tensor_cores(tensors, n_head) -> bool:
    """Whether a call goes to the tensor-core family: bf16 at hd 64, 128, 256
    or 512. Its tiles are copied 16 bytes at a time, so it raises on a tensor
    that does not start on a 16-byte boundary instead of taking the FMA
    family."""
    q = tensors[0]
    hd = q.shape[2] // n_head
    if q.dtype != torch.bfloat16 or hd not in _TC_HEAD_DIMS:
        return False
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"fused attention: bf16 tensors at hd {hd} must start on a "
                         "16-byte boundary")
    return True


def _f32_kernel(tensors, n_head, name, head_dims) -> bool:
    """Whether an f32 call at one of `head_dims` takes a kernel that copies
    its rows 16 bytes at a time; raises on a tensor that does not start on a
    16-byte boundary instead of sending it to the square tiles."""
    q = tensors[0]
    hd = q.shape[2] // n_head
    if q.dtype != torch.float32 or hd not in head_dims:
        return False
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"{name}: f32 tensors at hd {hd} must start on a 16-byte boundary")
    return True


def _wide_f32(tensors, n_head, name="fused attention") -> bool:
    """Whether a call runs the register-blocked f32 kernels
    (`csrc/fused_attention_wide.cu`, `csrc/fused_attention_bwd_wide.cu`): f32
    at hd 256 or 512 (`_f32_kernel`)."""
    return _f32_kernel(tensors, n_head, name, _WIDE_F32_HEAD_DIMS)


def _route(tensors, n_head, name) -> str:
    """The kernel a call runs, forward or backward alike: "tensor cores" (bf16
    at hd 64 / 128 / 256 / 512), "wide f32" (f32 at hd 256 / 512,
    register-blocked), "f32 tensor cores" (f32 at hd 64 / 128, 3xTF32), or
    "square tiles" (f32 and bf16 at hd 16 / 32); raises where a kernel other
    than the square tiles takes the dtype and head dim but not the tensors'
    alignment."""
    if _tensor_cores(tensors, n_head):
        return "tensor cores"
    if _wide_f32(tensors, n_head, name):
        return "wide f32"
    if _f32_kernel(tensors, n_head, name, _F32_TC_HEAD_DIMS):
        return "f32 tensor cores"
    return "square tiles"


def _padded_head_dim(q, n_head):
    """The kernel head dim a call is zero-padded to, or None: a head dim the
    kernels do not take (hd 104, taming's faces transformer: 1,664 over 16
    heads) runs at the next one they take (128), with the real scale."""
    d = q.shape[-1] if q.dim() == 3 else 0
    if n_head <= 0 or d % n_head or d // n_head in _FORWARD_HEAD_DIMS:
        return None
    return next((h for h in _FORWARD_HEAD_DIMS if h > d // n_head), None)


def _paddable(tensors) -> bool:
    """Whether a call's inputs are ones the kernels would take but for the
    head dim (else `_check` names what is wrong with them)."""
    q = tensors[0]
    return all(x.shape == q.shape and x.dtype == q.dtype and x.device == q.device
               and x.is_contiguous() for x in tensors)


def _pad_heads(z, n_head, hd_to):
    """(B, T, H * hd) -> (B, T, H * hd_to), each head's columns followed by
    zeros."""
    b, t, d = z.shape
    return torch.nn.functional.pad(z.reshape(b, t, n_head, d // n_head),
                                   (0, hd_to - d // n_head)).reshape(b, t, n_head * hd_to)


def _unpad_heads(z, n_head, hd):
    b, t, d = z.shape
    return z.reshape(b, t, n_head, d // n_head)[..., :hd].reshape(b, t, n_head * hd)


def _count(wrapper, route, rate, seed):
    wrapper.launches += 1
    wrapper.device_seed_launches += isinstance(seed, torch.Tensor)
    wrapper.tc_launches += route == "tensor cores"
    wrapper.fma_launches += route in ("wide f32", "square tiles")
    wrapper.wide_f32_launches += route == "wide f32"
    wrapper.f32_tc_launches += route == "f32 tensor cores"
    wrapper.dropout_launches += rate > 0.0


def _dropout_args(rate, seed, device):
    """(rate, seed): the seed an int, or at rate > 0 a one-element int64
    tensor on `device` left as it is (read on the device by a kernel, on the
    host by a plain version)."""
    rate = float(rate)
    dropout_threshold(rate)  # validates the rate
    if rate <= 0.0:
        return rate, 0
    if seed is None:
        raise ValueError("attention dropout (rate > 0) needs a seed")
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != device:
            raise ValueError("a tensor seed is one int64 on the inputs' device, got "
                             f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
        return rate, seed
    return rate, int(seed) & _MASK64


def _entry(name, seed):
    """The C entry `name`, or its `_device_seed` twin for a tensor seed, and
    the seed argument it takes (the int, or the tensor's address)."""
    if isinstance(seed, torch.Tensor):
        return getattr(cuda_lib.lib(), name + "_device_seed"), seed.data_ptr()
    return getattr(cuda_lib.lib(), name), seed


def fused_attention_forward(q, k, v, n_head: int, scale=None, causal=False, rate=0.0,
                            return_lse=False, seed=None, head0=0, n_head_total=None):
    """softmax(Q K^T * scale) V per head, with dropout on the probabilities
    when `rate > 0` (mask drawn from `seed`, an int or a one-element int64
    tensor on q's device, see the module docstring); q/k/v: (B, T, D), D =
    n_head * hd with hd in {16, 32, 64, 128, 256, 512}; f32 or bf16; the
    `n_head` heads are heads `head0 ..` of a model of `n_head_total` (the
    dropout counters' heads, see the module docstring). Returns (B, T, D) in q's dtype, and with
    `return_lse` also the rows' log-sum-exp (B, H, T) f32.
    `fused_attention_forward.launches` counts kernel launches,
    `.tc_launches` those of the bf16 tensor-core family, `.fma_launches` those
    of the FMA family, `.wide_f32_launches` those of the FMA family's that ran
    the register-blocked f32 kernel (hd 256 / 512), `.f32_tc_launches` those
    of the 3xTF32 kernel (f32 at hd 64 / 128, in neither family) and
    `.dropout_launches` those at `rate > 0`, `.device_seed_launches` those
    whose seed a tensor held."""
    rate, seed = _dropout_args(rate, seed, q.device)
    head0, total = _heads_of(n_head, head0, n_head_total)
    tensors = (q, k, v)
    if all(x.device.type == "cpu" for x in tensors):
        return fused_attention_forward_plain(q, k, v, n_head, scale, causal, return_lse,
                                             rate, seed, head0, total)
    b, t, d = q.shape
    if scale is None:
        scale = 1.0 / float(d // n_head) ** 0.5
    hd_to = _padded_head_dim(q, n_head)
    if hd_to is not None and _paddable(tensors):
        # zero columns add nothing to Q K^T (so nothing to the lse) and give
        # zero output columns, cut off again; the mask depends on (b, h, row,
        # col) only
        out = fused_attention_forward(*(_pad_heads(x, n_head, hd_to) for x in tensors), n_head,
                                      scale, causal, rate, return_lse, seed, head0, total)
        fused_attention_forward.padded_launches += 1
        if return_lse:
            return _unpad_heads(out[0], n_head, d // n_head), out[1]
        return _unpad_heads(out, n_head, d // n_head)
    _check("fused_attention_forward", tensors, n_head, _FORWARD_HEAD_DIMS)
    out = torch.empty_like(q)
    lse = (torch.empty((b, n_head, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lse_ptr = lse.data_ptr() if return_lse else None
    route = _route(tensors + (out,), n_head, "fused_attention_forward")
    name, dtype = {"tensor cores": ("dqvq_fused_attention_forward_tc", ()),
                   "wide f32": ("dqvq_fused_attention_forward_wide_f32", ()),
                   "f32 tensor cores": ("dqvq_fused_attention_forward_f32_tc", ()),
                   "square tiles": ("dqvq_fused_attention_forward", (_DTYPE_CODE[q.dtype],))
                   }[route]
    entry, seed_arg = _entry(name, seed)
    err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, b, t, d,
                n_head, float(scale), int(bool(causal)), *dtype, rate, seed_arg, total, head0,
                stream)
    cuda_lib.check(err, "fused_attention_forward")
    _count(fused_attention_forward, route, rate, seed)
    return (out, lse) if return_lse else out


fused_attention_forward.launches = 0
fused_attention_forward.tc_launches = 0  # those of `launches` on the tensor-core family
fused_attention_forward.fma_launches = 0  # those on the FMA family
fused_attention_forward.wide_f32_launches = 0  # those of the FMA family's on the wide f32 kernel
fused_attention_forward.f32_tc_launches = 0  # those on the 3xTF32 kernel (f32 hd 64 / 128)
fused_attention_forward.dropout_launches = 0  # those of `launches` that drew a mask
fused_attention_forward.device_seed_launches = 0  # those that read their seed on the device
fused_attention_forward.padded_launches = 0  # those at a head dim zero-padded to a kernel's


def fused_attention_backward(q, k, v, y, lse, dy, n_head: int, scale=None, causal=True,
                             rate=0.0, seed=None, head0=0, n_head_total=None):
    """(dq, dk, dv) in q's dtype from the forward's inputs, its output y, its
    log-sum-exp and its dropout `rate`, `seed` and heads (`head0`,
    `n_head_total`); hd as in the forward.
    `fused_attention_backward.launches` counts launches (the delta kernel and
    the dK/dV and dQ passes are one launch of the wrapper), split by family,
    kernel and rate as the forward's."""
    rate, seed = _dropout_args(rate, seed, q.device)
    head0, total = _heads_of(n_head, head0, n_head_total)
    tensors = (q, k, v, y, dy)
    if all(x.device.type == "cpu" for x in (*tensors, lse)):
        return fused_attention_backward_plain(q, k, v, y, lse, dy, n_head, scale, causal,
                                              rate, seed, head0, total)
    b, t, d = q.shape
    hd_to = _padded_head_dim(q, n_head)
    if hd_to is not None and _paddable(tensors):
        # the padded columns of dQ, dK and dV are zero (they are products
        # with zero columns of K, Q and dY), and delta = rowsum(dY * Y) and
        # the lse are those of the real head dim
        if scale is None:
            scale = 1.0 / float(d // n_head) ** 0.5
        grads = fused_attention_backward(*(_pad_heads(x, n_head, hd_to) for x in tensors[:4]),
                                         lse, _pad_heads(dy, n_head, hd_to), n_head, scale,
                                         causal, rate, seed, head0, total)
        fused_attention_backward.padded_launches += 1
        return tuple(_unpad_heads(g, n_head, d // n_head) for g in grads)
    _check("fused_attention_backward", tensors, n_head, _BACKWARD_HEAD_DIMS)
    if (lse.device != q.device or lse.dtype != torch.float32 or lse.shape != (b, n_head, t)
            or not lse.is_contiguous()):
        raise ValueError("fused_attention_backward: lse must be the forward's contiguous "
                         f"(B, H, T) f32 output, got {tuple(lse.shape)} {lse.dtype}")
    if scale is None:
        scale = 1.0 / float(d // n_head) ** 0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty_like(lse)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(), dy.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    route = _route(tensors + (dq, dk, dv), n_head, "fused_attention_backward")
    name, dtype = {"tensor cores": ("dqvq_fused_attention_backward_tc", ()),
                   "f32 tensor cores": ("dqvq_fused_attention_backward_f32_tc", ()),
                   "wide f32": ("dqvq_fused_attention_backward_wide_f32", ()),
                   "square tiles": ("dqvq_fused_attention_backward", (_DTYPE_CODE[q.dtype],))
                   }[route]
    entry, seed_arg = _entry(name, seed)
    err = entry(*ptrs, b, t, d, n_head, float(scale), int(bool(causal)), *dtype, rate, seed_arg,
                total, head0, stream)
    cuda_lib.check(err, "fused_attention_backward")
    _count(fused_attention_backward, route, rate, seed)
    return dq, dk, dv


fused_attention_backward.launches = 0
fused_attention_backward.tc_launches = 0
fused_attention_backward.fma_launches = 0
fused_attention_backward.wide_f32_launches = 0
fused_attention_backward.f32_tc_launches = 0
fused_attention_backward.dropout_launches = 0
fused_attention_backward.device_seed_launches = 0
fused_attention_backward.padded_launches = 0


class _FusedCausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_head, scale, causal, rate, seed, head0, n_head_total):
        y, lse = fused_attention_forward(q, k, v, n_head, scale, causal, rate, True, seed, head0,
                                         n_head_total)
        ctx.save_for_backward(q, k, v, y, lse)
        ctx.args = (n_head, scale, causal, rate, seed, head0, n_head_total)
        return y

    @staticmethod
    def backward(ctx, dy):
        q, k, v, y, lse = ctx.saved_tensors
        # autograd often hands over a non-contiguous dy (a view of the
        # projection's input gradient): copy it, the kernel takes nothing else
        dq, dk, dv = fused_attention_backward(q, k, v, y, lse, dy.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def fused_causal_attention(q, k, v, n_head: int, scale=None, causal=True, rate=0.0, seed=None,
                           head0=0, n_head_total=None):
    """Differentiable softmax(Q K^T * scale) V on contiguous (B, T, D)
    projection outputs (no head transpose); on CUDA both directions are
    hand-written kernels. Where no gradient is asked for (`torch.no_grad()`,
    or inputs that need none) only the forward runs and no log-sum-exp is
    kept. `rate > 0` drops attention probabilities with the mask of `seed`
    (an int or a one-element int64 tensor; required then); the backward
    redraws it. `head0`, `n_head_total`: the heads' place in the model (a
    tensor-parallel rank's local heads), for the dropout counters."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return fused_attention_forward(q, k, v, n_head, scale, causal, rate, seed=seed,
                                       head0=head0, n_head_total=n_head_total)
    return _FusedCausalAttention.apply(q, k, v, n_head, scale, causal, float(rate), seed, head0,
                                       n_head_total)


def masked_causal_attention(q, k, v, n_head: int, bias, rate=0.0, seed=None, scale=None,
                            head0=0, n_head_total=None):
    """Causal softmax(Q K^T * scale + bias) V on (B, T, D) projections with an
    additive `bias` (B, 1, 1, T) or (B, H, T, T): `StackGPT`'s
    `mask_pad_attention` (-1e9 on the keys that are content pads). This is
    the reference's route, not a kernel's: the JAX package sends every call
    with an attention bias to XLA's einsum attention (its Pallas kernel, #4,
    takes no mask), and here it is torch ops differentiated by autograd: the
    arithmetic of `fused_attention_forward_plain` (f32 scores, the dropout
    mask of the kernels' Philox counters, `dropout_keep_mask`), so at a zero
    bias it is the kernels' plain version at the same seed. A tensor seed is
    read on the device, so the route is captured in the stage-2 step's CUDA
    graph. `head0`, `n_head_total`: the heads' place in the model, as for
    the kernels. `masked_causal_attention.calls` counts calls (a CUDA graph's
    replays add the calls its capture made, as for the kernels' launches)."""
    rate, seed = _dropout_args(rate, seed, q.device)
    head0, total = _heads_of(n_head, head0, n_head_total)
    masked_causal_attention.calls += 1
    return fused_attention_forward_plain(q, k, v, n_head, scale, True, False, rate, seed, head0,
                                         total, bias=bias)


masked_causal_attention.calls = 0
