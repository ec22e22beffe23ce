"""GPT blocks with single-token KV-cache decode (counterpart of
`dynamicvectorquantization_tpu/nn/transformer.py`, decode half).

Pre-LN blocks (LayerNorm eps 1e-5), causal self-attention, GELU MLP (4x),
with the reference torch parameter names (`ln1`, `ln2`, `attn.{query,key,
value,proj}`, `mlp.0`, `mlp.2`). Caches are updated IN PLACE (the JAX
package returns new cache arrays; here that would copy hundreds of MB per
step). The full-sequence training forward comes with the stage-2 training
slice.

Caches per layer: float `(k, v)`, each (B, H, T_max, hd); or int8
`(k_i8, v_i8, k_scale, v_scale)` with f32 scales (B, H, T_max) that start
at ONE, as the reference's.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.kv_int8 import CHUNK, decode_attention_int8, quantize_kv
from .activations import GELU
from .norm import LayerNorm


class KVCache:
    def __init__(self, layers):
        self.layers = list(layers)

    @classmethod
    def create(cls, num_layers, batch, num_heads, max_len, head_dim,
               dtype=torch.float32, device=None):
        shape = (batch, num_heads, max_len, head_dim)
        return cls(
            (torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(num_layers)
        )

    @classmethod
    def create_int8(cls, num_layers, batch, num_heads, max_len, head_dim, device=None):
        shape = (batch, num_heads, max_len, head_dim)
        sshape = (batch, num_heads, max_len)
        return cls(
            (torch.zeros(shape, dtype=torch.int8, device=device),
             torch.zeros(shape, dtype=torch.int8, device=device),
             torch.ones(sshape, dtype=torch.float32, device=device),
             torch.ones(sshape, dtype=torch.float32, device=device))
            for _ in range(num_layers)
        )


def chunked_decode_attention(q, k_cache, v_cache, cache_index: int):
    """Single-token decode attention over float caches, reading only the
    chunks up to `cache_index`, with an online softmax (counterpart of
    `_chunked_decode_attention`; the products run in the cache dtype and
    accumulate in f32, as there). q: (B, H, 1, hd); caches (B, H, T, hd)."""
    b, h, t, hd = k_cache.shape
    if t % CHUNK:
        raise ValueError(f"cache length {t} is not a multiple of {CHUNK}")
    scale = 1.0 / float(hd) ** 0.5
    neg = torch.finfo(torch.float32).min
    m = torch.full((b, h, 1), neg, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, 1, hd), dtype=torch.float32, device=q.device)
    for start in range(0, (cache_index // CHUNK + 1) * CHUNK, CHUNK):
        sl = slice(start, start + CHUNK)
        k = k_cache[:, :, sl]
        v = v_cache[:, :, sl]
        s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
        pos = torch.arange(start, start + CHUNK, device=q.device)
        s = torch.where(pos <= cache_index, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
        m = m_new
    return (acc / l[..., None]).to(q.dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, n_embd: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_embd, n_embd)
        self.key = nn.Linear(n_embd, n_embd)
        self.value = nn.Linear(n_embd, n_embd)
        self.proj = nn.Linear(n_embd, n_embd)

    def forward(self, x, cache=None, cache_index=None):
        """Decode step: x (B, 1, C) against `cache` (updated in place at
        `cache_index`, a host int)."""
        if cache is None:
            raise NotImplementedError(
                "the full-sequence attention forward comes with the stage-2 "
                "training slice (ROADMAP.md)")
        b, t, c = x.shape
        if t != 1:
            raise ValueError(f"KV-cached decode takes one token per step, got {t}")
        hd = c // self.n_head

        def heads(z):
            return z.reshape(b, t, self.n_head, hd).transpose(1, 2)

        q = heads(self.query(x))
        k = heads(self.key(x))
        v = heads(self.value(x))
        idx = int(cache_index)
        if len(cache) == 4:
            k_c, v_c, ks_c, vs_c = cache
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            k_c[:, :, idx] = kq[:, :, 0]
            v_c[:, :, idx] = vq[:, :, 0]
            ks_c[:, :, idx] = ks[:, :, 0]
            vs_c[:, :, idx] = vs[:, :, 0]
            y = decode_attention_int8(q.contiguous(), k_c, v_c, ks_c, vs_c, idx)
        else:
            k_c, v_c = cache
            k_c[:, :, idx] = k[:, :, 0]
            v_c[:, :, idx] = v[:, :, 0]
            y = chunked_decode_attention(q, k_c, v_c, idx)
        return self.proj(y.transpose(1, 2).reshape(b, t, c))


class Block(nn.Module):
    def __init__(self, n_embd: int, n_head: int):
        super().__init__()
        self.ln1 = LayerNorm(n_embd, eps=1e-5)
        self.attn = CausalSelfAttention(n_embd, n_head)
        self.ln2 = LayerNorm(n_embd, eps=1e-5)
        self.mlp = nn.Sequential(
            nn.Linear(n_embd, 4 * n_embd), GELU(), nn.Linear(4 * n_embd, n_embd))

    def forward(self, x, cache=None, cache_index=None):
        x = x + self.attn(self.ln1(x), cache, cache_index)
        return x + self.mlp(self.ln2(x))


class TransformerStack(nn.ModuleList):
    """N blocks; children are named `0..N-1` as in the reference."""

    def __init__(self, num_layers: int, n_embd: int, n_head: int):
        super().__init__(Block(n_embd, n_head) for _ in range(num_layers))

    def forward(self, x, cache: KVCache, cache_index):
        for block, layer_cache in zip(self, cache.layers):
            x = block(x, layer_cache, cache_index)
        return x
