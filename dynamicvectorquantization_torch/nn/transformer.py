"""GPT blocks with full-sequence training and single-token KV-cache decode
(counterpart of `dynamicvectorquantization_tpu/nn/transformer.py`).

Pre-LN blocks (LayerNorm eps 1e-5), causal self-attention, GELU MLP (4x),
with the reference torch parameter names (`ln1`, `ln2`, `attn.{query,key,
value,proj}`, `mlp.0`, `mlp.2`).

Full sequence (`cache is None`): the attention is
`ops.attention.fused_causal_attention` on the (B, T, D) projection outputs,
with no head transpose: the CUDA kernels on a CUDA tensor, forward and
backward, their plain versions on a CPU tensor. Residual dropout
(`resid_pdrop`, after `proj` and after the MLP) draws from an explicit
`torch.Generator`. Attention-probability dropout (`attn_pdrop`, with
`train=True`) runs inside the attention kernels, forward and backward: each
layer's mask comes from the integer `seed` of the training forward mixed with
the layer's index in the model (`ops.attention.mix_seed`), both host
integers, so no device sync is added and two layers never share a mask. The
seed may instead be a table, an int64 tensor with one row per layer of the
model holding those mixed seeds (`Stage2Trainer`'s captured step fills it on
the host before each replay): layer i then hands its row to the kernels,
which read it on the device.
An additive `attn_bias` (StackGPT's `mask_pad_attention`: -1e9 on the keys
that are content pads) sends the full-sequence attention to
`ops.attention.masked_causal_attention`, torch ops differentiated by
autograd, with the kernels' dropout mask drawn from the same seed (an int,
or a seed-table row read on the device): the reference's route, since the
JAX package sends any `attn_bias` to XLA and its Pallas kernel takes no
mask. Calls without a bias stay on the kernels. `Block(cross_attend=True)`
adds, after the self-attention, `ln_x` and `xattn`, a `CrossAttention` to a
short external memory (the projected caption features of `T2IDualformer`'s
consuming variant, at most 77 tokens), masked over the memory's padding to
`finfo.min`: plain torch ops, as the JAX module is plain XLA.

Model parallelism (counterpart of the JAX blocks' `stage2_param_shardings`
under GSPMD and `sequence_parallel_axis`): with `tp` set (a
`parallel.dist.World`, by `parallel/mesh.py` `shard_stage2`) a block holds
its tensor-parallel shards: `query`, `key`, `value` and `mlp.0` split by
output (their rows), `proj` and `mlp.2` by input (their columns), whose
biases stay whole and are added once after the sum. Attention runs the
fused kernels on the rank's `n_head / tp` heads at the model's head dim,
heads `rank * n_head / tp ..` of the model (the kernels' head offset, so
the dropout masks are those of the whole model's heads), and the GELU on
the rank's `4 n_embd / tp` columns. `copy_to_group` comes before the split
Linears and `reduce_from_group` after the row-split ones, so everything
outside them is replicated and equal on every rank. Inside a
`parallel.ring_attention.sequence_parallel` scope the full-sequence path
runs ring attention over the sp group on the rank's rows (no
attention-probability dropout there, as in the JAX package).

Decode: caches are updated IN PLACE (the JAX package returns new cache
arrays; here that would copy hundreds of MB per step). `cache_index` is a
host int or, as the JAX sampler's traced loop index, a 0-d int32 tensor on
the caches' device: then the row is written by `index_copy_`, the int8
kernel reads the index on the device, and the float path reads `n_chunks`
chunks (a host int the caller gives) with the mask `pos <= cache_index`
evaluated on the device, so a step launches the same work whatever the
index (what a CUDA graph replays).

Caches per layer: float `(k, v)`, each (B, H, T_max, hd); or int8
`(k_i8, v_i8, k_scale, v_scale)` with f32 scales (B, H, T_max) that start
at ONE, as the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_causal_attention, masked_causal_attention, mix_seed
from ..ops.kv_int8 import CHUNK, decode_attention_int8, quantize_kv
from ..parallel.dist import copy_to_group, reduce_from_group
from ..parallel.ring_attention import active_sequence_world, ring_attention
from .activations import GELU
from .norm import LayerNorm


def dropout(x, rate: float, train: bool, generator):
    """`nn.Dropout` with an explicit generator: zero with probability `rate`,
    survivors scaled by 1 / (1 - rate); the identity unless `train`."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit torch.Generator")
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


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


def chunked_decode_attention(q, k_cache, v_cache, cache_index, n_chunks=None):
    """Single-token decode attention over float caches with an online softmax
    (counterpart of `_chunked_decode_attention`; the products run in the
    cache dtype and accumulate in f32, as there). q: (B, H, 1, hd); caches
    (B, H, T, hd). `cache_index`: the last valid position, a host int or a
    0-d int tensor on q's device. `n_chunks` chunks of CHUNK positions are
    read (default: those up to a host index; every chunk of the cache for a
    tensor index); it must cover `cache_index`. A chunk past the index is
    fully masked and leaves the sums bit for bit as they were (alpha = 1,
    p = 0), so reading more chunks than the index needs is exact: this
    replaces the JAX loop's traced `fori_loop` bound."""
    b, h, t, hd = k_cache.shape
    if t % CHUNK:
        raise ValueError(f"cache length {t} is not a multiple of {CHUNK}")
    if n_chunks is None:
        n_chunks = (t // CHUNK if isinstance(cache_index, torch.Tensor)
                    else cache_index // CHUNK + 1)
    if not 1 <= n_chunks <= t // CHUNK:
        raise ValueError(f"n_chunks {n_chunks} outside [1, {t // CHUNK}]")
    scale = 1.0 / float(hd) ** 0.5
    neg = torch.finfo(torch.float32).min
    m = torch.full((b, h, 1), neg, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, 1, hd), dtype=torch.float32, device=q.device)
    for start in range(0, n_chunks * CHUNK, CHUNK):
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


def write_row(cache, row, value):
    """cache[:, :, row] = value[:, :, 0] in place; `row` a host int or a
    (1,) int64 tensor on the cache's device (no host read)."""
    if isinstance(row, torch.Tensor):
        cache.index_copy_(2, row, value)
    else:
        cache.select(2, row).copy_(value.select(2, 0))


class CausalSelfAttention(nn.Module):
    def __init__(self, n_embd: int, n_head: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0):
        super().__init__()
        self.n_head = n_head
        self.attn_pdrop = attn_pdrop
        self.resid_pdrop = resid_pdrop
        self.query = nn.Linear(n_embd, n_embd)
        self.key = nn.Linear(n_embd, n_embd)
        self.value = nn.Linear(n_embd, n_embd)
        self.proj = nn.Linear(n_embd, n_embd)
        self.tp = None  # the tensor-parallel group whose shards this module holds

    def forward(self, x, cache=None, cache_index=None, train=False, generator=None, seed=None,
                n_chunks=None, attn_bias=None):
        """Full sequence when `cache` is None: x (B, T, C), causal, plus the
        additive `attn_bias` (B, 1, 1, T) where given (the masked route, see
        the module note); `seed` is this layer's attention-dropout seed
        (needed when `train` and `attn_pdrop > 0`). Else a decode step: x
        (B, 1, C) against `cache` (updated in place at `cache_index`, a host
        int or a 0-d int32 tensor on the cache's device; `n_chunks`: the
        chunks a float cache reads, see `chunked_decode_attention`)."""
        if cache is None:
            rate = float(self.attn_pdrop) if train else 0.0
            if rate > 0.0 and seed is None:
                raise ValueError("attn_pdrop > 0 in training needs the forward's integer seed")
            sp = active_sequence_world()
            if sp is not None and attn_bias is not None:
                raise ValueError("sequence-parallel attention does not support attn_bias")
            if sp is not None and rate > 0.0:
                raise ValueError("sequence-parallel training requires attn_pdrop == 0 "
                                 "(ring attention has no attention-probability dropout)")
            tp = self.tp
            if tp is not None:
                x = copy_to_group(x, tp)
            n_head = self.n_head if tp is None else self.n_head // tp.size
            q, k, v = self.query(x), self.key(x), self.value(x)
            head0 = 0 if tp is None else tp.rank * n_head
            if sp is not None:
                y = ring_attention(q, k, v, n_head, sp)
            elif attn_bias is not None:
                y = masked_causal_attention(q, k, v, n_head, attn_bias, rate, seed, head0=head0,
                                            n_head_total=self.n_head)
            elif tp is None:
                y = fused_causal_attention(q, k, v, n_head, causal=True, rate=rate, seed=seed)
            else:  # the rank's heads, at their place in the model
                y = fused_causal_attention(q, k, v, n_head, causal=True, rate=rate, seed=seed,
                                           head0=head0, n_head_total=self.n_head)
            if tp is None:
                y = self.proj(y)
            else:
                y = reduce_from_group(F.linear(y, self.proj.weight), tp) + self.proj.bias
            return dropout(y, self.resid_pdrop, train, generator)
        if self.tp is not None:
            raise ValueError("KV-cached decode runs on whole weights: gather the "
                             "tensor-parallel shards first (Stage2Trainer.master_weights)")
        b, t, c = x.shape
        if t != 1:
            raise ValueError(f"KV-cached decode takes one token per step, got {t}")
        hd = c // self.n_head

        def heads(z):
            return z.reshape(b, t, self.n_head, hd).transpose(1, 2)

        q = heads(self.query(x))
        k = heads(self.key(x))
        v = heads(self.value(x))
        row = (cache_index.reshape(1).long() if isinstance(cache_index, torch.Tensor)
               else cache_index)
        if len(cache) == 4:
            k_c, v_c, ks_c, vs_c = cache
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            for dst, src in ((k_c, kq), (v_c, vq), (ks_c, ks), (vs_c, vs)):
                write_row(dst, row, src)
            y = decode_attention_int8(q.contiguous(), k_c, v_c, ks_c, vs_c, cache_index)
        else:
            k_c, v_c = cache
            write_row(k_c, row, k)
            write_row(v_c, row, v)
            y = chunked_decode_attention(q, k_c, v_c, cache_index, n_chunks)
        return self.proj(y.transpose(1, 2).reshape(b, t, c))


class CrossAttention(nn.Module):
    """Queries from the token stream, keys and values from an external
    memory (B, S, C), `memory_mask` (B, S) with 1 = valid; the scores of
    masked slots are `finfo.min` before the softmax (f32), so a padded slot
    adds nothing. Residual dropout after `proj`."""

    def __init__(self, n_embd: int, n_head: int, resid_pdrop: float = 0.0):
        super().__init__()
        self.n_head = n_head
        self.resid_pdrop = resid_pdrop
        self.query = nn.Linear(n_embd, n_embd)
        self.key = nn.Linear(n_embd, n_embd)
        self.value = nn.Linear(n_embd, n_embd)
        self.proj = nn.Linear(n_embd, n_embd)

    def forward(self, x, memory, memory_mask=None, train=False, generator=None):
        b, t, c = x.shape
        hd = c // self.n_head

        def heads(z):
            return z.reshape(b, z.shape[1], self.n_head, hd).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(memory)), heads(self.value(memory))
        att = torch.matmul(q, k.transpose(-1, -2)) / float(hd) ** 0.5
        if memory_mask is not None:
            att = att.masked_fill(memory_mask[:, None, None, :] <= 0, torch.finfo(att.dtype).min)
        att = torch.softmax(att.float(), dim=-1).to(v.dtype)
        y = torch.matmul(att, v).transpose(1, 2).reshape(b, t, c)
        return dropout(self.proj(y), self.resid_pdrop, train, generator)


class Block(nn.Module):
    def __init__(self, n_embd: int, n_head: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, cross_attend: bool = False):
        super().__init__()
        self.resid_pdrop = resid_pdrop
        self.cross_attend = cross_attend
        self.ln1 = LayerNorm(n_embd, eps=1e-5)
        self.attn = CausalSelfAttention(n_embd, n_head, attn_pdrop, resid_pdrop)
        if cross_attend:  # parameters only when enabled: the plain model's keys are unchanged
            self.ln_x = LayerNorm(n_embd, eps=1e-5)
            self.xattn = CrossAttention(n_embd, n_head, resid_pdrop)
        self.ln2 = LayerNorm(n_embd, eps=1e-5)
        self.mlp = nn.Sequential(
            nn.Linear(n_embd, 4 * n_embd), GELU(), nn.Linear(4 * n_embd, n_embd))
        self.tp = None  # the tensor-parallel group whose shards this block holds

    def _mlp(self, h):
        if self.tp is None:
            return self.mlp(h)
        fc, act, proj = self.mlp
        h = act(fc(copy_to_group(h, self.tp)))
        return reduce_from_group(F.linear(h, proj.weight), self.tp) + proj.bias

    def forward(self, x, cache=None, cache_index=None, train=False, generator=None, seed=None,
                n_chunks=None, attn_bias=None, memory=None, memory_mask=None):
        x = x + self.attn(self.ln1(x), cache, cache_index, train, generator, seed, n_chunks,
                          attn_bias)
        if self.cross_attend and memory is not None:
            x = x + self.xattn(self.ln_x(x), memory, memory_mask, train, generator)
        return x + dropout(self._mlp(self.ln2(x)), self.resid_pdrop, train, generator)


class TransformerStack(nn.ModuleList):
    """N blocks; children are named `0..N-1` as in the reference."""

    def __init__(self, num_layers: int, n_embd: int, n_head: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, cross_attend: bool = False):
        super().__init__(Block(n_embd, n_head, attn_pdrop, resid_pdrop, cross_attend)
                         for _ in range(num_layers))

    def forward(self, x, cache: KVCache = None, cache_index=None, train=False, generator=None,
                seed=None, first_layer: int = 0, n_chunks=None, attn_bias=None, memory=None,
                memory_mask=None):
        """Full sequence when `cache` is None, else one cached decode step
        (`cache_index`, `n_chunks`: see `CausalSelfAttention.forward`).
        `attn_bias`: the additive self-attention bias of every block (the
        masked route); `memory`, `memory_mask`: what blocks built with
        `cross_attend` attend to.
        `seed`: the training forward's attention-dropout seed; block i mixes
        `first_layer + i`, its index in the whole model, into it. Or a seed
        table (an int64 tensor, a row per layer of the model): block i takes
        row `first_layer + i`."""
        layers = cache.layers if cache is not None else [None] * len(self)
        for i, (block, layer_cache) in enumerate(zip(self, layers)):
            if isinstance(seed, torch.Tensor):
                layer_seed = seed[first_layer + i]
            else:
                layer_seed = None if seed is None else mix_seed(seed, first_layer + i)
            x = block(x, layer_cache, cache_index, train, generator, layer_seed, n_chunks,
                      attn_bias, memory, memory_mask)
        return x
