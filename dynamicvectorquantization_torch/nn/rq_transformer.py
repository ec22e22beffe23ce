"""RQ-Transformer: a spatial GPT over positions and a depth GPT over the
residual codes of each position (counterpart of
`dynamicvectorquantization_tpu/nn/rq_transformer.py`).

The reference trains an external RQ transformer through
``transformer(idx=(B, H, W, D) codes, c_idx, model_aux, return_loss=True)``
and ``transformer.sample(...)``; this is the JAX package's implementation of
that contract, under its names (`code_emb`, `cond_emb`, `pos_emb_cond`,
`pos_emb_hw`, `pos_emb_d`, `spatial_transformer.{i}`,
`depth_transformer.{i}`, `ln_f`, `head`):

  * spatial stack: causal over the condition tokens and the T = H*W
    positions; the input at position t is the depth-summed code embedding
    of position t - 1, the output at t the context h_t;
  * depth stack: per position, causal over D tokens: h_t, then the
    embeddings of codes (t, 0..D-2); one shared head predicts code (t, d).

Training is one pass: the spatial stack over (B, Lc + T - 1) and the depth
stack over (B * T, D), both on the fused attention (#4 / #5) and LayerNorm
(#6 / #7) kernels on a CUDA tensor; the attention-dropout seeds count the
spatial layers first, then the depth ones. Sampling (`sample_rq`) is a
KV-cached spatial decode with an exact depth forward per (position, depth),
in an eager loop. `model_aux` is accepted and unused (ROADMAP §3).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.kv_int8 import CHUNK
from .init import gpt_init_
from .norm import LayerNorm
from .stackgpt import cross_entropy_ignore
from .transformer import KVCache, TransformerStack, dropout


class RQTransformer(nn.Module):
    def __init__(self, vocab_size=1024, cond_vocab_size=1, spatial_size=64, depth=4,
                 cond_length=1, spatial_layer=12, depth_layer=2, n_head=8, n_embd=256,
                 embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0):
        super().__init__()
        self.vocab_size = vocab_size
        self.spatial_size = spatial_size
        self.depth = depth
        self.cond_length = cond_length
        self.spatial_layer = spatial_layer
        self.n_head = n_head
        self.n_embd = n_embd
        self.embd_pdrop = embd_pdrop
        self.code_emb = nn.Embedding(vocab_size, n_embd)
        self.cond_emb = nn.Embedding(cond_vocab_size, n_embd)
        self.pos_emb_cond = nn.Parameter(torch.zeros(1, cond_length, n_embd))
        self.pos_emb_hw = nn.Parameter(torch.zeros(1, spatial_size, n_embd))
        self.pos_emb_d = nn.Parameter(torch.zeros(1, depth, n_embd))
        self.spatial_transformer = TransformerStack(spatial_layer, n_embd, n_head, attn_pdrop,
                                                    resid_pdrop)
        self.depth_transformer = TransformerStack(depth_layer, n_embd, n_head, attn_pdrop,
                                                  resid_pdrop)
        self.ln_f = LayerNorm(n_embd, eps=1e-5)
        self.head = nn.Linear(n_embd, vocab_size, bias=False)

    def init_weights(self, generator: torch.Generator):
        """Embeddings, kernels and the head N(0, 0.02^2), biases zero,
        LayerNorms the identity, the three position tables zero."""
        gpt_init_(self, generator)

    # ---------------------------------------------------------------- training
    def _spatial_context(self, codes, c_idx, train, generator, seed):
        t = codes.shape[1]
        lc = c_idx.shape[1]
        cond = self.cond_emb(c_idx) + self.pos_emb_cond[:, :lc]
        u = self.code_emb(codes[:, :t - 1]).sum(dim=2) + self.pos_emb_hw[:, :t - 1]
        x = dropout(torch.cat([cond, u], dim=1), self.embd_pdrop, train, generator)
        h = self.spatial_transformer(x, train=train, generator=generator, seed=seed)
        return h[:, lc - 1:lc - 1 + t]

    def _depth_logits(self, h_t, codes_t, train=False, generator=None, seed=None):
        """h_t (N, E) contexts, codes_t (N, D) -> (N, D, vocab) logits."""
        d = codes_t.shape[1]
        v = torch.cat([h_t[:, None, :], self.code_emb(codes_t[:, :d - 1])], dim=1)
        out = self.depth_transformer(v + self.pos_emb_d, train=train, generator=generator,
                                     seed=seed, first_layer=self.spatial_layer)
        return self.head(self.ln_f(out))

    def forward(self, idx, c_idx=None, model_aux=None, return_loss=True, train=False,
                generator=None, seed=None):
        """idx (B, H, W, D) codes; c_idx (B, Lc) condition tokens (zeros when
        None). The cross entropy over every (position, depth), or the logits
        (B, T, D, vocab) without `return_loss`."""
        b, hh, ww, d = idx.shape
        codes = idx.reshape(b, hh * ww, d)
        if c_idx is None:
            c_idx = torch.zeros((b, self.cond_length), dtype=torch.long, device=idx.device)
        h = self._spatial_context(codes, c_idx, train, generator, seed)
        t = codes.shape[1]
        logits = self._depth_logits(h.reshape(b * t, self.n_embd), codes.reshape(b * t, d),
                                    train, generator, seed).reshape(b, t, d, self.vocab_size)
        if not return_loss:
            return logits
        return cross_entropy_ignore(logits.reshape(b, t * d, self.vocab_size),
                                    codes.reshape(b, t * d), -100)

    # ---------------------------------------------------------------- sampling
    def make_spatial_cache(self, batch: int, dtype=torch.float32, device=None):
        max_len = -(-(self.cond_length + self.spatial_size) // CHUNK) * CHUNK
        return KVCache.create(self.spatial_layer, batch, self.n_head, max_len,
                              self.n_embd // self.n_head, dtype,
                              device if device is not None else self.pos_emb_hw.device)

    def spatial_step(self, emb, cache: KVCache, index: int):
        """One cached spatial step from a raw embedding (B, E) -> (B, E)."""
        return self.spatial_transformer(emb[:, None, :], cache, index)[:, 0]

    def embed_cond_token(self, tok, position: int):
        return self.cond_emb(tok) + self.pos_emb_cond[0, position]

    def embed_codes_at(self, codes_td, position: int):
        """(B, D) codes of one position -> the spatial input embedding (B, E)."""
        return self.code_emb(codes_td).sum(dim=1) + self.pos_emb_hw[0, position]

    def depth_logits_step(self, h_t, codes_prefix, d_index: int):
        """Logits (B, vocab) for depth `d_index` from the context and a (B, D)
        buffer whose first `d_index` codes are valid (the depth stack is
        causal, so the rest do not matter)."""
        return self._depth_logits(h_t, codes_prefix)[:, d_index]


@torch.no_grad()
def sample_rq(transformer: RQTransformer, shape, cond, generator=None, temperature=1.0,
              top_k=None, top_p=None):
    """Codes (B, H, W, D): a KV-cached spatial decode, each position's D codes
    drawn one by one from an exact depth forward (always a draw, as in the
    JAX package: `top_k=1` is greedy)."""
    from ..models.sampling import sample_from_logits

    b, hh, ww, d = shape
    cond = torch.as_tensor(cond).long().to(transformer.pos_emb_hw.device)
    cache = transformer.make_spatial_cache(b, dtype=transformer.pos_emb_hw.dtype)
    h_t = None
    for i in range(cond.shape[1]):
        h_t = transformer.spatial_step(transformer.embed_cond_token(cond[:, i], i), cache, i)
    lc = cond.shape[1]
    out = torch.zeros((b, hh * ww, d), dtype=torch.long, device=cond.device)
    for t in range(hh * ww):
        codes_t = out[:, t]
        for di in range(d):
            logits = transformer.depth_logits_step(h_t, codes_t, di)
            codes_t[:, di] = sample_from_logits(generator, logits, temperature, top_k, top_p,
                                                True)
        if t + 1 < hh * ww:
            h_t = transformer.spatial_step(transformer.embed_codes_at(codes_t, t), cache,
                                           lc + t)
    return out.reshape(b, hh, ww, d)
