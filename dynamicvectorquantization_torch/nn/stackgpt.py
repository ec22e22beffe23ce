"""StackGPT — the DQ-Transformer's stacked Position- and Content-Transformer,
decode half (counterpart of `dynamicvectorquantization_tpu/nn/stackgpt.py`).

Reference torch names: `content_emb`, `content_coarse_pos_emb`,
`content_fine_pos_emb`, `seg_emb`, `pos_emb`, `position_transformer.{i}`,
`content_transformer.{i}`, `position_head.{0 LayerNorm, 1 Linear}`,
`content_head.{0, 1}`; heads are bias-free.

Decode: `position_step` / `content_step` run ONE token through a stack
against its KV cache (updated in place). The training forward and losses
come with the stage-2 training slice.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.kv_int8 import CHUNK
from .norm import LayerNorm
from .transformer import KVCache, TransformerStack


class StackGPT(nn.Module):
    def __init__(self, vocab_size=1027, coarse_position_size=259, fine_position_size=1027,
                 segment_size=2, block_size=2048, position_layer=6, content_layer=18,
                 n_head=8, n_embd=1024, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0,
                 content_pad_code=1024, coarse_position_pad_code=256,
                 fine_position_pad_code=1024, activate_pad_ignore=True,
                 mask_pad_attention=False, use_flash_attention=False,
                 kv_cache_dtype=None):
        super().__init__()
        if mask_pad_attention:
            raise NotImplementedError("mask_pad_attention is a training option; not ported")
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None or 'int8', got {kv_cache_dtype!r}")
        # dropout rates, pad codes and use_flash_attention configure training
        # only; they are accepted so the reference configs load unchanged
        self.n_head = n_head
        self.n_embd = n_embd
        self.position_layer = position_layer
        self.content_layer = content_layer
        self.kv_cache_dtype = kv_cache_dtype
        self.activate_segment = segment_size > 0
        self.content_emb = nn.Embedding(vocab_size, n_embd)
        self.content_coarse_pos_emb = nn.Embedding(coarse_position_size, n_embd)
        self.content_fine_pos_emb = nn.Embedding(fine_position_size, n_embd)
        self.pos_emb = nn.Parameter(torch.zeros(1, block_size, n_embd))
        if self.activate_segment:
            self.seg_emb = nn.Embedding(segment_size, n_embd)
        self.position_transformer = TransformerStack(position_layer, n_embd, n_head)
        self.content_transformer = TransformerStack(content_layer, n_embd, n_head)
        self.position_head = nn.Sequential(
            LayerNorm(n_embd, eps=1e-5), nn.Linear(n_embd, fine_position_size, bias=False))
        self.content_head = nn.Sequential(
            LayerNorm(n_embd, eps=1e-5), nn.Linear(n_embd, vocab_size, bias=False))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Reference init: every embedding row and Linear weight normal(0.02),
        biases zero, LayerNorms identity, `pos_emb` zero."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, 0.02, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.pos_emb.zero_()

    def make_caches(self, batch: int, max_len: int, dtype=torch.float32, device=None):
        """(position cache, content cache); capacity rounded up to the
        256-position decode chunk."""
        hd = self.n_embd // self.n_head
        max_len = -(-max_len // CHUNK) * CHUNK
        if self.kv_cache_dtype == "int8":
            return (
                KVCache.create_int8(self.position_layer, batch, self.n_head, max_len, hd, device),
                KVCache.create_int8(self.content_layer, batch, self.n_head, max_len, hd, device),
            )
        return (
            KVCache.create(self.position_layer, batch, self.n_head, max_len, hd, dtype, device),
            KVCache.create(self.content_layer, batch, self.n_head, max_len, hd, dtype, device),
        )

    def embed_input_token(self, content_tok, pos_tok, seg_tok, index: int, is_fine: bool):
        """Position-transformer input for ONE token at global position
        `index`: (B,) tokens -> (B, 1, D)."""
        pe = self.content_fine_pos_emb if is_fine else self.content_coarse_pos_emb
        x = self.content_emb(content_tok) + pe(pos_tok) + self.pos_emb[0, index]
        if self.activate_segment and seg_tok is not None:
            x = x + self.seg_emb(seg_tok)
        return x[:, None, :]

    def position_step(self, x, cache: KVCache, index: int):
        """One cached position-transformer step; x (B, 1, D) ->
        (hidden (B, 1, D), position logits (B, P))."""
        hidden = self.position_transformer(x, cache, index)
        return hidden, self.position_head(hidden[:, 0])

    def content_step(self, position_hidden, next_pos_tok, is_fine: bool, cache: KVCache,
                     index: int):
        """One cached content-transformer step on hidden + emb(next position);
        returns content logits (B, V)."""
        pe = self.content_fine_pos_emb if is_fine else self.content_coarse_pos_emb
        x = position_hidden + pe(next_pos_tok)[:, None, :]
        hidden = self.content_transformer(x, cache, index)
        return self.content_head(hidden[:, 0])
