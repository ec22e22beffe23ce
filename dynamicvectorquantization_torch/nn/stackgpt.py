"""StackGPT — the DQ-Transformer's stacked Position- and Content-Transformer
(counterpart of `dynamicvectorquantization_tpu/nn/stackgpt.py`).

Reference torch names: `content_emb`, `content_coarse_pos_emb`,
`content_fine_pos_emb`, `seg_emb`, `pos_emb`, `position_transformer.{i}`,
`content_transformer.{i}`, `position_head.{0 LayerNorm, 1 Linear}`,
`content_head.{0, 1}`; heads are bias-free.

Training (`forward`): the position transformer sees, for token i,
content_emb(content[i]) + pos_table(position[i]) + pos_emb[i] + seg[i] over
the concatenated [coarse ; fine] streams with the content shifted off by
one; the content transformer sees position_hidden[i] + pos_table(position
[i + 1]). Losses are cross entropies that ignore the pad code; the position
loss is the mean of its coarse and fine halves. Pad rows of the embedding
tables are ordinary random rows: the trainer freezes them by zeroing their
gradient (`train/stage2.py`), as the reference's `padding_idx` does.

`mask_pad_attention` adds -1e9 to the self-attention scores of the keys
that are content pads, in both stacks (`pad_attention_bias`): the masked
route of `nn/transformer.py`, torch ops, as the JAX package sends any
attention bias to XLA. Under `--sp` / `--pp` it raises, as in JAX.

Text conditioning (`cross_attend_content`, `T2IDualformer`'s consuming
variant): the content transformer's blocks cross-attend (`ln_x`, `xattn`)
to `text_proj(text_memory)`, caption features (B, S, `text_feature_dim`)
masked by `text_mask` (B, S), in training (`forward`) and in one cached
decode step (`content_step`). The extra parameters exist only when the
flag is on, so the plain model's keys are unchanged.

Decode: `position_step` / `content_step` run ONE token through a stack
against its KV cache (updated in place).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.kv_int8 import CHUNK
from ..parallel.dist import global_count, world_size
from .norm import LayerNorm
from .transformer import KVCache, TransformerStack, dropout


def cross_entropy_ignore(logits, targets, ignore_index: int):
    """Mean cross entropy over the positions whose target is not
    `ignore_index`, reduced in f32 whatever the logits' dtype; 0 when every
    target is ignored (`F.cross_entropy` gives NaN there).

    Inside a `parallel.dist.global_stats` scope of N ranks the denominator
    is the count of valid targets of the GLOBAL batch, as the JAX function
    divides under GSPMD: each rank returns N * (its sum) / (global count),
    whose mean over the ranks is the global batch's loss (a mean of the
    ranks' own means differs whenever their padding differs)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ignored = targets == ignore_index
    nll = -logp.gather(-1, targets.masked_fill(ignored, 0)[..., None])[..., 0]
    keep = (~ignored).to(logp.dtype)
    total = (nll * keep).sum()
    n = world_size()
    if n > 1:
        total = total * n
    return total / global_count(keep.sum()).clamp(min=1.0)


def lookup_few_rows(table: nn.Embedding, index):
    """`table(index)` for a table of a few rows (the two segment embeddings),
    as a one-hot product: the rows come out exactly, and the gradient, a sum
    of thousands of rows into each table row, is one GEMM. `F.embedding`'s
    backward at that duplication was seen to differ in the last bit between
    otherwise identical runs on an H100, which breaks an exact resume."""
    w = table.weight
    return torch.nn.functional.one_hot(index, w.shape[0]).to(w.dtype) @ w


class StackGPT(nn.Module):
    def __init__(self, vocab_size=1027, coarse_position_size=259, fine_position_size=1027,
                 segment_size=2, block_size=2048, position_layer=6, content_layer=18,
                 n_head=8, n_embd=1024, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0,
                 content_pad_code=1024, coarse_position_pad_code=256,
                 fine_position_pad_code=1024, activate_pad_ignore=True,
                 mask_pad_attention=False, use_flash_attention=False,
                 kv_cache_dtype=None, cross_attend_content=False, text_feature_dim=512):
        super().__init__()
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None or 'int8', got {kv_cache_dtype!r}")
        # use_flash_attention is accepted so the reference configs load
        # unchanged: the full-sequence attention is always the fused one
        self.embd_pdrop = embd_pdrop
        self.content_pad_code = content_pad_code
        self.coarse_position_pad_code = coarse_position_pad_code
        self.fine_position_pad_code = fine_position_pad_code
        self.activate_pad_ignore = activate_pad_ignore
        self.mask_pad_attention = bool(mask_pad_attention)
        self.cross_attend_content = bool(cross_attend_content)
        self.text_feature_dim = int(text_feature_dim)
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
        self.position_transformer = TransformerStack(position_layer, n_embd, n_head,
                                                     attn_pdrop, resid_pdrop)
        self.content_transformer = TransformerStack(content_layer, n_embd, n_head,
                                                    attn_pdrop, resid_pdrop,
                                                    cross_attend=self.cross_attend_content)
        if self.cross_attend_content:
            self.text_proj = nn.Linear(self.text_feature_dim, n_embd)
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

    # ------------------------------------------------------------- training
    def forward(self, coarse_content, fine_content, coarse_position, fine_position,
                coarse_seg=None, fine_seg=None, content_target=None,
                coarse_position_target=None, fine_position_target=None, train=False,
                generator=None, seed=None, text_memory=None, text_mask=None):
        """Training forward over (B, L) integer streams. Without targets:
        `{"position_logits", "content_logits"}`; with them the four losses of
        `losses_from_logits`. When `train`, `generator` feeds the embedding
        and residual dropouts and the integer `seed` the attention dropout.
        `text_memory` (B, S, text_feature_dim) and `text_mask` (B, S): the
        captions' features, read under `cross_attend_content`."""
        x, shifted = self.embed_training_inputs(
            coarse_content, fine_content, coarse_position, fine_position, coarse_seg, fine_seg,
            train=train, generator=generator)
        out = self.forward_from_embeddings(
            x, shifted, train=train, generator=generator, seed=seed,
            attn_bias=self.pad_attention_bias(coarse_content, fine_content),
            text_memory=text_memory, text_mask=text_mask)
        if content_target is None:
            return out
        return self.losses_from_logits(
            out["position_logits"], out["content_logits"], content_target,
            coarse_position_target, fine_position_target, coarse_position.shape[1])

    def embed_training_inputs(self, coarse_content, fine_content, coarse_position,
                              fine_position, coarse_seg=None, fine_seg=None, train=False,
                              generator=None):
        """(position-transformer input, the SHIFTED position embeddings the
        content transformer adds), both (B, T, D) with T = Lc + Lf - 1."""
        content = torch.cat([coarse_content, fine_content], dim=1)
        position = torch.cat([self.content_coarse_pos_emb(coarse_position),
                              self.content_fine_pos_emb(fine_position[:, :-1])], dim=1)
        t = position.shape[1]
        x = self.content_emb(content[:, :-1]) + (position + self.pos_emb[:, :t, :])
        if self.activate_segment:
            segment = torch.cat([coarse_seg, fine_seg], dim=1)
            x = x + lookup_few_rows(self.seg_emb, segment[:, :-1])
        x = dropout(x, self.embd_pdrop, train, generator)
        shifted = torch.cat([self.content_coarse_pos_emb(coarse_position[:, 1:]),
                             self.content_fine_pos_emb(fine_position)], dim=1)
        return x, shifted

    def pad_attention_bias(self, coarse_content, fine_content):
        """Under `mask_pad_attention` the (B, 1, 1, T) f32 self-attention bias,
        -1e9 on the keys whose input content is the pad code; else None."""
        if not self.mask_pad_attention:
            return None
        is_pad = torch.cat([coarse_content, fine_content], dim=1)[:, :-1] == self.content_pad_code
        bias = torch.zeros(is_pad.shape, dtype=torch.float32, device=is_pad.device)
        return bias.masked_fill_(is_pad, -1e9)[:, None, None, :]

    def project_text(self, text_memory, dtype):
        """The content transformer's cross-attention memory: `text_proj` of
        the caption features in the model's dtype (None without them)."""
        if not self.cross_attend_content or text_memory is None:
            return None
        return self.text_proj(text_memory.to(dtype))

    def forward_from_embeddings(self, x, shifted_position_embeddings, train=False,
                                generator=None, seed=None, attn_bias=None, text_memory=None,
                                text_mask=None):
        # layers count through both stacks (position 0.., then content), so
        # no two of them share an attention-dropout seed
        position_hidden = self.position_transformer(x, train=train, generator=generator,
                                                    seed=seed, attn_bias=attn_bias)
        content_hidden = self.content_transformer(
            position_hidden + shifted_position_embeddings, train=train, generator=generator,
            seed=seed, first_layer=self.position_layer, attn_bias=attn_bias,
            memory=self.project_text(text_memory, x.dtype), memory_mask=text_mask)
        return {"position_logits": self.position_head(position_hidden),
                "content_logits": self.content_head(content_hidden)}

    def losses_from_logits(self, position_logits, content_logits, content_target,
                           coarse_position_target, fine_position_target, coarse_length: int):
        """The training losses. With `activate_pad_ignore` the position logits
        split at `coarse_length - 1` and every CE ignores its pad code; without
        it they split at `coarse_length` and only the CONTENT CE drops its
        ignore index, both position CEs keep theirs (a replicated reference
        quirk)."""
        split = coarse_length - 1 if self.activate_pad_ignore else coarse_length
        content_ignore = self.content_pad_code if self.activate_pad_ignore else -1
        cpl = cross_entropy_ignore(position_logits[:, :split], coarse_position_target,
                                   self.coarse_position_pad_code)
        fpl = cross_entropy_ignore(position_logits[:, split:], fine_position_target,
                                   self.fine_position_pad_code)
        closs = cross_entropy_ignore(content_logits, content_target, content_ignore)
        return {"position_loss": (cpl + fpl) / 2.0, "content_loss": closs,
                "coarse_position_loss": cpl, "fine_position_loss": fpl}

    # ------------------------------------------------------------- decoding
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

    def embed_input_token(self, content_tok, pos_tok, seg_tok, index, is_fine: bool):
        """Position-transformer input for ONE token at global position
        `index` (a host int, or a 0-d int tensor on the device, read there by
        `index_select`): (B,) tokens -> (B, 1, D)."""
        pe = self.content_fine_pos_emb if is_fine else self.content_coarse_pos_emb
        if isinstance(index, torch.Tensor):
            pos = self.pos_emb[0].index_select(0, index.reshape(1))
        else:
            pos = self.pos_emb[0, index]
        x = self.content_emb(content_tok) + pe(pos_tok) + pos
        if self.activate_segment and seg_tok is not None:
            x = x + self.seg_emb(seg_tok)
        return x[:, None, :]

    def position_step(self, x, cache: KVCache, index, n_chunks=None):
        """One cached position-transformer step; x (B, 1, D) ->
        (hidden (B, 1, D), position logits (B, P)). `index`, `n_chunks`: see
        `nn/transformer.py` `CausalSelfAttention.forward`."""
        hidden = self.position_transformer(x, cache, index, n_chunks=n_chunks)
        return hidden, self.position_head(hidden[:, 0])

    def content_step(self, position_hidden, next_pos_tok, is_fine: bool, cache: KVCache,
                     index, n_chunks=None, text_memory=None, text_mask=None):
        """One cached content-transformer step on hidden + emb(next position);
        returns content logits (B, V). `text_memory` / `text_mask`: caption
        features for the cross-attention under `cross_attend_content`
        (projected again each step: the memory is short)."""
        pe = self.content_fine_pos_emb if is_fine else self.content_coarse_pos_emb
        x = position_hidden + pe(next_pos_tok)[:, None, :]
        hidden = self.content_transformer(x, cache, index, n_chunks=n_chunks,
                                          memory=self.project_text(text_memory, x.dtype),
                                          memory_mask=text_mask)
        return self.content_head(hidden[:, 0])
