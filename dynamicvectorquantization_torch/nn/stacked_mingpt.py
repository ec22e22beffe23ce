"""StackedPositionGPT, the single-position-vocabulary ancestor of StackGPT
(counterpart of `dynamicvectorquantization_tpu/nn/stacked_mingpt.py`).

One position embedding table (`value_pos_emb`) where StackGPT has a coarse
and a fine one; a position transformer predicts the next position and a
value transformer the value at that (shifted) position. Names: `value_emb`,
`value_pos_emb`, `pos_emb`, `position_transformer.{i}`,
`value_transformer.{i}`, and the heads as StackGPT's, `position_head.{0
LayerNorm, 1 Linear}` and `value_head.{0, 1}`. Both stacks run the fused
attention (#4 / #5) and LayerNorm (#6 / #7) kernels on a CUDA tensor.
"""
from __future__ import annotations

import torch
from torch import nn

from .init import gpt_init_
from .norm import LayerNorm
from .stackgpt import cross_entropy_ignore
from .transformer import TransformerStack, dropout


class StackedPositionGPT(nn.Module):
    def __init__(self, vocab_size=1024, position_size=1024, block_size=512, position_layer=12,
                 value_layer=12, n_head=8, n_embd=256, embd_pdrop=0.0, resid_pdrop=0.0,
                 attn_pdrop=0.0, n_unmasked=0, add_absolute_position=True):
        super().__init__()
        self.block_size = block_size
        self.position_layer = position_layer
        self.embd_pdrop = embd_pdrop
        self.add_absolute_position = add_absolute_position
        self.value_pos_emb = nn.Embedding(position_size, n_embd)
        self.value_emb = nn.Embedding(vocab_size, n_embd)
        if add_absolute_position:
            self.pos_emb = nn.Parameter(torch.zeros(1, block_size, n_embd))
        self.position_transformer = TransformerStack(position_layer, n_embd, n_head,
                                                     attn_pdrop, resid_pdrop)
        self.value_transformer = TransformerStack(value_layer, n_embd, n_head, attn_pdrop,
                                                  resid_pdrop)
        self.position_head = nn.Sequential(LayerNorm(n_embd, eps=1e-5),
                                           nn.Linear(n_embd, position_size, bias=False))
        self.value_head = nn.Sequential(LayerNorm(n_embd, eps=1e-5),
                                        nn.Linear(n_embd, vocab_size, bias=False))

    def init_weights(self, generator: torch.Generator):
        gpt_init_(self, generator)

    def get_block_size(self):
        return self.block_size

    def forward(self, idx, pos_idx, idx_target=None, pos_idx_target=None, train=False,
                generator=None, seed=None, **_):
        """`idx` / `pos_idx` (B, L) each start with their SOS token; the
        targets are the shifted streams. Without targets
        {"position_logits", "value_logits"}, else the two losses."""
        x = self.value_emb(idx[:, :-1]) + self.value_pos_emb(pos_idx[:, :-1])
        if self.add_absolute_position:
            x = x + self.pos_emb[:, :x.shape[1]]
        x = dropout(x, self.embd_pdrop, train, generator)
        position_hidden = self.position_transformer(x, train=train, generator=generator,
                                                    seed=seed)
        value_in = position_hidden + self.value_pos_emb(pos_idx[:, 1:])
        value_hidden = self.value_transformer(value_in, train=train, generator=generator,
                                              seed=seed, first_layer=self.position_layer)
        position_logits = self.position_head(position_hidden)
        value_logits = self.value_head(value_hidden)
        if idx_target is None:
            return {"position_logits": position_logits, "value_logits": value_logits}
        return {"position_loss": cross_entropy_ignore(position_logits, pos_idx_target, -100),
                "value_loss": cross_entropy_ignore(value_logits, idx_target, -100)}
