"""ViT encoder / decoder and PositionAwareGPT, the legacy experimental family
(counterpart of `dynamicvectorquantization_tpu/nn/vit.py`).

  * `VisionTransformerEncoder`: patch embedding, a learned 2-D position
    table, pre-LN blocks with FULL (non-causal) attention; NHWC images in,
    (B, h, w, embed_dim) tokens out;
  * `VisionTransformerDecoder`: the blocks, then linear -> tanh -> linear
    and the patches back to an NHWC image;
  * `PositionAwareGPT`: one causal transformer over token + position
    embeddings with a value head and a position head.

Names are the JAX modules' (`patch_embed`, `pos_emb.{row,col}_embed`,
`blocks.{i}.{ln1,query,key,value,proj,ln2,mlp_fc,mlp_proj}`,
`output_linear1`, `conv_out`; the GPT's `tok_emb`, `token_pos_emb`,
`pos_emb`, `blocks.{i}`, `ln_f`, `head`, `ln_f_pos`, `head_pos`). The
codec's attention goes through `ops.attention.fused_causal_attention` with
`causal=False`, as the DQ-VAE's `AttnBlock` calls it: on a CUDA tensor the
square-tile kernels (#4 / #5) at the default hd 32 (256 / 8 heads), with the
attention-probability dropout inside them from the forward's integer `seed`
in training; their plain versions on a CPU tensor (the JAX block is plain
XLA). `PositionAwareGPT` runs `nn/transformer.py`'s blocks (#4 / #5, #6 /
#7). Seeded init as JAX's: every codec Dense `trunc_normal(0.02)` with a
zero bias, the position table truncated N(0, 1), the GPT as minGPT.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import fused_causal_attention, mix_seed
from .activations import GELU
from .fourier import PositionEmbedding2DLearned
from .init import gpt_init_, trunc_normal_
from .norm import LayerNorm
from .transformer import TransformerStack, dropout


class _BidirBlock(nn.Module):
    """Pre-LN transformer block with full attention."""

    def __init__(self, n_embd: int, n_head: int, drop: float = 0.0, attn_drop: float = 0.0):
        super().__init__()
        self.n_head = n_head
        self.drop = drop
        self.attn_drop = attn_drop
        self.ln1 = LayerNorm(n_embd, eps=1e-5)
        self.query = nn.Linear(n_embd, n_embd)
        self.key = nn.Linear(n_embd, n_embd)
        self.value = nn.Linear(n_embd, n_embd)
        self.proj = nn.Linear(n_embd, n_embd)
        self.ln2 = LayerNorm(n_embd, eps=1e-5)
        self.mlp_fc = nn.Linear(n_embd, 4 * n_embd)
        self.act = GELU()
        self.mlp_proj = nn.Linear(4 * n_embd, n_embd)

    def forward(self, x, train=False, generator=None, seed=None):
        h = self.ln1(x)
        rate = self.attn_drop if train else 0.0
        if rate > 0.0 and seed is None:
            raise ValueError("attention dropout in training needs the forward's integer seed")
        y = fused_causal_attention(self.query(h), self.key(h), self.value(h), self.n_head,
                                   scale=(x.shape[-1] // self.n_head) ** -0.5, causal=False,
                                   rate=rate, seed=seed)
        x = x + dropout(self.proj(y), self.drop, train, generator)
        h = self.mlp_proj(self.act(self.mlp_fc(self.ln2(x))))
        return x + dropout(h, self.drop, train, generator)


class _Codec(nn.Module):
    def _init_codec(self, generator):
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    trunc_normal_(mod.weight, generator, std=0.02)
                    mod.bias.zero_()
                elif isinstance(mod, LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
            self.pos_emb.init_weights(generator)

    def _blocks(self, x, train, generator, seed):
        for i, block in enumerate(self.blocks):
            x = block(x, train, generator, None if seed is None else mix_seed(seed, i))
        return x

    def _add_pos(self, x):
        """x (B, h, w, C) + the position table."""
        return x + self.pos_emb.table(x.shape[1], x.shape[2]).permute(1, 2, 0)[None]


class VisionTransformerEncoder(_Codec):
    def __init__(self, image_size=256, patch_size=8, input_channel=3, embed_dim=256, depth=8,
                 num_heads=8, drop_rate=0.0, attn_drop_rate=0.0, init_type="default",
                 pos_embed_type="learned"):
        super().__init__()
        self.hw = image_size // patch_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.patch_embed = nn.Linear(patch_size * patch_size * input_channel, embed_dim)
        self.pos_emb = PositionEmbedding2DLearned(self.hw, embed_dim)
        self.blocks = nn.ModuleList(_BidirBlock(embed_dim, num_heads, drop_rate, attn_drop_rate)
                                    for _ in range(depth))

    def init_weights(self, generator: torch.Generator):
        self._init_codec(generator)

    def forward(self, images, train=False, generator=None, seed=None):
        """(B, H, W, C) images -> (B, h, w, embed_dim) tokens."""
        hw, p = self.hw, self.patch_size
        b, _, _, c = images.shape
        x = images.reshape(b, hw, p, hw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = self._add_pos(self.patch_embed(x.reshape(b, hw, hw, p * p * c)))
        x = self._blocks(x.reshape(b, hw * hw, self.embed_dim), train, generator, seed)
        return x.reshape(b, hw, hw, self.embed_dim)


class VisionTransformerDecoder(_Codec):
    def __init__(self, image_size=256, patch_size=8, embed_dim=256, depth=8, num_heads=8,
                 output_channel=3, drop_rate=0.0, attn_drop_rate=0.0, init_type="default",
                 pos_embed_type="learned"):
        super().__init__()
        self.hw = image_size // patch_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.output_channel = output_channel
        out_dim = patch_size * patch_size * output_channel
        self.pos_emb = PositionEmbedding2DLearned(self.hw, embed_dim)
        self.blocks = nn.ModuleList(_BidirBlock(embed_dim, num_heads, drop_rate, attn_drop_rate)
                                    for _ in range(depth))
        self.output_linear1 = nn.Linear(embed_dim, out_dim)
        self.conv_out = nn.Linear(out_dim, out_dim)

    def init_weights(self, generator: torch.Generator):
        self._init_codec(generator)

    def forward(self, x, train=False, generator=None, seed=None):
        """(B, h, w, embed_dim) (or (B, h*w, embed_dim)) tokens -> (B, H, W,
        C) image."""
        hw, p = self.hw, self.patch_size
        b = x.shape[0]
        x = self._add_pos(x.reshape(b, hw, hw, self.embed_dim))
        x = self._blocks(x.reshape(b, hw * hw, self.embed_dim), train, generator, seed)
        x = self.conv_out(torch.tanh(self.output_linear1(x)))
        x = x.reshape(b, hw, hw, p, p, self.output_channel).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, hw * p, hw * p, self.output_channel)


class PositionAwareGPT(nn.Module):
    """One causal transformer over token + position embeddings, with
    separate value and position heads."""

    def __init__(self, vocab_size=1024, position_size=256, block_size=512, n_layer=12,
                 n_head=8, n_embd=256, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0,
                 n_unmasked=0):
        super().__init__()
        self.embd_pdrop = embd_pdrop
        self.tok_emb = nn.Embedding(vocab_size, n_embd)
        self.token_pos_emb = nn.Embedding(position_size, n_embd)
        self.pos_emb = nn.Parameter(torch.zeros(1, block_size, n_embd))
        self.blocks = TransformerStack(n_layer, n_embd, n_head, attn_pdrop, resid_pdrop)
        self.ln_f = LayerNorm(n_embd, eps=1e-5)
        self.head = nn.Linear(n_embd, vocab_size, bias=False)
        self.ln_f_pos = LayerNorm(n_embd, eps=1e-5)
        self.head_pos = nn.Linear(n_embd, position_size, bias=False)

    def init_weights(self, generator: torch.Generator):
        gpt_init_(self, generator)

    def forward(self, idx, pos_idx, embeddings=None, train=False, generator=None, seed=None):
        """(value logits, position logits), each over the whole sequence."""
        x = self.tok_emb(idx) + self.token_pos_emb(pos_idx)
        if embeddings is not None:
            x = torch.cat([embeddings.to(x.dtype), x], dim=1)
        x = dropout(x + self.pos_emb[:, :x.shape[1]], self.embd_pdrop, train, generator)
        x = self.blocks(x, train=train, generator=generator, seed=seed)
        return self.head(self.ln_f(x)), self.head_pos(self.ln_f_pos(x))
