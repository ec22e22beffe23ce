"""CLIP's text tower (counterpart of
`dynamicvectorquantization_tpu/nn/clip_text.py`): `CLIPTextTransformer`,
`CLIPTextEmbedding` and `CLIP_TEXT_CONFIGS`.

Parameter names are OpenAI CLIP's (`token_embedding`, `positional_embedding`,
`transformer.resblocks.{i}.{ln_1, attn.in_proj_weight, attn.in_proj_bias,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}`, `ln_final`, `text_projection`),
the module tree the reference vendors, so an OpenAI state_dict loads once
`utils.weights.clip_text_state_dict_from_openai` has dropped the visual
tower; `DQVQ_CLIP_WEIGHTS` (or `weights_path`) names such a file. Without it
the tower is seeded by `init_weights` from `seed`, with
the JAX module's initializers (token table normal(0.02), positions
normal(0.01), Dense layers lecun-normal with zero biases, the projection
normal(width^-0.5)); the draws follow torch's generator, not JAX's PRNG.

Each block is pre-LN: causal multi-head self-attention and a QuickGELU MLP.
The attention runs `ops.attention.fused_causal_attention` on the (B, T, D)
projections: on a CUDA tensor kernel #4 (f32 at hd 64 is the 3xTF32
tensor-core kernel), its plain version on a CPU tensor; the JAX module's is
an XLA einsum with a -inf mask above the diagonal, the same function. The
tower is frozen (features are computed under `torch.no_grad()`), so #5
never runs here. The LayerNorms and the MLP are torch's (`nn.LayerNorm`,
`nn.Linear`), as the JAX module's are XLA's, not its Pallas LayerNorm.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_causal_attention
from .init import lecun_normal_

# width / layers / heads / embed_dim of the text towers of the published
# CLIP models the reference can name via `clip_name`.
CLIP_TEXT_CONFIGS = {
    "ViT-B/32": dict(width=512, layers=12, heads=8, embed_dim=512),
    "ViT-B/16": dict(width=512, layers=12, heads=8, embed_dim=512),
    "ViT-L/14": dict(width=768, layers=12, heads=12, embed_dim=768),
    "RN50": dict(width=512, layers=12, heads=8, embed_dim=1024),
}


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class _MultiheadAttention(nn.Module):
    """`nn.MultiheadAttention`'s parameters (a fused in-projection and
    `out_proj`), causal, computed by the fused attention."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        y = fused_causal_attention(q.contiguous(), k.contiguous(), v.contiguous(), self.heads,
                                   causal=True)
        return self.out_proj(y)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _MultiheadAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict([("c_fc", nn.Linear(width, 4 * width)),
                                              ("gelu", QuickGELU()),
                                              ("c_proj", nn.Linear(4 * width, width))]))

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.Sequential(*[ResidualAttentionBlock(width, heads)
                                         for _ in range(layers)])

    def forward(self, x):
        return self.resblocks(x)


class CLIPTextTransformer(nn.Module):
    """Token + positional embedding, N causal blocks, `ln_final`, and the
    projection of the end-of-text token."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 layers: int = 12, heads: int = 8, embed_dim: int = 512):
        super().__init__()
        self.context_length = context_length
        self.width, self.layers = width, layers
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = _Transformer(width, layers, heads)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The JAX module's initializers, drawn from `generator`."""
        self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        for block in self.transformer.resblocks:
            # flax draws the fused in-projection as one (width, 3 width) kernel
            lecun_normal_(block.attn.in_proj_weight, generator)
            block.attn.in_proj_bias.zero_()
            for lin in (block.attn.out_proj, block.mlp.c_fc, block.mlp.c_proj):
                lecun_normal_(lin.weight, generator)
                lin.bias.zero_()
            for ln in (block.ln_1, block.ln_2):
                ln.weight.fill_(1.0)
                ln.bias.zero_()
        self.ln_final.weight.fill_(1.0)
        self.ln_final.bias.zero_()
        self.text_projection.normal_(0.0, self.width ** -0.5, generator=generator)

    def forward(self, tokens):
        """tokens (B, T) integers -> (the (B, T, width) sequence after
        `ln_final`, the end-of-text token's features @ `text_projection`
        (B, embed_dim)); the end-of-text token is the largest id of a row."""
        t = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[:t]
        x = self.ln_final(self.transformer(x))
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection
        return x, pooled


class CLIPTextEmbedding(nn.Module):
    """The reference's `clip_text_embedding.py` semantics on the tower: the
    negative-token clamp, end-of-text pooling (`pick_last_embedding`),
    `keep_seq_len_dim`, the duplication of 512-wide features to 1,024, the
    L2 `normalize` and `additional_last_embedding`. Features come without
    gradient (the tower is frozen), in f32, on the tower's device."""

    def __init__(self, clip_name: str = "ViT-B/32", num_embed: int = 49408,
                 normalize: bool = True, pick_last_embedding: bool = True,
                 keep_seq_len_dim: bool = False, additional_last_embedding: bool = False,
                 embed_dim: int = 512, weights_path: Optional[str] = None, seed: int = 0):
        super().__init__()
        cfg = CLIP_TEXT_CONFIGS.get(clip_name, CLIP_TEXT_CONFIGS["ViT-B/32"])
        self.model = CLIPTextTransformer(vocab_size=num_embed, **cfg)
        self.normalize = normalize
        self.pick_last_embedding = pick_last_embedding
        self.keep_seq_len_dim = keep_seq_len_dim
        self.additional_last_embedding = additional_last_embedding
        # as the reference: features are duplicated only when the REALIZED
        # projection width * 2 is 1,024, whatever embed_dim was asked for
        self._double = cfg["embed_dim"] * 2 == 1024
        self.embed_dim = cfg["embed_dim"] * 2 if self._double else cfg["embed_dim"]
        weights_path = weights_path or os.environ.get("DQVQ_CLIP_WEIGHTS")
        if weights_path and os.path.exists(weights_path):
            from ..utils.model_loading import load_torch_state_dict
            from ..utils.weights import clip_text_state_dict_from_openai

            self.model.load_state_dict(clip_text_state_dict_from_openai(
                load_torch_state_dict(weights_path), layers=cfg["layers"]))
        else:  # seeded: runnable and testable without weights
            generator = torch.Generator(device=self.model.positional_embedding.device)
            self.model.init_weights(generator.manual_seed(int(seed)))
        self.model.requires_grad_(False)

    def _tokens(self, index):
        device = self.model.positional_embedding.device
        tokens = torch.as_tensor(np.asarray(index) if not isinstance(index, torch.Tensor)
                                 else index).to(device=device, dtype=torch.long)
        return tokens.clamp(min=0)  # the reference's clamp of negative tokens

    @torch.no_grad()
    def encode_text(self, tokens):
        seq, pooled = self.model(self._tokens(tokens))
        if self.pick_last_embedding:
            return pooled[:, None, :] if self.keep_seq_len_dim else pooled
        return seq

    @torch.no_grad()
    def forward(self, index):
        tokens = self._tokens(index)
        if tokens.dim() != 2:
            raise ValueError(f"tokens must be (B, T), got {tuple(tokens.shape)}")
        seq, pooled = self.model(tokens)
        feats = pooled if self.pick_last_embedding else seq
        if self.pick_last_embedding and self.keep_seq_len_dim:
            feats = feats[:, None, :]
        text_features = torch.cat([feats, feats], dim=-1) if self._double else feats
        if self.normalize:
            text_features = text_features / text_features.norm(dim=-1, keepdim=True)
        if self.additional_last_embedding:
            last = pooled[:, None, :] if self.keep_seq_len_dim else pooled
            return text_features, last
        return text_features
