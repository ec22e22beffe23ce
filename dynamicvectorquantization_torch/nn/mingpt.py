"""minGPT, the legacy fixed-length stage-2 transformer, with cached decode
(counterpart of `dynamicvectorquantization_tpu/nn/mingpt.py`).

Token + learned absolute position embeddings, N pre-LN blocks
(`nn/transformer.py` `TransformerStack`), LayerNorm and a bias-free head,
under taming's names (`tok_emb`, `pos_emb`, `blocks.{i}.*`, `ln_f`,
`head`; `seg_emb` for the T2I variant), so a taming `cond_transformer`
checkpoint's `transformer.*` loads with `load_state_dict`.

The full-sequence attention is always the fused one: the CUDA kernels (#4
forward, #5 backward) on a CUDA tensor, their plain versions on a CPU
tensor, and LayerNorm #6 / #7 over 256 rows or more. `use_flash_attention`
is taken so reference configs load (the JAX package runs XLA attention when
it is False, its default). `n_unmasked` is a parity field: the model is
fully causal, as the JAX one (ROADMAP §3). Decode (`step`,
`step_embedding`) runs one token against float KV caches through
`chunked_decode_attention`, the plain online softmax of the JAX package's
XLA route; `sample_with_past` prefills the prefix one token at a time and
then takes one cached step per generated token: op by op on the CPU, a CUDA
graph replay a step on the card (`_graphed_steps`).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.kv_int8 import CHUNK
from .init import gpt_init_
from .norm import LayerNorm
from .stackgpt import cross_entropy_ignore
from .transformer import KVCache, TransformerStack, dropout


class GPT(nn.Module):
    def __init__(self, vocab_size=1024, block_size=512, n_layer=12, n_head=8, n_embd=256,
                 embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, n_unmasked=0,
                 use_flash_attention=False, segment_size=0):
        super().__init__()
        self.vocab_size = vocab_size
        self.block_size = block_size
        self.n_layer = n_layer
        self.n_head = n_head
        self.n_embd = n_embd
        self.embd_pdrop = embd_pdrop
        self.n_unmasked = n_unmasked  # parity field: fully causal
        self.segment_size = segment_size
        self.tok_emb = nn.Embedding(vocab_size, n_embd)
        if segment_size > 0:
            self.seg_emb = nn.Embedding(segment_size, n_embd)
        self.pos_emb = nn.Parameter(torch.zeros(1, block_size, n_embd))
        self.blocks = TransformerStack(n_layer, n_embd, n_head, attn_pdrop, resid_pdrop)
        self.ln_f = LayerNorm(n_embd, eps=1e-5)
        self.head = nn.Linear(n_embd, vocab_size, bias=False)

    def init_weights(self, generator: torch.Generator):
        """The JAX init: embeddings, attention / MLP kernels and the head
        N(0, 0.02^2), biases zero, LayerNorms the identity, `pos_emb` zero."""
        gpt_init_(self, generator)

    def get_block_size(self):
        return self.block_size

    def forward(self, idx, embeddings=None, targets=None, segment=None, train=False,
                generator=None, seed=None):
        """idx (B, T) tokens; `embeddings` (B, P, D) prepended to the token
        embeddings; `segment` (B, T) segment ids added to them. Returns
        (logits, loss or None). When `train`, `generator` feeds the embedding
        and residual dropouts and the integer `seed` the attention dropout."""
        x = self.tok_emb(idx)
        if segment is not None:
            x = x + self.seg_emb(segment)
        if embeddings is not None:
            x = torch.cat([embeddings.to(x.dtype), x], dim=1)
        x = x + self.pos_emb[:, :x.shape[1]]
        x = dropout(x, self.embd_pdrop, train, generator)
        x = self.blocks(x, train=train, generator=generator, seed=seed)
        logits = self.head(self.ln_f(x))
        if targets is None:
            return logits, None
        return logits, cross_entropy_ignore(logits, targets, -100)

    # ------------------------------------------------------------------ decode
    def make_cache(self, batch: int, max_len: int, dtype=torch.float32, device=None):
        """Float caches of `n_layer` layers, capacity rounded up to the
        decode chunk."""
        max_len = -(-max_len // CHUNK) * CHUNK
        return KVCache.create(self.n_layer, batch, self.n_head, max_len,
                              self.n_embd // self.n_head, dtype,
                              device if device is not None else self.pos_emb.device)

    def _step(self, x, cache, index, n_chunks=None):
        if isinstance(index, torch.Tensor):  # read on the device
            pos = self.pos_emb[0].index_select(0, index.reshape(1).long())
        else:
            pos = self.pos_emb[0, index:index + 1]
        x = self.blocks(x[:, None, :] + pos, cache, index, n_chunks=n_chunks)
        return self.head(self.ln_f(x[:, 0]))

    def step(self, tok, cache: KVCache, index, seg=None, n_chunks=None):
        """One cached decode step: tok (B,) at position `index` -> logits
        (B, vocab); `cache` is written in place. `seg` (B,): segment ids.
        `index` a host int, or a 0-d int tensor on the device with `n_chunks`
        the chunks read (`nn/transformer.py` `chunked_decode_attention`)."""
        x = self.tok_emb(tok)
        if seg is not None:
            x = x + self.seg_emb(seg)
        return self._step(x, cache, index, n_chunks)

    def step_embedding(self, emb, cache: KVCache, index):
        """One cached step from a raw embedding (B, D) (a conditioning prefix)."""
        return self._step(emb, cache, index)


def _graphed_steps(gpt: GPT, b: int, max_len: int, use_segments: bool, device):
    """(the static state, a function that runs one decode step from it) for
    `sample_with_past` on a CUDA device: one step is a CUDA graph
    (`models/graphs.py` `GraphRunner`, keyed by the batch, the cache length,
    the segments and the parameters' storage), the token, the position (a
    device int32 read by the graph) and the logits static tensors, the float
    caches static too. Positions past the step's index are never read, so
    the caches need no clearing between calls; every chunk of them is read,
    and a chunk past the index leaves the softmax's sums bit for bit as they
    were, so a replay computes what the eager step does."""
    from ..models.graphs import parameter_storage, runner_for

    runner = runner_for(gpt, device)
    max_len = -(-max_len // CHUNK) * CHUNK
    key = ("mingpt.step", b, max_len, use_segments, parameter_storage(gpt))
    state = runner.state.get(key)
    if state is None:
        state = dict(cache=gpt.make_cache(b, max_len, dtype=gpt.pos_emb.dtype, device=device),
                     tok=torch.zeros(b, dtype=torch.long, device=device),
                     index=torch.zeros((), dtype=torch.int32, device=device),
                     seg=torch.ones(b, dtype=torch.long, device=device) if use_segments else None,
                     logits=torch.empty(b, gpt.vocab_size, dtype=gpt.pos_emb.dtype,
                                        device=device))
        runner.state[key] = state

    def body():
        state["logits"].copy_(gpt.step(state["tok"], state["cache"], state["index"],
                                       state["seg"], n_chunks=max_len // CHUNK))

    def step(tok, index):
        state["tok"].copy_(tok)
        state["index"].fill_(index)
        runner.run(key, body)
        return state["logits"]

    return state, step


@torch.no_grad()
def sample_with_past(gpt: GPT, x0, steps: int, generator=None, temperature=1.0,
                     sample_logits=True, top_k=None, top_p=None, use_segments=False,
                     eager=False):
    """KV-cached autoregressive sampling: the prefix x0 (B, P) fed one token
    at a time, then one cached step per generated token. Returns (B, steps)
    int64. `use_segments`: prefix tokens carry segment 0, generated ones 1
    (the T2I variant). `sample_logits=False` (or `top_k=1`) is greedy. On a
    CUDA device each generated token's step replays a CUDA graph
    (`_graphed_steps`; the draws stay eager, from `generator`); `eager=True`
    runs every step op by op, the control."""
    from ..models.sampling import sample_from_logits

    b, p = x0.shape
    seg0 = seg1 = None
    if use_segments:
        seg0 = torch.zeros(b, dtype=torch.long, device=x0.device)
        seg1 = torch.ones_like(seg0)
    if x0.device.type == "cuda" and not eager:
        state, step = _graphed_steps(gpt, b, p + steps, use_segments, x0.device)
        cache = state["cache"]
    else:
        cache = gpt.make_cache(b, p + steps, dtype=gpt.pos_emb.dtype, device=x0.device)

        def step(tok, index):
            return gpt.step(tok, cache, index, seg1)
    logits = None
    for i in range(p):
        logits = gpt.step(x0[:, i], cache, i, seg0)
    out = torch.empty((b, steps), dtype=torch.long, device=x0.device)
    for i in range(steps):
        out[:, i] = sample_from_logits(generator, logits, temperature, top_k, top_p,
                                       sample_logits)
        if i + 1 < steps:
            logits = step(out[:, i], p + i)
    return out
