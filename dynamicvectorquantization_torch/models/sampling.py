"""Top-k / top-p filtering and the categorical draw (counterpart of
`dynamicvectorquantization_tpu/models/sampling.py`).

Order: temperature -> top-k (ties with the k-th logit are kept) -> softmax
-> top-p renormalise -> categorical on log(p + 1e-20) by the Gumbel-max
trick, or argmax when `sample` is False. Draws come from the caller's
`torch.Generator`; they do not reproduce JAX's random bits.
"""
from __future__ import annotations

import torch


def top_k_logits(logits, k):
    if k is None:
        return logits
    k = min(int(k), logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def top_p_probs(probs, p):
    """Nucleus filtering on probabilities, reference semantics."""
    if p is None or p >= 1.0:
        return probs / probs.sum(dim=-1, keepdim=True)
    sort_idx = torch.argsort(-probs, dim=-1, stable=True)
    sorted_probs = torch.gather(probs, -1, sort_idx)
    remove = torch.cumsum(sorted_probs, dim=-1) >= p
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
    remove_vocab = torch.zeros_like(remove).scatter(-1, sort_idx, remove)
    filtered = torch.where(remove_vocab, 0.0, probs)
    return filtered / filtered.sum(dim=-1, keepdim=True)


def sample_from_logits(generator, logits, temperature=1.0, top_k=None, top_p=None,
                       sample=True):
    """Returns (B,) int64 token ids."""
    logits = logits.float() / temperature
    logits = top_k_logits(logits, top_k)
    probs = top_p_probs(torch.softmax(logits, dim=-1), top_p)
    if not sample:
        return torch.argmax(probs, dim=-1)
    u = torch.rand(probs.shape, generator=generator, device=probs.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(torch.log(probs + 1e-20) + gumbel, dim=-1)
