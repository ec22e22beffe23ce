"""lucidrains-style vector quantizer: a kmeans-initialised EMA codebook,
cosine codebooks, dead-code expiry (counterpart of
`dynamicvectorquantization_tpu/ops/quantize_lucidrains.py`).

`kmeans` draws its initial means as a random permutation of the samples from
`generator` (JAX: `jax.random.permutation`), then runs Lloyd steps with the
JAX function's arithmetic: squared distances |s|^2 - 2 s.m + |m|^2 (or
cosine similarities), one-hot counts and sums by GEMM, empty clusters keep
their mean. With fewer samples than clusters it draws the initial means with
replacement (the reference's `sample_vectors`), where the JAX function's
permutation would yield fewer means than clusters.

`LucidrainsVectorQuantize` keeps its EMA state as buffers under the JAX
collection's names (`embed`, `embed_avg`, `cluster_size`, `initted`): a
training forward runs kmeans on its batch while `initted` is false, searches
(#1, `ops/vq.py` `nearest_codes`, for the L2 codebook; a cosine argmax
otherwise), decays the statistics, Laplace-smooths (or, cosine, normalises)
the codebook and replaces the codes whose EMA count fell below
`threshold_ema_dead_code` by batch rows drawn from `generator`. The search
of a training forward uses the codebook from before its update. Over
several ranks (a `parallel.dist.global_stats` scope) kmeans, the statistics
and the replacement rows are the global batch's, as the JAX module's are
under GSPMD; the draws come from the trainer's generator, the same on every
rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.dist import active, all_rows
from .quantizers import _l2norm
from .vq import nearest_codes


def kmeans(samples, num_clusters: int, num_iters: int = 10, use_cosine: bool = False,
           generator=None):
    """(num_clusters, D) means of samples (N, D) after `num_iters` Lloyd steps."""
    n = samples.shape[0]
    if n >= num_clusters:
        idx = torch.randperm(n, generator=generator, device=samples.device)[:num_clusters]
    else:
        idx = torch.randint(0, n, (num_clusters,), generator=generator, device=samples.device)
    means = samples[idx]
    for _ in range(num_iters):
        if use_cosine:
            assign = (_l2norm(samples) @ _l2norm(means).t()).argmax(dim=-1)
        else:
            d = ((samples ** 2).sum(1, keepdim=True) - 2 * samples @ means.t()
                 + (means ** 2).sum(1)[None])
            assign = d.argmin(dim=-1)
        onehot = F.one_hot(assign, num_clusters).to(samples.dtype)
        counts = onehot.sum(0)
        new = (onehot.t() @ samples) / counts[:, None].clamp_min(1.0)
        means = torch.where(counts[:, None] > 0, new, means)
        if use_cosine:
            means = _l2norm(means)
    return means


class LucidrainsVectorQuantize(nn.Module):
    def __init__(self, codebook_size=1024, dim=256, decay=0.99, commitment_weight=1.0, eps=1e-5,
                 threshold_ema_dead_code=2, kmeans_init=True, kmeans_iters=10,
                 use_cosine_sim=False, use_pallas=None):
        super().__init__()
        self.codebook_size, self.dim, self.decay = codebook_size, dim, decay
        self.commitment_weight, self.eps = commitment_weight, eps
        self.threshold_ema_dead_code = threshold_ema_dead_code
        self.kmeans_init, self.kmeans_iters = kmeans_init, kmeans_iters
        self.use_cosine_sim = use_cosine_sim
        self.register_buffer("embed", torch.zeros(codebook_size, dim))
        self.register_buffer("embed_avg", torch.zeros(codebook_size, dim))
        self.register_buffer("cluster_size", torch.zeros(codebook_size))
        self.register_buffer("initted", torch.zeros((), dtype=torch.bool))

    @torch.no_grad()
    def init_codebook(self, generator):
        """normal * 0.02, `embed_avg` a copy, zero counts, not initted."""
        self.embed.normal_(0.0, 1.0, generator=generator).mul_(0.02)
        self.embed_avg.copy_(self.embed)
        self.cluster_size.zero_()
        self.initted.fill_(False)

    def forward(self, x, train=False, generator=None, commit=True, **_):
        flat = x.detach().reshape(-1, x.shape[-1])
        codebook = self.embed
        if train and self.kmeans_init and not bool(self.initted):
            codebook = kmeans(all_rows(flat), self.codebook_size, self.kmeans_iters,
                              self.use_cosine_sim, generator)
        if self.use_cosine_sim:
            idx = (_l2norm(flat) @ _l2norm(codebook).t()).argmax(dim=-1)
            xq_flat = codebook[idx]
        else:
            idx, xq_flat = nearest_codes(flat, codebook)
        if train and commit:
            self._ema_update(flat, idx, generator)
        x_q = xq_flat.reshape(x.shape).to(x.dtype)
        loss = self.commitment_weight * ((x_q.detach() - x) ** 2).mean()
        x_q = x + (x_q - x).detach()
        return x_q, loss, (None, None, idx.reshape(x.shape[:-1]))

    @torch.no_grad()
    def _ema_update(self, flat, idx, generator):
        k, decay = self.codebook_size, self.decay
        onehot = F.one_hot(idx, k).to(flat.dtype)
        counts, sums = onehot.sum(0), onehot.t() @ flat
        world = active()
        if world is not None:  # the global batch's statistics, one collective
            both = world.sum_(torch.cat([sums.reshape(-1), counts]))
            sums, counts = both[:-k].view_as(sums), both[-k:]
            flat = all_rows(flat)
        cluster = self.cluster_size * decay + counts * (1 - decay)
        avg = self.embed_avg * decay + sums * (1 - decay)
        if self.use_cosine_sim:
            new_embed = _l2norm(avg / cluster[:, None].clamp_min(self.eps))
        else:
            n = cluster.sum()
            smoothed = (cluster + self.eps) / (n + k * self.eps) * n
            new_embed = avg / smoothed[:, None]
        if self.threshold_ema_dead_code > 0:
            repl = flat[torch.randint(0, flat.shape[0], (k,), generator=generator,
                                      device=flat.device)]
            if self.use_cosine_sim:
                repl = _l2norm(repl)
            dead = cluster < self.threshold_ema_dead_code
            new_embed = torch.where(dead[:, None], repl, new_embed)
            cluster = torch.where(dead, float(self.threshold_ema_dead_code), cluster)
        self.cluster_size.copy_(cluster)
        self.embed_avg.copy_(avg)
        self.embed.copy_(new_embed)
        self.initted.fill_(True)

    def get_codebook_entry(self, indices):
        return self.embed[indices]
