"""The legacy and alternative quantizers (counterpart of
`dynamicvectorquantization_tpu/ops/quantizers.py`): taming's gradient-trained
`VectorQuantizer` / `VectorQuantizer2` (legacy beta placement, index remap,
"sane" index shapes), `GumbelQuantize`, the taming-style `EMAVectorQuantizer`,
rq-vae's residual `RQBottleneck` and the masked gradient-trained
`MaskVectorQuantize`.

Every class takes NHWC features and returns `(x_q, loss, (None, None,
code))` as the JAX modules do, and takes the keywords the stage-1 models pass
(`codebook_mask`, `temp`, `train`, `generator`, `commit`, `noise`); what a
class does not use it ignores.

The L2 nearest-code searches go through `ops/vq.py` `nearest_codes` (#1), and
`nearest_codes_with_stats` (#2) inside the EMA quantizers, as the JAX classes
call `nearest_codes`: the kernel for CUDA tensors, the plain version for CPU
ones. `use_pallas` is taken so that the JAX package's ymls load, and ignored.
`MaskVectorQuantize` ranks by -|x|^2 - |e|^2 + 2 x.e, which orders the
codes as |e|^2 - 2 x.e does, so its plain L2 search is #1 too; its cosine and
Gumbel-sampled searches need every score and are one matmul, as in JAX.

A gradient-trained codebook's rows are gathered by `gather_rows`, whose
backward is one GEMM of the codes' one-hot rows with the incoming gradient.
JAX's `take` has a scatter-add as its gradient; on the card
`F.embedding`'s / `index_add_`'s float atomics sum duplicate rows in an order
that was seen to vary between identical runs (ROADMAP §3, "Embedding
backward"), while the GEMM's fixed order keeps a resumed run bit-equal.

Draws follow torch's generator, not JAX's PRNG: `GumbelQuantize`'s noise and
`MaskVectorQuantize`'s Gumbel assignment (`noise=`, else drawn from
`generator`), remap's "random" fill (`generator`). The stage-1 trainer's
discriminator pass draws from a copy of the generator as the autoencoder
pass found it, so both passes see the same draws, as the JAX trainer gives
them one key.

`RQBottleneck` calls its codebook(s) `depth` times a forward; with
`shared_codebook` one `VectorQuantizeEMA` updates after each call, so each
depth searches the codebook the depth before it left, as flax threads the
"ema" collection through the calls. A training forward with `commit=False`
(the trainer's discriminator pass) does the same on the buffers and puts them
back afterwards: JAX's fresh forward mutates a copy it then discards.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.encoder_dual import draw_gumbel
from .vq import VectorQuantizeEMA, nearest_codes


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        onehot = F.one_hot(idx, ctx.rows).to(grad.dtype)
        return onehot.t() @ grad, None


def gather_rows(table, idx):
    """`table[idx]` for (N,) indices, differentiable in `table` through a
    one-hot GEMM (see the module docstring)."""
    return _GatherRows.apply(table, idx)


def _uniform_codebook(weight, generator):
    k = weight.shape[0]
    with torch.no_grad():
        weight.uniform_(-1.0 / k, 1.0 / k, generator=generator)


def _l2norm(x, eps=1e-12):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)


class VectorQuantizer(nn.Module):
    """Gradient-trained codebook: loss = |sg(z) - e|^2 + beta |z - sg(e)|^2."""

    def __init__(self, n_e=1024, e_dim=256, beta=0.25, use_pallas=None):
        super().__init__()
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.embedding = nn.Embedding(n_e, e_dim)

    @torch.no_grad()
    def init_codebook(self, generator):
        _uniform_codebook(self.embedding.weight, generator)

    def _quantize(self, z):
        emb = self.embedding.weight
        flat = z.reshape(-1, self.e_dim)
        idx, _ = nearest_codes(flat.detach(), emb.detach())
        return idx, gather_rows(emb, idx).reshape(z.shape)

    def forward(self, z, codebook_mask=None, train=False, **_):
        idx, z_q = self._quantize(z)
        loss = ((z.detach() - z_q) ** 2).mean() + self.beta * ((z - z_q.detach()) ** 2).mean()
        z_q = z + (z_q - z).detach()
        return z_q, loss, (None, None, idx.reshape(z.shape[:-1]))

    def get_codebook_entry(self, indices):
        return self.embedding.weight[indices]


class VectorQuantizer2(VectorQuantizer):
    """taming's VectorQuantizer2: `legacy` (the default) puts beta on the
    codebook term, as upstream does; `remap` names an .npy of used code ids,
    codes are emitted as positions in it and unseen ones become
    `unknown_index` ("random": a uniform draw from `generator`, "extra": one
    id past the list, or an int); `sane_index_shape` keeps (B, H, W) codes
    instead of the flattened (N, 1)."""

    def __init__(self, n_e=1024, e_dim=256, beta=0.25, remap=None, unknown_index="random",
                 sane_index_shape=False, legacy=True, use_pallas=None):
        super().__init__(n_e, e_dim, beta, use_pallas)
        self.remap, self.unknown_index = remap, unknown_index
        self.sane_index_shape, self.legacy = sane_index_shape, legacy
        if remap is not None:
            self.register_buffer("used", torch.as_tensor(np.load(remap)).long(),
                                 persistent=False)
            self.re_embed = self.used.shape[0] + (unknown_index == "extra")
        else:
            self.re_embed = n_e

    def remap_to_used(self, inds, generator=None):
        used = self.used.to(inds.device)
        match = inds[..., None] == used
        new = match.long().argmax(dim=-1)
        unknown = ~match.any(dim=-1)
        if self.unknown_index == "random":
            fill = torch.randint(0, self.re_embed, new.shape, generator=generator,
                                 device=inds.device)
        elif self.unknown_index == "extra":
            fill = torch.full_like(new, used.shape[0])
        else:
            fill = torch.full_like(new, int(self.unknown_index))
        return torch.where(unknown, fill, new)

    def unmap_to_all(self, inds):
        used = self.used.to(inds.device)
        if self.re_embed > used.shape[0]:  # the extra id -> 0
            inds = torch.where(inds >= used.shape[0], 0, inds)
        return used[inds]

    def forward(self, z, codebook_mask=None, train=False, generator=None, **_):
        idx, z_q = self._quantize(z)
        codebook_term = ((z.detach() - z_q) ** 2).mean()
        commit_term = ((z - z_q.detach()) ** 2).mean()
        if self.legacy:  # upstream's beta on the codebook term
            loss = commit_term + self.beta * codebook_term
        else:
            loss = self.beta * commit_term + codebook_term
        z_q = z + (z_q - z).detach()
        code = idx.reshape(z.shape[:-1])
        if self.remap is not None:
            code = self.remap_to_used(code, generator)
        if not self.sane_index_shape:
            code = code.reshape(-1, 1)
        return z_q, loss, (None, None, code)

    def get_codebook_entry(self, indices, shape=None):
        if self.remap is not None:
            indices = self.unmap_to_all(indices)
        z_q = self.embedding.weight[indices]
        return z_q if shape is None else z_q.reshape(shape)


class GumbelQuantize(nn.Module):
    """Gumbel-softmax quantization over 1x1-conv code logits with the
    KL-to-uniform term (taming's GumbelQuantize; `proj`, `embed`)."""

    def __init__(self, num_hiddens=256, embedding_dim=256, n_embed=1024, kl_weight=5e-4,
                 temp_init=1.0, straight_through=True):
        super().__init__()
        self.n_embed, self.kl_weight = n_embed, kl_weight
        self.temp_init, self.straight_through = temp_init, straight_through
        self.proj = nn.Conv2d(num_hiddens, n_embed, 1)
        self.embed = nn.Embedding(n_embed, embedding_dim)

    @torch.no_grad()
    def init_codebook(self, generator):
        self.embed.weight.normal_(0.0, 1.0, generator=generator)  # flax normal(1.0)

    def forward(self, z, temp=None, train=False, generator=None, noise=None, **_):
        hard = self.straight_through if train else True
        temp = self.temp_init if temp is None or temp == 0.0 else temp
        logits = F.linear(z, self.proj.weight[:, :, 0, 0], self.proj.bias)
        if train:
            if noise is None:
                noise = draw_gumbel(logits.shape, generator, logits.device)
            soft = torch.softmax((logits + noise) / temp, dim=-1)
        else:
            soft = torch.softmax(logits / temp, dim=-1)
        idx = soft.argmax(dim=-1)
        soft_q = soft
        if hard:
            soft_q = F.one_hot(idx, self.n_embed).to(soft.dtype) + soft - soft.detach()
        z_q = soft_q @ self.embed.weight
        probs = torch.softmax(logits, dim=-1)
        kl = self.kl_weight * (probs * torch.log(probs * self.n_embed + 1e-10)).sum(-1).mean()
        return z_q, kl, (None, None, idx)

    def get_codebook_entry(self, indices):
        return self.embed.weight[indices]


class EMAVectorQuantizer(nn.Module):
    """The taming-style EMA quantizer: `VectorQuantizeEMA` without restarts
    (`inner`)."""

    def __init__(self, n_embed=1024, embedding_dim=256, beta=0.25, decay=0.99, eps=1e-5,
                 use_pallas=None):
        super().__init__()
        self.inner = VectorQuantizeEMA(codebook_size=n_embed, codebook_dim=embedding_dim,
                                       commitment_beta=beta, decay=decay,
                                       restart_unused_codes=False, eps=eps)

    @torch.no_grad()
    def init_codebook(self, generator):
        self.inner.init_codebook(generator)

    def forward(self, z, train=False, generator=None, commit=True, **_):
        return self.inner(z, train=train, generator=generator, commit=commit)

    def get_codebook_entry(self, indices):
        return self.inner.get_codebook_entry(indices)


class RQBottleneck(nn.Module):
    """Residual quantization of depth D = code_shape[-1]: quantize, subtract,
    quantize the residual, ...; the output is the sum of the chosen codes,
    the codes (B, H, W, D); the commitment loss the mean over depths of
    |z - sg(sum of the codes so far)|^2. `codebook_shared` or
    `codebook_{d}` (the JAX module's names)."""

    def __init__(self, latent_shape=(8, 8, 256), code_shape=(8, 8, 4), n_embed=1024,
                 decay=0.99, shared_codebook=True, restart_unused_codes=True,
                 commitment_loss="cumsum", use_pallas=None):
        super().__init__()
        self.code_shape = tuple(code_shape)
        self.depth = self.code_shape[-1]
        if commitment_loss != "cumsum":
            raise NotImplementedError(f"commitment_loss {commitment_loss!r}: the JAX module "
                                      "takes the cumulative form only")

        def make():
            return VectorQuantizeEMA(codebook_size=n_embed, codebook_dim=latent_shape[-1],
                                     decay=decay, restart_unused_codes=restart_unused_codes)

        if shared_codebook:
            self.codebook_shared = make()
            self._names = ["codebook_shared"] * self.depth
        else:
            for d in range(self.depth):
                setattr(self, f"codebook_{d}", make())
            self._names = [f"codebook_{d}" for d in range(self.depth)]

    def codebooks(self):
        return [getattr(self, n) for n in self._names]

    @torch.no_grad()
    def init_codebook(self, generator):
        for name in dict.fromkeys(self._names):
            getattr(self, name).init_codebook(generator)

    def forward(self, z, train=False, generator=None, commit=True, **_):
        shadow = train and not commit
        if shadow:  # update in sequence on the buffers, then put them back
            saved = [(b, b.clone()) for n in dict.fromkeys(self._names)
                     for b in getattr(self, n).buffers()]
        residual = z
        cumsum = torch.zeros_like(z)
        codes, loss = [], 0.0
        for book in self.codebooks():
            q_st, _, (_, _, code) = book(residual, train=train, generator=generator)
            q = q_st.detach()
            residual = residual - q
            cumsum = cumsum + q
            codes.append(code)
            loss = loss + ((z - cumsum) ** 2).mean()
        if shadow:
            with torch.no_grad():
                for b, v in saved:
                    b.copy_(v)
        out = z + (cumsum - z.detach())
        return out, loss / self.depth, (None, None, torch.stack(codes, dim=-1))

    def get_codebook_entry(self, codes):
        """(B, H, W, D) codes -> the summed embeddings (B, H, W, dim)."""
        out = 0.0
        for d, book in enumerate(self.codebooks()):
            out = out + book.get_codebook_entry(codes[..., d])
        return out


class MaskVectorQuantize(nn.Module):
    """The gradient-trained masked quantizer (reference
    `quantize_codebook_mask.py`): codebook `embedding` trained through
    |x_q - sg(x)|^2; kmeans init from the first batch's features
    (`init_from_features`, as flax's init runs it on the sample batch);
    cosine search; Gumbel-sampled assignment at temp > 0 in training; the
    commitment weighted by the mask and scaled by 1 / mean(mask); the
    orthogonal term of arXiv:2112.00384."""

    def __init__(self, codebook_size=1024, codebook_dim=256, kmeans_init=False, kmeans_iters=10,
                 use_cosine_sim=False, commitment_beta=0.25, orthogonal_reg_weight=0.0,
                 activate_mask_quantize=True, accept_image_fmap=True, use_pallas=None):
        super().__init__()
        self.codebook_size, self.codebook_dim = codebook_size, codebook_dim
        self.kmeans_init, self.kmeans_iters = kmeans_init, kmeans_iters
        self.use_cosine_sim, self.commitment_beta = use_cosine_sim, commitment_beta
        self.orthogonal_reg_weight = orthogonal_reg_weight
        self.activate_mask_quantize = activate_mask_quantize
        self.embedding = nn.Embedding(codebook_size, codebook_dim)

    @torch.no_grad()
    def init_codebook(self, generator):
        _uniform_codebook(self.embedding.weight, generator)

    @torch.no_grad()
    def init_from_features(self, x, generator):
        """kmeans init of the codebook from features (..., D), where asked."""
        if self.kmeans_init:
            from .quantize_lucidrains import kmeans

            self.embedding.weight.copy_(kmeans(x.reshape(-1, self.codebook_dim).float(),
                                               self.codebook_size, self.kmeans_iters,
                                               self.use_cosine_sim, generator))

    def forward(self, x, codebook_mask=None, temp=0.0, train=False, generator=None, noise=None,
                **_):
        emb = self.embedding.weight
        flat = x.reshape(-1, x.shape[-1]).detach()
        e = emb.detach()
        if temp > 0 and train:
            if self.use_cosine_sim:
                dist = _l2norm(flat) @ _l2norm(e).t()
            else:
                dist = (-(flat ** 2).sum(1, keepdim=True) - (e ** 2).sum(1)[None]
                        + 2.0 * flat @ e.t())
            if noise is None:
                noise = draw_gumbel(dist.shape, generator, dist.device)
            idx = (dist / temp + noise).argmax(dim=-1)
        elif self.use_cosine_sim:
            idx = (_l2norm(flat) @ _l2norm(e).t()).argmax(dim=-1)
        else:
            idx, _ = nearest_codes(flat, e)
        x_q = gather_rows(emb, idx).reshape(x.shape)
        if codebook_mask is not None and self.activate_mask_quantize:
            mask = codebook_mask.reshape(x.shape[:-1] + (1,)).to(x.dtype)
            ratio = 1.0 / mask.mean()
            loss = (ratio * self.commitment_beta * ((x_q.detach() - x) ** 2 * mask).mean()
                    + ratio * ((x_q - x.detach()) ** 2 * mask).mean())
        else:
            loss = (self.commitment_beta * ((x_q.detach() - x) ** 2).mean()
                    + ((x_q - x.detach()) ** 2).mean())
        if self.orthogonal_reg_weight > 0.0:
            en = _l2norm(emb)
            diff = en @ en.t() - torch.eye(self.codebook_size, dtype=en.dtype, device=en.device)
            loss = loss + self.orthogonal_reg_weight * (diff ** 2).sum() / self.codebook_size ** 2
        x_q = x + (x_q - x).detach()
        return x_q, loss, (None, None, idx.reshape(x.shape[:-1]))

    def get_codebook_entry(self, indices):
        return self.embedding.weight[indices]
