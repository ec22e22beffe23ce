"""The DQ-VAE's vector quantizer.

Counterpart of `dynamicvectorquantization_tpu/ops/vq.py` `VectorQuantizeEMA`
and of `ops/vq_pallas.py` `nearest_codes` / `nearest_codes_with_stats`: the
codebook buffer of shape (K + 1, D), whose extra row K is the stage-2 padding
code and stays zero; nearest-code search; the masked commitment loss with
its gradient and the straight-through estimator; `get_codebook_entry`; and,
with `train=True`, the EMA cluster statistics with the Laplace-smoothed
codebook refresh and the restart of unused codes from permuted input rows.

`nearest_codes` and `nearest_codes_with_stats` launch the CUDA kernels of
`csrc/vq_nearest_tc.cu` (and `csrc/vq_stats.cu`) for CUDA tensors and run
`nearest_codes_plain` / `nearest_codes_with_stats_plain` for CPU tensors:
the tensors' device alone picks the route, and a quantizer's `use_pallas`
(kept so that the JAX package's ymls load) is ignored. Scores are |c|^2 -
2 x.c in f32 (no |x|^2 term); argmin ties go to the lowest index. The
kernels search on the tensor cores with a 3xTF32 split and rescore the rows
whose best two codes lie within the split's error bound in the f32 FMA order
of `csrc/vq_nearest.cu`, so their codes are that FMA search's (a lone TF32
product would misrank codes: QUIRKS #9). bf16 rows or
a bf16 codebook (the DQ-VAE in bf16) are searched as their f32 casts, and
the codes, the gathered rows and the statistics are those of the casts, as
the JAX package's TPU route casts both to f32 before its kernel. (On the
CPU the JAX package's XLA route scores a bf16 row against a bf16 codebook in
bf16, which picks other codes at some near-ties; the port follows the
kernel.) The search
and the statistics are piecewise constant in x and the codebook, so they
carry no gradient (the JAX package declares the same with a `custom_vjp` of
zeros): x is detached before either.

Where the JAX module returns a new `ema` collection, this one updates its
buffers in place: `codebook.weight` (K + 1, D), `codebook.cluster_size_ema`
(K,) and `codebook.embed_ema` (K, D), the reference's state_dict names
(`quantize.codebook.*` inside the DQ-VAE). `forward(train=True,
commit=False)` runs the training search and statistics and leaves the
buffers as they were, for the trainer's discriminator pass, whose EMA
update the reference discards.

Over several ranks (inside a `parallel.dist.global_stats` scope) the EMA
update is the global batch's, as the JAX module's is under GSPMD (QUIRKS
#16): `embed_sum` and `cluster_size` are summed over the ranks, the restart
pool is every rank's rows gathered in rank order (the global batch's rows,
tiled and jittered when they are fewer than K), and the permutation comes
from the caller's generator, which the trainer keeps identical on every
rank, so every rank restarts the same codes from the same rows.
"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.dist import active, all_rows
from . import cuda_lib


def nearest_codes_plain(x, codebook):
    """Plain PyTorch version. x: (N, D), codebook: (K, D) (no padding row)
    -> (idx (N,) int64, the codebook rows (N, D)), in f32."""
    x, codebook = x.float(), codebook.float()
    scores = (codebook * codebook).sum(dim=1)[None, :] - 2.0 * torch.matmul(x, codebook.t())
    idx = torch.argmin(scores, dim=1)
    return idx, codebook[idx]


def _as_f32(t):
    """bf16 as its f32 cast; other dtypes as they are, for the kernels' checks."""
    return t.float() if t.dtype == torch.bfloat16 else t


# the kernels' limits (`csrc/vq_nearest_tc.cu`, `csrc/vq_stats.cu`)
MAX_DIM = 304  # the search block's x tile (hi and lo) and codebook stages in shared memory
MAX_ROWS = 1 << 21  # the rescore's prefix of the search blocks' counts in shared memory
MAX_CODES_WITH_STATS = 1 << 14  # the statistics' per-code counts in shared memory


def _kernel_shapes(name, x, codebook, stats=False):
    """(N, K, D) of inputs the CUDA kernels take; raises on any other."""
    if x.device != codebook.device or x.device.type != "cuda":
        raise ValueError(f"{name}: x and the codebook must be on one CUDA device")
    if x.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"{name}: f32 inputs expected, got {x.dtype}, {codebook.dtype}")
    if x.dim() != 2 or codebook.dim() != 2 or x.shape[1] != codebook.shape[1]:
        raise ValueError(f"{name}: (N, D) and (K, D) expected, got "
                         f"{tuple(x.shape)}, {tuple(codebook.shape)}")
    n, d = x.shape
    k = codebook.shape[0]
    if d % 4 or d > MAX_DIM or not 0 < n <= MAX_ROWS or k == 0:
        raise ValueError(f"{name}: the kernel takes D % 4 == 0, D <= {MAX_DIM}, "
                         f"0 < N <= {MAX_ROWS} and K > 0, got N={n}, K={k}, D={d}")
    if stats and k > MAX_CODES_WITH_STATS:
        raise ValueError(f"{name}: the statistics take K <= {MAX_CODES_WITH_STATS}, got K={k}")
    return n, k, d


def _search_args(name, x, codebook, stats):
    """Contiguous f32 inputs, |c|^2, the int32 codes, the workspace and the
    rescored-row count for the kernels' C entries."""
    x, codebook = _as_f32(x), _as_f32(codebook)
    n, k, d = _kernel_shapes(name, x, codebook, stats)
    x = x.contiguous()
    codebook = codebook.contiguous()
    cb_norm = (codebook * codebook).sum(dim=1)
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    workspace = torch.empty(cuda_lib.lib().dqvq_vq_workspace_bytes(n, k, d, int(stats)),
                            dtype=torch.uint8, device=x.device)
    rescored = torch.empty(1, dtype=torch.int32, device=x.device)
    return x, codebook, cb_norm, idx, workspace, rescored, (n, k, d)


def nearest_codes(x, codebook):
    """Nearest codebook row per row of x: (N, D), (K, D), f32 or bf16 (searched
    as f32) -> (idx (N,) int64, quantized (N, D) f32). `nearest_codes.launches`
    counts kernel calls; `nearest_codes.last_rescored` is the last call's
    number of rows rescored in the FMA order (a device int32, read by checks
    only)."""
    if x.device.type == "cpu" and codebook.device.type == "cpu":
        return nearest_codes_plain(x, codebook)
    x, codebook, cb_norm, idx, workspace, rescored, (n, k, d) = _search_args(
        "nearest_codes", x, codebook, False)
    err = cuda_lib.lib().dqvq_vq_nearest(
        x.data_ptr(), codebook.data_ptr(), cb_norm.data_ptr(), idx.data_ptr(), None,
        workspace.data_ptr(), rescored.data_ptr(), n, k, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(err, "nearest_codes")
    nearest_codes.launches += 1
    nearest_codes.last_rescored = rescored
    idx = idx.long()
    return idx, codebook[idx]


nearest_codes.launches = 0
nearest_codes.last_rescored = None


def nearest_codes_with_stats_plain(x, codebook):
    """Plain PyTorch version. x: (N, D), codebook: (K, D) -> (idx (N,) int64,
    the codebook rows (N, D), embed_sum (K, D) = per-code sums of the rows of
    x, cluster_size (K,) = per-code row counts), in f32."""
    x, codebook = x.float(), codebook.float()
    idx, xq = nearest_codes_plain(x, codebook)
    k = codebook.shape[0]
    embed_sum = torch.zeros_like(codebook).index_add_(0, idx, x)
    cluster_size = torch.bincount(idx, minlength=k).to(x.dtype)
    return idx, xq, embed_sum, cluster_size


def nearest_codes_with_stats(x, codebook):
    """`nearest_codes` plus the EMA statistics: (N, D), (K, D), f32 or bf16
    (as f32) -> (idx (N,) int64, quantized (N, D), embed_sum (K, D),
    cluster_size (K,)), f32.
    On CUDA one call runs the search with the row gather, and the statistics
    as a stable sort by code summed in pieces of at most 64 rows
    (deterministic: no float atomics) of `csrc/vq_nearest_tc.cu` and
    `csrc/vq_stats.cu`. `nearest_codes_with_stats.launches` counts those
    calls; `.last_rescored` as `nearest_codes`'."""
    if x.device.type == "cpu" and codebook.device.type == "cpu":
        return nearest_codes_with_stats_plain(x, codebook)
    x, codebook, cb_norm, idx, workspace, rescored, (n, k, d) = _search_args(
        "nearest_codes_with_stats", x, codebook, True)
    xq = torch.empty_like(x)
    embed_sum = torch.empty_like(codebook)
    cluster_size = torch.empty(k, dtype=torch.float32, device=x.device)
    err = cuda_lib.lib().dqvq_vq_nearest_train(
        x.data_ptr(), codebook.data_ptr(), cb_norm.data_ptr(), idx.data_ptr(), xq.data_ptr(),
        embed_sum.data_ptr(), cluster_size.data_ptr(), workspace.data_ptr(),
        rescored.data_ptr(), n, k, d, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(err, "nearest_codes_with_stats")
    nearest_codes_with_stats.launches += 1
    nearest_codes_with_stats.last_rescored = rescored
    return idx.long(), xq, embed_sum, cluster_size


nearest_codes_with_stats.launches = 0
nearest_codes_with_stats.last_rescored = None


class _Codebook(nn.Module):
    def __init__(self, rows: int, dim: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros(rows, dim))
        self.register_buffer("cluster_size_ema", torch.zeros(rows - 1))
        self.register_buffer("embed_ema", torch.zeros(rows - 1, dim))


class VectorQuantizeEMA(nn.Module):
    def __init__(self, codebook_size=1024, codebook_dim=256, accept_image_fmap=True,
                 commitment_beta=0.25, decay=0.99, restart_unused_codes=True,
                 channel_last=True, ema=True, eps=1e-5, use_pallas=None):
        super().__init__()
        self.codebook_size = codebook_size
        self.codebook_dim = codebook_dim
        self.commitment_beta = commitment_beta
        self.decay = decay
        self.restart_unused_codes = restart_unused_codes
        self.ema = ema
        self.eps = eps
        self.codebook = _Codebook(codebook_size + 1, codebook_dim)

    @torch.no_grad()
    def init_codebook(self, generator: torch.Generator):
        """Reference init: uniform(-1/K, 1/K) for the K real codes; the
        padding row K stays zero; `embed_ema` starts as the codes and
        `cluster_size_ema` at zero."""
        k = self.codebook_size
        w = self.codebook.weight
        w.uniform_(-1.0 / k, 1.0 / k, generator=generator)
        w[k].zero_()
        self.codebook.embed_ema.copy_(w[:k])
        self.codebook.cluster_size_ema.zero_()

    def forward(self, x, codebook_mask=None, temp=0.0, train=False, generator=None,
                commit=True):
        """Quantize (B, H, W, D) NHWC features (or (B, N, D) with
        `accept_image_fmap=False`); `codebook_mask` weighs the commitment loss
        per position. With `train=True` (and `ema`) the search also returns
        the cluster statistics and the EMA buffers are updated from them,
        after this batch was quantized with the codebook from before the
        update; `generator` draws the restart candidates; `commit=False`
        skips the update. Returns (x_q, loss, (None, None, code)) as the
        reference does. bf16 features (the DQ-VAE in bf16) are searched as
        f32; x_q, the straight-through output, and the loss are f32, as the
        JAX module's dtype promotion makes them."""
        d = x.shape[-1]
        flat = x.detach().reshape(-1, d)
        codebook = self.codebook.weight[:-1]
        if train and self.ema:
            idx, xq, embed_sum, cluster_size = nearest_codes_with_stats(flat, codebook)
            if commit:
                world = active()
                if world is not None:  # one collective for both sums
                    k = cluster_size.shape[0]
                    both = world.sum_(torch.cat([embed_sum.reshape(-1), cluster_size]))
                    embed_sum, cluster_size = both[:-k].view_as(embed_sum), both[-k:]
                self._ema_update(all_rows(flat), embed_sum, cluster_size, generator)
        else:
            idx, xq = nearest_codes(flat, codebook)
        xq = xq.reshape(x.shape)
        err = (xq - x) ** 2
        if codebook_mask is not None:
            err = err * codebook_mask.reshape(x.shape[:-1] + (1,)).to(x.dtype)
        # beta * |sg(x_q) - x|^2 + |x_q - sg(x)|^2: the codebook is a buffer,
        # so the second term has a value and no gradient
        loss = self.commitment_beta * err.mean() + err.detach().mean()
        x_q = x + (xq - x).detach()  # straight-through
        return x_q, loss, (None, None, idx.reshape(x.shape[:-1]))

    def _draw_restart(self, pool_rows: int, noise_shape, generator, device):
        """(jitter in [0, 1) of `noise_shape`, or None; a permutation of
        `pool_rows`) for the restart candidates, from `generator`."""
        noise = (None if noise_shape is None
                 else torch.rand(noise_shape, generator=generator, device=device))
        return noise, torch.randperm(pool_rows, generator=generator, device=device)

    @torch.no_grad()
    def _ema_update(self, vectors, embed_sum, cluster_size, generator=None):
        """Decay the cluster statistics towards this batch's, restart the
        codes whose decayed count fell below 1 from randomly permuted input
        rows (tiled and jittered when the batch has fewer rows than codes),
        and refresh the K real codebook rows; the padding row is untouched."""
        k, d, decay = self.codebook_size, self.codebook_dim, self.decay
        cb = self.codebook
        cluster_ema = cb.cluster_size_ema * decay + cluster_size * (1 - decay)
        embed_ema = cb.embed_ema * decay + embed_sum * (1 - decay)
        if self.restart_unused_codes:
            n_vectors = vectors.shape[0]
            pool, noise_shape = vectors, None
            if n_vectors < k:
                pool = vectors.repeat((k + n_vectors - 1) // n_vectors, 1)
                noise_shape = pool.shape
            noise, perm = self._draw_restart(pool.shape[0], noise_shape, generator,
                                             vectors.device)
            if noise is not None:
                pool = pool + noise * (0.01 / d ** 0.5)
            candidates = pool[perm[:k]]
            usage = (cluster_ema >= 1.0).to(embed_ema.dtype)
            embed_ema = embed_ema * usage[:, None] + candidates * (1.0 - usage[:, None])
            cluster_ema = cluster_ema * usage + (1.0 - usage)
        cb.cluster_size_ema.copy_(cluster_ema)
        cb.embed_ema.copy_(embed_ema)
        n = cluster_ema.sum()
        normalized = n * (cluster_ema + self.eps) / (n + k * self.eps)
        cb.weight[:k].copy_(embed_ema / normalized[:, None])

    def get_codebook_entry(self, indices):
        """Embed code indices (the padding code K included): (B, ...) -> (B, ..., D)."""
        return self.codebook.weight[indices]

    def get_soft_codes(self, x, temp: float = 1.0, stochastic: bool = False, generator=None):
        """(softmax(-d^2 / temp) over the K codes (..., K), codes (...)) of
        features x (..., D), with d^2 = |x|^2 + |c|^2 - 2 x.c against the
        real codes; the code is the argmin of d^2, or with `stochastic` drawn
        from the softmax with `generator` (JAX draws from its key, so the two
        agree in distribution only). A plain product, as in the JAX module."""
        codebook = self.codebook.weight[:-1]
        flat = x.reshape(-1, x.shape[-1])
        d2 = ((flat ** 2).sum(dim=1, keepdim=True) + (codebook ** 2).sum(dim=1)[None, :]
              - 2.0 * flat @ codebook.t())
        soft = torch.softmax(-d2 / temp, dim=-1)
        if stochastic:
            if generator is None:
                raise ValueError("stochastic soft codes need a torch.Generator")
            code = torch.multinomial(soft, 1, generator=generator)[:, 0]
        else:
            code = torch.argmin(d2, dim=-1)
        return (soft.reshape(x.shape[:-1] + (self.codebook_size,)),
                code.reshape(x.shape[:-1]))
