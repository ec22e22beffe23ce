"""The DQ-VAE's vector quantizer, inference half.

Counterpart of `dynamicvectorquantization_tpu/ops/vq.py` `VectorQuantizeEMA`
(forward with `train=False`) and of `ops/vq_pallas.py` `nearest_codes`: the
codebook buffer of shape (K + 1, D), whose extra row K is the stage-2 padding
code and stays zero; nearest-code search; the masked commitment loss;
`get_codebook_entry`. The EMA update and unused-code restart (TPU kernel #2)
come with the stage-1 training slice (ROADMAP.md).

`nearest_codes` launches the CUDA kernel `csrc/vq_nearest.cu` for CUDA
tensors and runs `nearest_codes_plain` for CPU tensors; `use_pallas=False`
selects the plain version explicitly. Scores are |c|^2 - 2 x.c in f32 (no
|x|^2 term, no TF32: QUIRKS #9); argmin ties go to the lowest index.

The buffer lives at `codebook.weight`, the reference's state_dict name
(`quantize.codebook.weight` inside the DQ-VAE).
"""
from __future__ import annotations

import torch
from torch import nn

from . import cuda_lib


def nearest_codes_plain(x, codebook):
    """Plain PyTorch version. x: (N, D), codebook: (K, D) (no padding row)
    -> (idx (N,) int64, the codebook rows (N, D))."""
    scores = (codebook * codebook).sum(dim=1)[None, :] - 2.0 * torch.matmul(x, codebook.t())
    idx = torch.argmin(scores, dim=1)
    return idx, codebook[idx]


def nearest_codes(x, codebook, use_pallas=None):
    """Nearest codebook row per row of x: (N, D) f32, (K, D) f32 ->
    (idx (N,) int64, quantized (N, D)). `nearest_codes.launches` counts
    kernel launches."""
    if use_pallas is False or (x.device.type == "cpu" and codebook.device.type == "cpu"):
        return nearest_codes_plain(x, codebook)
    if x.device != codebook.device or x.device.type != "cuda":
        raise ValueError("nearest_codes: x and the codebook must be on one CUDA device")
    if x.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"nearest_codes: f32 inputs expected, got {x.dtype}, {codebook.dtype}")
    if x.dim() != 2 or codebook.dim() != 2 or x.shape[1] != codebook.shape[1]:
        raise ValueError(f"nearest_codes: (N, D) and (K, D) expected, got "
                         f"{tuple(x.shape)}, {tuple(codebook.shape)}")
    n, d = x.shape
    k = codebook.shape[0]
    if d % 4 or d > 424 or n == 0:
        raise ValueError(f"nearest_codes: the kernel takes D % 4 == 0 and D <= 424, got D={d}")
    x = x.contiguous()
    codebook = codebook.contiguous()
    cb_norm = (codebook * codebook).sum(dim=1)
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    err = cuda_lib.lib().dqvq_vq_nearest(
        x.data_ptr(), codebook.data_ptr(), cb_norm.data_ptr(), idx.data_ptr(), n, k, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(err, "nearest_codes")
    nearest_codes.launches += 1
    idx = idx.long()
    return idx, codebook[idx]


nearest_codes.launches = 0


class _Codebook(nn.Module):
    def __init__(self, rows: int, dim: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros(rows, dim))


class VectorQuantizeEMA(nn.Module):
    def __init__(self, codebook_size=1024, codebook_dim=256, accept_image_fmap=True,
                 commitment_beta=0.25, decay=0.99, restart_unused_codes=True,
                 channel_last=True, ema=True, eps=1e-5, use_pallas=None):
        super().__init__()
        # EMA settings are kept for config compatibility; inference reads
        # only the codebook
        self.codebook_size = codebook_size
        self.codebook_dim = codebook_dim
        self.commitment_beta = commitment_beta
        self.use_pallas = use_pallas
        self.codebook = _Codebook(codebook_size + 1, codebook_dim)

    @torch.no_grad()
    def init_codebook(self, generator: torch.Generator):
        """Reference init: uniform(-1/K, 1/K) for the K real codes; the
        padding row K stays zero."""
        k = self.codebook_size
        w = self.codebook.weight
        w.uniform_(-1.0 / k, 1.0 / k, generator=generator)
        w[k].zero_()

    def forward(self, x, codebook_mask=None, temp=0.0, train=False):
        """Quantize (B, H, W, D) NHWC features (or (B, N, D) with
        `accept_image_fmap=False`); `codebook_mask` weighs the commitment loss
        per position. Returns (x_q, loss, (None, None, code)) as the
        reference does."""
        if train:
            raise NotImplementedError(
                "the EMA codebook update comes with the stage-1 training slice (ROADMAP.md)")
        d = x.shape[-1]
        idx, xq = nearest_codes(x.reshape(-1, d), self.codebook.weight[:-1], self.use_pallas)
        xq = xq.reshape(x.shape)
        err = (xq - x) ** 2
        if codebook_mask is not None:
            err = err * codebook_mask.reshape(x.shape[:-1] + (1,)).to(x.dtype)
        # the forward value of beta * |sg(x_q) - x|^2 + |x_q - sg(x)|^2
        loss = self.commitment_beta * err.mean() + err.mean()
        x_q = x + (xq - x)  # straight-through, forward value
        return x_q, loss, (None, None, idx.reshape(x.shape[:-1]))

    def get_codebook_entry(self, indices):
        """Embed code indices (the padding code K included): (B, ...) -> (B, ..., D)."""
        return self.codebook.weight[indices]
