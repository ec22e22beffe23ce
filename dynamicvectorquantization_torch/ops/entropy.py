"""Per-patch image entropy from a Gaussian-KDE histogram (counterpart of
`dynamicvectorquantization_tpu/ops/entropy.py` `patch_entropy`).

Rec.601 gray (0.2989, 0.5870, 0.1140), non-overlapping `patch_size` patches,
`num_bins` bins from `bin_range` (default (-1, 1): images live in [-1, 1];
the offline threshold tables used (0, 1), QUIRKS #8), sigma 0.01, the mean
kernel value per bin, `pdf / (sum + 1e-20) + 1e-20` (the reference's 1e-40 is
an f32 subnormal, QUIRKS #3), then -sum p log p.

On bf16 images (the first stage in bf16) the gray image is formed as the
JAX package forms it from bf16 input in its jitted encode (the trainers'
`make_encode_fn`, `train_step`), measured on the CPU: the three weights
rounded to bf16, each product and the first sum rounded to bf16, the last
sum taken in f32, since XLA fuses it with the cast to f32. This reproduces
the jitted JAX gray bit for bit; run op by op, JAX also rounds the last sum
to bf16, and on a TPU XLA may fuse more of the chain and keep excess
precision, so there the gray can differ in its last bits. The histogram and
the entropy stay f32.

`patch_entropy` launches the CUDA kernel `csrc/patch_entropy.cu` for CUDA
tensors and runs `patch_entropy_plain` for CPU tensors: the device alone
picks the route, and `use_pallas` (the JAX signature's) is ignored. The
kernel runs two warps per patch and
evaluates a pixel's kernel values exp(-0.5 r^2), r = (g - c_j) / sigma, only
in a window of bins round its nearest bin: j0 = floor((g - lo) * inv_delta +
1/2) with inv_delta = (num_bins - 1) / (hi - lo), bins j0 - W .. j0 + W,
W = `window_half_width(...)`. Every bin outside the window lies at least
`WINDOW_CUTOFF` = 15 sigma from the pixel, where the value (exp of at most
-112.5) is +0 in f32 (it is from 14.43 sigma on), and leaving +0 terms out of
a sum of non-negative terms changes no bit; each lane sums its values into a
row of a per-warp histogram in shared memory, and the rows are summed per bin
in a fixed order. The JAX package keeps its TPU kernel
off by default because XLA overlaps the plain version's elementwise work with
the convolutions; eager PyTorch has no such overlap (the plain version is
~100 small launches), so here the kernel is the default.
"""
from __future__ import annotations

import math

import torch

from . import cuda_lib

_GRAY = (0.2989, 0.5870, 0.1140)
_EPS = 1e-20
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# sigmas from a pixel past which the kernel skips a bin: exp(-0.5 * 15^2) is
# +0 in f32, as is every value from 14.43 sigma on (half the smallest subnormal)
WINDOW_CUTOFF = 15.0


def window_half_width(num_bins: int, sigma: float, bin_range) -> int:
    """W, the half-width in bins of the kernel's window round a pixel's nearest
    bin: the least W with every bin outside at least `WINDOW_CUTOFF` sigma
    away, W = ceil(WINDOW_CUTOFF / delta - 1/2) for bins delta sigma apart (a
    bin outside lies at least W + 1/2 steps from the pixel's position).
    num_bins - 1 (every bin) where the bins do not rise from lo to hi."""
    lo, hi = float(bin_range[0]), float(bin_range[1])
    delta = (hi - lo) / (num_bins - 1) / sigma
    if not (math.isfinite(delta) and delta > 0.0):
        return num_bins - 1
    return min(num_bins - 1, max(0, math.ceil(WINDOW_CUTOFF / delta - 0.5)))


def window_of(gray, num_bins: int, bin_range, half_width: int):
    """(first, last) bin of each gray value's window, as the kernel forms them in
    f32: j0 = floor((g - lo) * inv_delta + 1/2), clipped to the bins (last <
    first where the window misses them); a window of every bin takes all of
    them, and a NaN gray bins 0 .. 2W (its values, and the patch's entropy,
    are NaN, as in the plain version)."""
    lo, hi = float(bin_range[0]), float(bin_range[1])
    inv_delta = torch.tensor((num_bins - 1) / (hi - lo), dtype=torch.float32)
    j0 = torch.floor((gray.float() - lo) * inv_delta + 0.5)
    last = float(num_bins - 1)
    if half_width >= num_bins - 1:
        return torch.zeros_like(j0), torch.full_like(j0, last)
    first = torch.nan_to_num(torch.clamp(j0 - half_width, min=0.0), nan=0.0)
    return first, torch.nan_to_num(torch.clamp(j0 + half_width, max=last),
                                   nan=min(2.0 * half_width, last))


def bin_centres(num_bins: int, lo: float, hi: float, device=None):
    """`linspace(lo, hi, num_bins)` in f32 as the JAX package computes it:
    lo (1 - t) + hi t with t = j * (1 / (num_bins - 1)), the last centre hi.
    The CUDA kernel computes the same values."""
    t = torch.arange(num_bins - 1, dtype=torch.float32, device=device) * (1.0 / (num_bins - 1))
    inner = lo * (1.0 - t) + hi * t
    return torch.cat([inner, torch.full((1,), hi, dtype=torch.float32, device=device)])


def gray_image(images):
    """Rec.601 gray of (B, H, W, 3) NHWC images as f32 (B, H, W): in f32, or
    for bf16 images with JAX's bf16 roundings (see the module docstring)."""
    if images.dtype == torch.bfloat16:
        w = torch.tensor(_GRAY, dtype=torch.bfloat16, device=images.device)
        first = images[..., 0] * w[0] + images[..., 1] * w[1]
        return first.float() + (images[..., 2] * w[2]).float()
    x = images.float()
    return _GRAY[0] * x[..., 0] + _GRAY[1] * x[..., 1] + _GRAY[2] * x[..., 2]


def patch_entropy_plain(images, patch_size=16, num_bins=32, sigma=0.01, bin_range=(-1.0, 1.0)):
    """Plain PyTorch version. images: (B, H, W, 3) NHWC -> (B, H/p, W/p) f32."""
    b, h, w, _ = images.shape
    p = patch_size
    gray = gray_image(images)
    patches = (gray.reshape(b, h // p, p, w // p, p).permute(0, 1, 3, 2, 4)
               .reshape(b, h // p, w // p, p * p))
    bins = bin_centres(num_bins, float(bin_range[0]), float(bin_range[1]), images.device)
    r = (patches[..., None, :] - bins[:, None]) * (1.0 / sigma)  # (B, gh, gw, nb, p*p)
    pdf = torch.exp(-0.5 * r * r).mean(dim=-1)
    pdf = pdf / (pdf.sum(dim=-1, keepdim=True) + _EPS) + _EPS
    return -(pdf * torch.log(pdf)).sum(dim=-1)


def patch_entropy(images, patch_size=16, num_bins=32, sigma=0.01, bin_range=(-1.0, 1.0),
                  use_pallas=None):
    """Per-patch KDE-histogram entropy of (B, H, W, 3) NHWC f32 or bf16 images
    in [-1, 1] -> (B, H // patch_size, W // patch_size) f32.
    `patch_entropy.launches` counts kernel launches, `.bf16_launches` those
    of them on bf16 images."""
    b, h, w, c = images.shape
    if c != 3 or h % patch_size or w % patch_size:
        raise ValueError(f"patch_entropy: RGB NHWC images with H, W divisible by "
                         f"{patch_size} expected, got {tuple(images.shape)}")
    if images.device.type == "cpu":
        return patch_entropy_plain(images, patch_size, num_bins, sigma, bin_range)
    if images.device.type != "cuda":
        raise ValueError(f"patch_entropy: CPU or CUDA tensors only, got {images.device}")
    if images.dtype not in _DTYPE_CODE or not images.is_contiguous():
        raise TypeError(f"patch_entropy: contiguous f32 or bf16 images expected, got "
                        f"{images.dtype}")
    if not 2 <= num_bins <= 32:
        raise ValueError(f"patch_entropy: the kernel takes 2..32 bins, got {num_bins}")
    out = torch.empty((b, h // patch_size, w // patch_size), dtype=torch.float32,
                      device=images.device)
    lo, hi = float(bin_range[0]), float(bin_range[1])
    err = cuda_lib.lib().dqvq_patch_entropy(
        images.data_ptr(), out.data_ptr(), b, h, w, patch_size, num_bins, lo, hi,
        1.0 / (num_bins - 1), 1.0 / sigma, (num_bins - 1) / (hi - lo) if hi != lo else 0.0,
        window_half_width(num_bins, sigma, bin_range), _DTYPE_CODE[images.dtype],
        torch.cuda.current_stream(images.device).cuda_stream)
    cuda_lib.check(err, "patch_entropy")
    patch_entropy.launches += 1
    patch_entropy.bf16_launches += images.dtype == torch.bfloat16
    return out


patch_entropy.launches = 0
patch_entropy.bf16_launches = 0  # those of `launches` on bf16 images
