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
tensors and runs `patch_entropy_plain` for CPU tensors; `use_pallas=False`
selects the plain version explicitly. The JAX package keeps its TPU kernel
off by default because XLA overlaps the plain version's elementwise work with
the convolutions; eager PyTorch has no such overlap (the plain version is
~100 small launches), so here the kernel is the default.
"""
from __future__ import annotations

import torch

from . import cuda_lib

_GRAY = (0.2989, 0.5870, 0.1140)
_EPS = 1e-20
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
    if use_pallas is False or images.device.type == "cpu":
        return patch_entropy_plain(images, patch_size, num_bins, sigma, bin_range)
    if images.device.type != "cuda":
        raise ValueError(f"patch_entropy: CPU or CUDA tensors only, got {images.device}")
    if images.dtype not in _DTYPE_CODE or not images.is_contiguous():
        raise TypeError(f"patch_entropy: contiguous f32 or bf16 images expected, got "
                        f"{images.dtype}")
    if not 2 <= num_bins <= 32:
        raise ValueError(f"patch_entropy: the kernel takes 2..32 bins, got {num_bins}")
    if patch_size * patch_size * 4 > 40 * 1024:
        raise ValueError(f"patch_entropy: patch_size {patch_size} exceeds the kernel's tile")
    out = torch.empty((b, h // patch_size, w // patch_size), dtype=torch.float32,
                      device=images.device)
    err = cuda_lib.lib().dqvq_patch_entropy(
        images.data_ptr(), out.data_ptr(), b, h, w, patch_size, num_bins,
        float(bin_range[0]), float(bin_range[1]), 1.0 / (num_bins - 1), 1.0 / sigma,
        _DTYPE_CODE[images.dtype], torch.cuda.current_stream(images.device).cuda_stream)
    cuda_lib.check(err, "patch_entropy")
    patch_entropy.launches += 1
    patch_entropy.bf16_launches += images.dtype == torch.bfloat16
    return out


patch_entropy.launches = 0
patch_entropy.bf16_launches = 0  # those of `launches` on bf16 images
