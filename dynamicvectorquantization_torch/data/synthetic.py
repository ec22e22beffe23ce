"""Procedural synthetic image dataset (the port's own copy of
`dynamicvectorquantization_tpu/data/synthetic.py`; pure numpy, so the two
give the same images).

Structured, learnable images rather than noise: smooth low-frequency
backgrounds, solid soft-edged shapes (coarse regions) and high-frequency
textured shapes (stripes / checker: fine regions), so reconstruction losses
have signal and the dual-grain entropy router sees a bimodal patch-entropy
distribution. Deterministic per index: `SyntheticImages(n, seed)[i]` is a
pure function of (seed, i). Images are float32 HWC in [-1, 1] like every
dataset in `data/datasets.py`.
"""
from __future__ import annotations

import numpy as np

__all__ = ["synth_image", "build_pool", "SyntheticImages"]


def synth_image(rng: np.random.Generator, size: int = 256) -> np.ndarray:
    """One structured image, (size, size, 3) float32 in [-1, 1]."""
    x, y = np.meshgrid(
        np.arange(size, dtype=np.float32), np.arange(size, dtype=np.float32),
        indexing="xy",
    )
    # low-frequency background: per-channel 2D cosine field
    img = np.empty((size, size, 3), np.float32)
    for c in range(3):
        fx, fy = rng.uniform(0.5, 2.5, 2) * (2 * np.pi / size)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        img[..., c] = 0.35 * np.cos(fx * x + px) * np.cos(fy * y + py) + rng.uniform(
            -0.25, 0.25
        )

    for _ in range(int(rng.integers(5, 11))):
        cx, cy = rng.uniform(0.08, 0.92, 2) * size
        r = rng.uniform(0.05, 0.22) * size
        color = rng.uniform(-0.95, 0.95, 3).astype(np.float32)
        kind = int(rng.integers(0, 4))
        if kind == 0:  # soft-edged circle (smooth -> coarse grain)
            d = np.sqrt((x - cx) ** 2 + (y - cy) ** 2)
            a = np.clip((r - d) / 2.0, 0.0, 1.0)
            fill = color[None, None, :]
        elif kind == 1:  # soft-edged axis-aligned rectangle (smooth)
            w_, h_ = rng.uniform(0.6, 1.6, 2) * r
            a = np.clip((w_ - np.abs(x - cx)) / 2.0, 0.0, 1.0) * np.clip(
                (h_ - np.abs(y - cy)) / 2.0, 0.0, 1.0
            )
            fill = color[None, None, :]
        elif kind == 2:  # striped circle (high-frequency -> fine grain)
            d = np.sqrt((x - cx) ** 2 + (y - cy) ** 2)
            a = np.clip((r - d) / 1.5, 0.0, 1.0)
            freq = rng.uniform(0.35, 1.1)
            ang = rng.uniform(0.0, np.pi)
            tex = np.sign(np.sin(freq * (np.cos(ang) * x + np.sin(ang) * y)))
            c2 = rng.uniform(-0.95, 0.95, 3).astype(np.float32)
            fill = np.where(
                tex[..., None] > 0, color[None, None, :], c2[None, None, :]
            )
        else:  # checkered rectangle (high-frequency)
            w_, h_ = rng.uniform(0.6, 1.6, 2) * r
            a = np.clip((w_ - np.abs(x - cx)) / 2.0, 0.0, 1.0) * np.clip(
                (h_ - np.abs(y - cy)) / 2.0, 0.0, 1.0
            )
            cell = float(rng.integers(3, 9))
            tex = ((x // cell + y // cell) % 2.0) * 2.0 - 1.0
            c2 = rng.uniform(-0.95, 0.95, 3).astype(np.float32)
            fill = np.where(
                tex[..., None] > 0, color[None, None, :], c2[None, None, :]
            )
        a = a[..., None]
        img = img * (1.0 - a) + fill * a
    return np.clip(img, -1.0, 1.0)


def build_pool(n: int, size: int = 256, seed: int = 0) -> np.ndarray:
    """(n, size, size, 3) uint8 pool; decode with `decode_pool_batch`."""
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        out[i] = np.round((synth_image(rng, size) + 1.0) * 127.5).astype(np.uint8)
    return out


def decode_pool_batch(pool: np.ndarray, idx: np.ndarray, flip: np.ndarray | None = None):
    """uint8 pool rows -> float32 [-1, 1] batch, optional per-sample h-flip."""
    batch = pool[idx].astype(np.float32) / 127.5 - 1.0
    if flip is not None:
        batch[flip] = batch[flip, :, ::-1]
    return batch


class SyntheticImages:
    """Map-style dataset wrapper matching `data/datasets.py` conventions:
    `__getitem__` returns {"image": (H, W, 3) float32 in [-1, 1],
    "class_label": 0}. Usable as a drop-in dataset target for smoke/campaign
    configs (registry target `data.synthetic.SyntheticImages`)."""

    def __init__(self, n: int = 1024, size: int = 256, seed: int = 0, config=None):
        if config:  # the reference datasets' `config: {size: ...}` block
            size = config.get("size", size)
        self.n, self.size, self.seed = int(n), int(size), int(seed)

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, int(i)]))
        return {"image": synth_image(rng, self.size), "class_label": 0}
