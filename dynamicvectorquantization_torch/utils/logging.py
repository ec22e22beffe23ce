"""Metric and image logging (counterpart of
`dynamicvectorquantization_tpu/utils/logging.py` and `utils/viz.py`).

`MetricLogger` appends one row per call to `<logdir>/metrics.jsonl` and
`<logdir>/metrics.csv` with the JAX package's row keys (`step`, `split`,
`time`, then the metric names), and with `logtype` naming them (or "all"
for tensorboard) the JAX package's other sinks: tensorboard event files
under `<logdir>/tb/` (`torch.utils.tensorboard.SummaryWriter`; it raises
ImportError where `tensorboard` is absent, as the JAX sink does) and wandb
(skipped with the JAX package's message where `wandb` is absent), both
tagged `<split>/<name>`. `ImageLogger` writes PNG grids to
`<logdir>/images/<split>/` under the same file names; the PNGs are encoded
here with `zlib` + `struct`, so logging needs no imaging library.
`SetupCallback` and `LightningShim` keep the reference launcher's callback
and logger entries instantiable (`config/registry.py`).
"""
from __future__ import annotations

import csv
import json
import os
import struct
import time
import zlib
from typing import Mapping

import numpy as np


class MetricLogger:
    def __init__(self, logdir: str, logtype: str = "csv"):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self.jsonl_path = os.path.join(logdir, "metrics.jsonl")
        self._csv_path = os.path.join(logdir, "metrics.csv")
        self._csv_keys = None
        self._tb = self._wandb = None
        if "tensorboard" in logtype or logtype == "all":
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(os.path.join(logdir, "tb"))
        if "wandb" in logtype:
            try:
                import wandb
            except ImportError:
                print("wandb not installed; skipping wandb sink")
            else:
                wandb.init(project=os.environ.get("WANDB_PROJECT", "dqvq-tpu"), dir=logdir)
                self._wandb = wandb

    def log(self, step: int, metrics: Mapping[str, float], split: str = "train"):
        row = {"step": int(step), "split": split, "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        with open(self._csv_path, "a", newline="") as f:
            writer = csv.writer(f)
            if self._csv_keys is None:
                self._csv_keys = list(row.keys())
                writer.writerow(self._csv_keys)
            writer.writerow([row.get(k, "") for k in self._csv_keys])
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{split}/{k}", float(v), int(step))
            self._tb.flush()  # rows are rare (every `log_every` steps); a reader sees each
        if self._wandb is not None:
            self._wandb.log({f"{split}/{k}": float(v) for k, v in metrics.items()},
                            step=int(step))

    def close(self):
        if self._tb is not None:
            self._tb.close()


def to_uint8(img):
    """[-1, 1] float -> uint8."""
    return np.clip((np.asarray(img) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def make_grid(images, ncol=4, pad=2):
    """(N, H, W, C) -> one (rows * (H + pad) - pad, cols * (W + pad) - pad, C) grid."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = min(ncol, n)
    nrow = (n + ncol - 1) // ncol
    grid = np.zeros((nrow * (h + pad) - pad, ncol * (w + pad) - pad, c), images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[r * (h + pad):r * (h + pad) + h, col * (w + pad):col * (w + pad) + w] = images[i]
    return grid


def encode_png(image) -> bytes:
    """(H, W, 3) or (H, W, 1) / (H, W) uint8 -> the bytes of an 8-bit PNG
    (filter type 0 on every row, one zlib stream)."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    if c not in (1, 3):
        raise ValueError(f"PNG needs 1 or 3 channels, got {c}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * c)], axis=1).tobytes()

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


class SetupCallback:
    """Registry shim for the reference's `utils.logger.SetupCallback`: the
    trainer's command line writes the merged config and argv itself
    (`train/cli.py`); this keeps reference train-config blobs instantiable."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs


class LightningShim:
    """Accepts any arguments; stands in for the reference's pytorch_lightning
    callbacks and loggers (ModelCheckpoint: the loop's top-k + newest
    checkpoints; LearningRateMonitor: the per-step lr metric;
    TensorBoardLogger / WandbLogger: `--logtype tensorboard` / `wandb`;
    RichModelSummary: nothing)."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs


class ImageLogger:
    """PNG grid dumps every `batch_frequency` batches (0 or less: never)."""

    def __init__(self, logdir: str = "logs", batch_frequency: int = 50, max_images: int = 4):
        self.root = os.path.join(logdir, "images")
        self.batch_frequency = batch_frequency
        self.max_images = max_images

    def should_log(self, batch_idx: int, width: int = 1) -> bool:
        """True when `batch_idx` lands on (or, with `width` > 1, within
        `width` steps after) a multiple of the frequency."""
        return self.batch_frequency > 0 and batch_idx % self.batch_frequency < width

    def log(self, images: Mapping[str, np.ndarray], split: str, global_step: int, epoch: int,
            batch_idx: int):
        outdir = os.path.join(self.root, split)
        os.makedirs(outdir, exist_ok=True)
        for name, batch in images.items():
            grid = make_grid(to_uint8(np.asarray(batch)[: self.max_images]))
            fname = f"{name}_Step_{global_step}_e-{epoch}_b-{batch_idx}.png"
            with open(os.path.join(outdir, fname), "wb") as f:
                f.write(encode_png(grid))


# grain index -> RGB tint in [-1, 1] space (coarse blue, median green, fine red)
_PALETTE = np.array(
    [[-0.5, -0.5, 1.0], [-0.5, 1.0, -0.5], [1.0, -0.5, -0.5], [1.0, 1.0, -0.5]], np.float32)


def draw_grain_map_color(images, indices, scaler: float = 0.7):
    """Blend a per-grain colour over each region of the images plus grid
    lines. images: (B, H, W, 3) in [-1, 1]; indices: (B, h, w) int grains, or
    float in [0, 1] (a normalised entropy map: blue -> red ramp)."""
    images = np.asarray(images, np.float32)
    indices = np.asarray(indices)
    _, h, w, _ = images.shape
    fy, fx = h // indices.shape[1], w // indices.shape[2]
    if np.issubdtype(indices.dtype, np.floating):
        t = np.clip(indices, 0.0, 1.0)[..., None]
        color = t * _PALETTE[2] + (1 - t) * _PALETTE[0]
    else:
        color = _PALETTE[np.clip(indices, 0, len(_PALETTE) - 1)]
    color_up = np.repeat(np.repeat(color, fy, axis=1), fx, axis=2)
    out = images * scaler + color_up * (1.0 - scaler)
    out[:, ::fy, :, :] = -1.0
    out[:, :, ::fx, :] = -1.0
    return np.clip(out, -1.0, 1.0)
