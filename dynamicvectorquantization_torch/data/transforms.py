"""Host-side image transforms on PIL images (counterpart of
`dynamicvectorquantization_tpu/data/transforms.py`), matching the reference's
torchvision pipelines.

  * ImageNet train: Resize(shorter side -> size) + RandomCrop(size) + HFlip;
    val: Resize + CenterCrop; then Normalize(0.5, 0.5) -> [-1, 1].

Output: HWC float32 in [-1, 1]. The functions take PIL images but the module
does not import PIL (the resampling and flip codes below are PIL's own
constants), so importing the port needs no PIL; opening a file does
(`data/datasets.py` `FileListDataset._open`). Random draws come from the
caller's `numpy.random.Generator` in the JAX package's order, so both
packages crop and flip alike.
"""
from __future__ import annotations

import numpy as np

BILINEAR = 2  # PIL.Image.BILINEAR
FLIP_LEFT_RIGHT = 0  # PIL.Image.FLIP_LEFT_RIGHT


def _to_array(img) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0


def resize_shorter(img, size: int):
    w, h = img.size
    if w < h:
        nw, nh = size, max(size, int(round(h * size / w)))
    else:
        nw, nh = max(size, int(round(w * size / h))), size
    return img.resize((nw, nh), BILINEAR)


def center_crop(img, size: int):
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def random_crop(img, size: int, rng: np.random.Generator):
    w, h = img.size
    left = int(rng.integers(0, max(w - size, 0) + 1))
    top = int(rng.integers(0, max(h - size, 0) + 1))
    return img.crop((left, top, left + size, top + size))


def imagenet_train_transform(img, size, rng):
    img = resize_shorter(img, size)
    img = random_crop(img, size, rng)
    if rng.uniform() < 0.5:
        img = img.transpose(FLIP_LEFT_RIGHT)
    return _to_array(img)


def imagenet_val_transform(img, size, rng=None):
    img = resize_shorter(img, size)
    img = center_crop(img, size)
    return _to_array(img)
