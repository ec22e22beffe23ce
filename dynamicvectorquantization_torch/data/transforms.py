"""Host-side image transforms on `(array, mode)` images (counterpart of
`dynamicvectorquantization_tpu/data/transforms.py`, which works on PIL
images), matching the reference's torchvision pipelines:

  * ImageNet train: Resize(shorter side -> size) + RandomCrop(size) + HFlip;
    val: Resize + CenterCrop; then Normalize(0.5, 0.5) -> [-1, 1].
  * FFHQ train: RandomResizedCrop(scale 0.75-1.0, ratio 1.0) + HFlip; val:
    Resize(size x size).

An image is a pair `(array, mode)` from `data/image_io.py`: an (H, W, C)
uint8 array and the Pillow mode of the JAX package's image. Each step gives
what Pillow gives on that mode, bit for bit, without PIL: the resize is
Pillow's resampler (`native.resample`; NEAREST for "P" and "1", RGBA / LA
resized premultiplied as Pillow's RGBa / La and converted back), a crop a
slice, a flip `[:, ::-1]`, and `_to_array` Pillow's `convert("RGB")`
followed by the JAX package's `/ 255.0`, `* 2.0 - 1.0` in float32. Random
draws come from the caller's `numpy.random.Generator` in the JAX package's
order, so both packages crop and flip alike.

Output: HWC float32 in [-1, 1].
"""
from __future__ import annotations

import numpy as np

from .. import native

NEAREST, BILINEAR, BICUBIC = native.NEAREST, native.BILINEAR, native.BICUBIC


def _size(img):
    """(width, height), as PIL's `Image.size`."""
    arr = img[0]
    return arr.shape[1], arr.shape[0]


def _muldiv255(a, b):
    """Pillow's MULDIV255: a * b / 255 rounded, in integers."""
    t = a.astype(np.uint32) * b + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def _premultiply(arr):
    """RGBA -> RGBa, LA -> La (Pillow's rgbA2rgba / lA2la)."""
    alpha = arr[..., -1:].astype(np.uint32)
    return np.concatenate([_muldiv255(arr[..., :-1], alpha), arr[..., -1:]], axis=-1)


def _unpremultiply(arr):
    """RGBa -> RGBA, La -> LA (Pillow's rgba2rgbA / la2lA): 255 * v / alpha
    clipped, the values kept where alpha is 0 or 255."""
    alpha = arr[..., -1:].astype(np.int32)
    color = arr[..., :-1].astype(np.int32)
    keep = (alpha == 0) | (alpha == 255)
    scaled = np.clip(255 * color // np.where(keep, 1, alpha), 0, 255)
    return np.concatenate([np.where(keep, color, scaled).astype(np.uint8), arr[..., -1:]],
                          axis=-1)


def resize(img, size, resample=BILINEAR):
    """PIL's `img.resize(size, resample)`, size = (width, height)."""
    arr, mode = img
    w, h = size
    if _size(img) == (w, h):  # PIL returns a copy; no step here writes into an array
        return img
    if mode in ("P", "1"):
        return native.resample(arr, h, w, NEAREST), mode
    if mode in ("RGBA", "LA") and resample != NEAREST:
        return _unpremultiply(native.resample(_premultiply(arr), h, w, resample)), mode
    return native.resample(arr, h, w, resample), mode


def crop(img, box):
    """PIL's `img.crop((left, top, right, bottom))` inside the image: a
    slice. Every crop of the transforms lies inside; one outside raises
    (PIL would fill it with zeros)."""
    arr, mode = img
    left, top, right, bottom = (int(v) for v in box)
    if left < 0 or top < 0 or right > arr.shape[1] or bottom > arr.shape[0]:
        raise ValueError(f"crop {box} outside a {arr.shape[1]}x{arr.shape[0]} image")
    return arr[top:bottom, left:right], mode


def flip_left_right(img):
    arr, mode = img
    return arr[:, ::-1], mode


def to_rgb(img) -> np.ndarray:
    """Pillow's `convert("RGB")` -> (H, W, 3) uint8."""
    arr, mode = img
    if mode in ("RGB", "P"):
        return arr
    if mode in ("L", "1", "LA"):
        return np.repeat(arr[..., :1], 3, axis=-1)
    if mode == "RGBA":
        return arr[..., :3]
    if mode == "CMYK":  # Pillow's cmyk2rgb
        nk = (255 - arr[..., 3:4]).astype(np.uint32)
        return (nk - _muldiv255(arr[..., :3], nk)).astype(np.uint8)
    raise ValueError(f"no RGB conversion for mode {mode!r}")


def _to_array(img) -> np.ndarray:
    arr = np.asarray(to_rgb(img), dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0


def resize_shorter(img, size: int):
    w, h = _size(img)
    if w < h:
        nw, nh = size, max(size, int(round(h * size / w)))
    else:
        nw, nh = max(size, int(round(w * size / h))), size
    return resize(img, (nw, nh), BILINEAR)


def center_crop(img, size: int):
    w, h = _size(img)
    left = (w - size) // 2
    top = (h - size) // 2
    return crop(img, (left, top, left + size, top + size))


def random_crop(img, size: int, rng: np.random.Generator):
    w, h = _size(img)
    left = int(rng.integers(0, max(w - size, 0) + 1))
    top = int(rng.integers(0, max(h - size, 0) + 1))
    return crop(img, (left, top, left + size, top + size))


def random_resized_crop(img, size: int, rng: np.random.Generator, scale=(0.75, 1.0),
                        ratio=(1.0, 1.0)):
    w, h = _size(img)
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if cw <= w and ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            img2 = crop(img, (left, top, left + cw, top + ch))
            return resize(img2, (size, size), BILINEAR)
    return center_crop(resize_shorter(img, size), size)


def imagenet_train_transform(img, size, rng):
    img = resize_shorter(img, size)
    img = random_crop(img, size, rng)
    if rng.uniform() < 0.5:
        img = flip_left_right(img)
    return _to_array(img)


def imagenet_val_transform(img, size, rng=None):
    img = resize_shorter(img, size)
    img = center_crop(img, size)
    return _to_array(img)


def ffhq_train_transform(img, size, rng):
    img = random_resized_crop(img, size, rng)
    if rng.uniform() < 0.5:
        img = flip_left_right(img)
    return _to_array(img)


def ffhq_val_transform(img, size, rng=None):
    return _to_array(resize(img, (size, size), BILINEAR))
