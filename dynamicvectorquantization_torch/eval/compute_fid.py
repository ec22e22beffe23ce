"""FID / rFID from sample dumps or image folders (counterpart of the JAX
package's `scripts/tools/compute_fid.py`):

    # FID: sampler dumps (`sample.val`'s numpys/) vs a folder
    python -m dynamicvectorquantization_torch.eval.compute_fid --a samples/numpys --b val/

    # rFID: a stage-1 model's reconstructions of --b vs --b
    python -m dynamicvectorquantization_torch.eval.compute_fid --rfid \\
        --yaml_path configs/stage1/dqvae-entropy-dual-r05_imagenet.yml \\
        --model_path <reference .ckpt | stage-1 checkpoints/> --b val/

Features: InceptionV3 pool3 (`eval/fid.py`) with the torchvision state_dict
that `DQVQ_INCEPTION_WEIGHTS` names. `--proxy_features` takes a fixed seeded
random projection instead, equal to the JAX script's for the same seed: it
checks the plumbing only, and its metric is named `proxy_fid` /
`proxy_rfid`. The last stdout line is one JSON object with the JAX script's
`metric` and `value` (rounded to 4 places as there; `value_unrounded`
beside it), the extractor's `variant`, the images on each side, the
seconds, and with InceptionV3 the feature extractor's images/s (over its
calls after the first).

Dumps (`.pkl`, `.npy`; uint8 or float in [-1, 1]) are read with numpy and
pickle alone; an image folder's files (`.png`, `.jpg`, `.jpeg`) with the
port's reader (`data/image_io.py`: full size, by content, no PIL for JPEG and
8-bit PNG), converted to RGB and resized with Pillow's bicubic filter
(`native.resample`), as the JAX script's `Image.open(p).convert("RGB")
.resize(..., BICUBIC)`, bit for bit. The model and the
Inception forward run on the CUDA card unless `--device` names another one.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import sys
import time

import numpy as np


def _to_float(arr):
    arr = np.asarray(arr)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 127.5 - 1.0
    return arr.astype(np.float32)


def iter_source(path, batch_size=32, limit=None, size=None):
    """(B, H, W, 3) f32 batches in [-1, 1] from the `.pkl` / `.npy` files of
    a directory, or else from its image tree (`size`: resized bicubically to
    size^2)."""
    pkls = sorted(glob.glob(os.path.join(path, "*.pkl")))
    npys = sorted(glob.glob(os.path.join(path, "*.npy")))
    n = 0
    if pkls or npys:
        for p in pkls + npys:
            if p.endswith(".pkl"):
                with open(p, "rb") as f:
                    arr = pickle.load(f)
            else:
                arr = np.load(p)
            arr = _to_float(arr)
            if arr.ndim == 3:
                arr = arr[None]
            for i in range(0, len(arr), batch_size):
                if limit and n >= limit:
                    return
                chunk = arr[i:i + batch_size]
                n += len(chunk)
                yield chunk
        return

    imgs = sorted(p for p in glob.glob(os.path.join(path, "**", "*"), recursive=True)
                  if p.lower().endswith((".png", ".jpg", ".jpeg")))
    buf = []
    for p in imgs:
        if limit and n >= limit:
            break
        buf.append(_to_float(read_rgb(p, size)))
        n += 1
        if len(buf) == batch_size:
            yield np.stack(buf)
            buf = []
    if buf:
        yield np.stack(buf)


def read_rgb(path, size=None):
    """(H, W, 3) uint8 of an image file: `Image.open(path).convert("RGB")`,
    then with `size` `.resize((size, size), Image.BICUBIC)`."""
    from .. import native
    from ..data.image_io import decode_image
    from ..data.transforms import to_rgb

    with open(path, "rb") as f:
        rgb = to_rgb(decode_image(f.read(), path))
    return native.resample(rgb, size, size, native.BICUBIC) if size else rgb


def proxy_feature_fn(dim=256, seed=0):
    """Seeded random projection of 8x8-strided pixels, tanh: plumbing checks
    only, not comparable to InceptionV3 FID."""
    rng = np.random.default_rng(seed)
    w = None

    def fn(images):
        nonlocal w
        images = np.asarray(images, np.float32)
        patches = images[:, ::8, ::8, :].reshape(images.shape[0], -1)
        if w is None:
            w = rng.normal(size=(patches.shape[1], dim)).astype(np.float32)
            w /= np.sqrt(patches.shape[1])
        return np.tanh(patches @ w)

    return fn


PROXY_VARIANT = "proxy: seeded random projection of 8x8-strided pixels (plumbing only)"


def feature_extractor(proxy: bool, device=None):
    """(feature_fn, metric name, variant)."""
    if proxy:
        print("WARNING: --proxy_features computes proxy_fid (pipeline validation only; NOT "
              "comparable to InceptionV3 FID)", file=sys.stderr)
        return proxy_feature_fn(), "proxy_fid", PROXY_VARIANT
    from .fid import INCEPTION_VARIANT, inception_feature_fn

    return inception_feature_fn(device=device), "fid", INCEPTION_VARIANT


class _Counted:
    """Passes batches through, counting their images."""

    def __init__(self, batches):
        self.batches, self.images = batches, 0

    def __iter__(self):
        for b in self.batches:
            self.images += len(b)
            yield b


def get_parser():
    p = argparse.ArgumentParser(description="FID / rFID (PyTorch + CUDA)")
    p.add_argument("--a", type=str, help="samples: dir of .pkl/.npy/images")
    p.add_argument("--b", type=str, required=True, help="data dir (same formats)")
    p.add_argument("--rfid", action="store_true",
                   help="reconstruct --b through a stage-1 model; FID(recon, b)")
    p.add_argument("--yaml_path", type=str)
    p.add_argument("--model_path", type=str)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--limit", type=int, default=None, help="cap images per side")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--proxy_features", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="default: the CUDA card; cpu runs the plain-PyTorch versions")
    return p


def main(argv=None):
    opt = get_parser().parse_args(argv)
    t0 = time.perf_counter()
    feature_fn, metric, variant = feature_extractor(opt.proxy_features, opt.device)
    from .fid import fid_between, rfid

    out = {}
    if opt.rfid:
        from ..utils.model_loading import load_first_stage_model

        if not opt.model_path:
            print("NOTE: seeded model (no --model_path): rFID is only a plumbing check",
                  file=sys.stderr)
        model = load_first_stage_model(opt.yaml_path, opt.model_path, opt.device)
        b = _Counted(iter_source(opt.b, opt.batch_size, opt.limit, opt.size))
        value = rfid(model, b, feature_fn)
        metric = "proxy_rfid" if metric == "proxy_fid" else "rfid"
        out["images"] = b.images
    else:
        if not opt.a:
            raise SystemExit("--a required unless --rfid")
        a = _Counted(iter_source(opt.a, opt.batch_size, opt.limit, opt.size))
        b = _Counted(iter_source(opt.b, opt.batch_size, opt.limit, opt.size))
        value = fid_between(a, b, feature_fn)
        out["images"] = [a.images, b.images]
    res = {"metric": metric, "value": round(value, 4), "value_unrounded": value,
           "variant": variant, **out,
           "seconds": time.perf_counter() - t0}
    if hasattr(feature_fn, "calls"):
        from .fid import images_per_s

        res["feature_images"], res["feature_images_per_s"] = images_per_s(feature_fn)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
