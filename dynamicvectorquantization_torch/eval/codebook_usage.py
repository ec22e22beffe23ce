"""Codebook usage of a DQ-VAE (counterpart of the JAX package's
`scripts/tools/codebook_usage_dqvae.py`):

    python -m dynamicvectorquantization_torch.eval.codebook_usage \\
        --yaml_path configs/stage1/dqvae-entropy-dual-r05_imagenet.yml \\
        [--model_path <reference .ckpt | stage-1 checkpoints/>] \\
        [--dataset synthetic | imagenet] [--batch_size 16] [--max_batches 32]

Encodes the dataset through the port's `encode` (on the card: the patch
entropy, the strided downsample, the attention and the nearest-code
kernels) and counts each code's occurrences. Prints the JAX script's two
lines (the share of codes used, the entropy of the code distribution in
nats) and, last, one JSON line with the same numbers, the images and the
seconds. `--dataset synthetic` is the JAX script's `SyntheticDataset`
(seeded uniform noise at the model's image size; the port's copy in
`data/datasets.py` gives the same images), `imagenet` the validation split
under `DQVQ_IMAGENET_ROOT`. Without `--model_path` the weights are seeded.
Runs on the CUDA card unless `--device` names another device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def get_parser():
    p = argparse.ArgumentParser(description="DQ-VAE codebook usage (PyTorch + CUDA)")
    p.add_argument("--yaml_path", type=str, required=True)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--dataset", type=str, default="synthetic", choices=("synthetic", "imagenet"))
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_batches", type=int, default=32)
    p.add_argument("--device", type=str, default=None,
                   help="default: the CUDA card; cpu runs the plain-PyTorch versions")
    return p


def usage(counts):
    """(share of codes used in %, codes used, entropy of the code
    distribution in nats)."""
    probs = counts / max(counts.sum(), 1)
    nz = probs[probs > 0]
    return float((counts > 0).mean() * 100), int((counts > 0).sum()), float(-(nz * np.log(nz)).sum())


def main(argv=None):
    opt = get_parser().parse_args(argv)
    from ..data.datasets import ImageNetValidation, SyntheticDataset
    from ..data.pipeline import PrefetchLoader
    from ..utils.model_loading import load_first_stage_model

    t0 = time.perf_counter()
    model = load_first_stage_model(opt.yaml_path, opt.model_path, opt.device)
    device = next(model.parameters()).device
    if opt.dataset == "synthetic":
        ds = SyntheticDataset(size=model.image_size, length=opt.batch_size * opt.max_batches)
    else:
        ds = ImageNetValidation({"size": model.image_size})
    loader = PrefetchLoader(ds, batch_size=opt.batch_size, shuffle=False)
    k = model.quantize.codebook_size
    counts = np.zeros(k, np.int64)
    images = 0
    for bi, batch in enumerate(loader.epoch(0)):
        if bi >= opt.max_batches:
            break
        with torch.no_grad():
            codes = model.encode(torch.as_tensor(batch["image"]).to(device))[2][2]
        counts += np.bincount(codes.cpu().numpy().reshape(-1), minlength=k)
        images += len(batch["image"])
        print(f"\r batch {bi}", end="", file=sys.stderr)
    print(file=sys.stderr)
    used_pct, used, ent = usage(counts)
    print(f"codebook usage: {used_pct:.2f}%  ({used}/{k} codes)")
    print(f"code distribution entropy: {ent:.3f} nats (max {np.log(k):.3f})")
    print(json.dumps({"usage_percent": used_pct, "codes_used": used, "codebook_size": k,
                      "entropy_nats": ent, "max_entropy_nats": float(np.log(k)),
                      "images": images, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
