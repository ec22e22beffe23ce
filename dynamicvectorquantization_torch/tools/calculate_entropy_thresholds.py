"""Offline entropy-threshold percentile tables for the fixed-entropy router
(counterpart of the JAX package's `scripts/tools/calculate_entropy_thresholds.py`;
reference `scripts/tools/calculate_entropy_thresholds.py:27-110`): the
per-patch entropy over a dataset, sorted, percentiles 1..99 -> JSON
{"1": t1, ..., "99": t99}, the table `DualGrainFixedEntropyRouter` reads.

    python -m dynamicvectorquantization_torch.tools.calculate_entropy_thresholds \\
        --dataset imagenet --split train --out_dir thresholds

Bins: linspace(-1, 1, 32), the in-model convention, by default;
`--legacy_bins` takes the reference tool's linspace(0, 1, 32). The entropy
is the port's `patch_entropy`: the CUDA kernel for batches on the card (the
default device), its plain version with `--device cpu`. Batches come from
`PrefetchLoader` (the JAX tool's order) through `device_prefetch`. The file
is `entropy_thresholds_<dataset>_<split>_patch-<p>.json` in `--out_dir`; the
last stdout line is a JSON summary (path, batches, values, device).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def get_parser():
    p = argparse.ArgumentParser(description="entropy-threshold tables (PyTorch + CUDA)")
    p.add_argument("--dataset", type=str, default="synthetic",
                   choices=["imagenet", "ffhq", "synthetic"])
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--legacy_bins", action="store_true",
                   help="linspace(0,1,32) bins like the reference tool")
    p.add_argument("--out_dir", type=str, default="thresholds")
    p.add_argument("--device", type=str, default=None,
                   help="default: the CUDA card; cpu runs the plain version")
    return p


def dataset_of(name, split, image_size):
    from ..data import datasets

    if name == "imagenet":
        cls = datasets.ImageNetTrain if split == "train" else datasets.ImageNetValidation
        return cls({"size": image_size, "is_eval": True})
    if name == "ffhq":
        cls = datasets.FFHQTrain if split == "train" else datasets.FFHQValidation
        return cls(size=image_size)
    return datasets.SyntheticDataset(size=image_size, length=512)


def entropy_values(batches, patch_size, bin_range, device, entropy_fn=None):
    """Every patch's entropy over `batches` (numpy batches with "image"),
    flattened in batch order; `entropy_fn` defaults to `patch_entropy`."""
    import torch

    from ..data.pipeline import device_prefetch
    from ..ops.entropy import patch_entropy

    entropy_fn = entropy_fn or patch_entropy
    out = []
    with torch.no_grad():
        for bi, batch in enumerate(device_prefetch(batches, device)):
            e = entropy_fn(batch["image"], patch_size, bin_range=bin_range)
            out.append(e.reshape(-1).cpu().numpy())
            print(f"\r batch {bi}", end="", file=sys.stderr)
    print(file=sys.stderr)
    return np.concatenate(out)


def percentiles(values):
    """{"1": ..., "99": ...}: the sorted values at index int(n * i / 100)."""
    values = np.sort(values)
    return {str(i): float(values[min(int(len(values) * i / 100), len(values) - 1)])
            for i in range(1, 100)}


def main(argv=None):
    opt = get_parser().parse_args(argv)
    from ..data.pipeline import PrefetchLoader
    from ..utils.device import resolve_device

    device = resolve_device(opt.device)
    ds = dataset_of(opt.dataset, opt.split, opt.image_size)
    loader = PrefetchLoader(ds, batch_size=opt.batch_size, shuffle=False)
    bin_range = (0.0, 1.0) if opt.legacy_bins else (-1.0, 1.0)

    sizes = []

    def batches():
        for bi, batch in enumerate(loader.epoch(0)):
            if opt.max_batches and bi >= opt.max_batches:
                return
            sizes.append(len(batch["image"]))
            yield batch

    values = entropy_values(batches(), opt.patch_size, bin_range, device)
    os.makedirs(opt.out_dir, exist_ok=True)
    out = os.path.join(opt.out_dir, f"entropy_thresholds_{opt.dataset}_{opt.split}_patch-"
                                    f"{opt.patch_size}.json")
    with open(out, "w") as f:
        json.dump(percentiles(values), f, indent=1)
    print("wrote", out)
    print(json.dumps({"out": out, "batches": len(sizes), "images": sum(sizes),
                      "values": int(len(values)),
                      "bin_range": list(bin_range), "device": str(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
