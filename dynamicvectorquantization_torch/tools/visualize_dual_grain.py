"""Grain-map overlays on validation images (counterpart of the JAX
package's `scripts/tools/visualize_dual_grain.py`; reference
`scripts/tools/visualize_dual_grain.py`):

    python -m dynamicvectorquantization_torch.tools.visualize_dual_grain \\
        --yaml_path configs/stage1/dqvae-entropy-dual-r05_imagenet.yml \\
        [--model_path <reference .ckpt | stage-1 checkpoints/>] \\
        --dataset imagenet --num_images 16 --save_path grain_vis

The first `--num_images` images of the dataset (`synthetic`, or the ImageNet
validation split under `DQVQ_IMAGENET_ROOT` for any other name, as the JAX
script) are encoded by the stage-1 model on the card (`--device cpu` for the
plain versions; seeded weights without `--model_path`), each grain region
tinted (`utils/logging.py` `draw_grain_map_color`) and the grid written as
`<save_path>/grain_overlay.png` with the port's own PNG writer (no PIL). The
last stdout line is a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def get_parser():
    p = argparse.ArgumentParser(description="grain-map overlays (PyTorch + CUDA)")
    p.add_argument("--yaml_path", type=str, required=True)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--save_path", type=str, default="grain_vis")
    p.add_argument("--num_images", type=int, default=16)
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--device", type=str, default=None,
                   help="default: the CUDA card; cpu runs the plain versions")
    return p


def overlay(model, images, device):
    """(N, H, W, 3) float images in [-1, 1] -> their grain-map overlay."""
    import numpy as np
    import torch

    from ..utils.logging import draw_grain_map_color

    with torch.no_grad():
        grains = model.encode(torch.as_tensor(images, device=device))[3]
    return draw_grain_map_color(np.asarray(images), grains.cpu().numpy())


def main(argv=None):
    opt = get_parser().parse_args(argv)
    from ..data import datasets
    from ..data.pipeline import PrefetchLoader
    from ..utils.device import resolve_device
    from ..utils.logging import encode_png, make_grid, to_uint8
    from ..utils.model_loading import load_first_stage_model

    device = resolve_device(opt.device)
    model = load_first_stage_model(opt.yaml_path, opt.model_path, device)
    if opt.dataset == "synthetic":
        ds = datasets.SyntheticDataset(size=model.image_size, length=opt.num_images)
    else:
        ds = datasets.ImageNetValidation({"size": model.image_size})
    loader = PrefetchLoader(ds, batch_size=opt.num_images, shuffle=False)
    batch = next(iter(loader.epoch(0)))
    grid = make_grid(to_uint8(overlay(model, batch["image"], device)))
    os.makedirs(opt.save_path, exist_ok=True)
    out = os.path.join(opt.save_path, "grain_overlay.png")
    with open(out, "wb") as f:
        f.write(encode_png(grid))
    print("wrote", out)
    print(json.dumps({"out": out, "images": int(len(batch["image"])),
                      "grid_shape": list(grid.shape), "device": str(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
