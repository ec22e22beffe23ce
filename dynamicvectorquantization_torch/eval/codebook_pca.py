"""2-D PCA scatter of a DQ-VAE's codebook (counterpart of the JAX package's
`scripts/tools/codebook_pca.py`):

    python -m dynamicvectorquantization_torch.eval.codebook_pca \\
        --yaml_path configs/stage1/dqvae-entropy-dual-r05_imagenet.yml \\
        [--model_path <reference .ckpt | stage-1 checkpoints/>] [--out codebook_pca.png]

Takes the codebook's rows without the padding row (the JAX script's
`[:-1]`), centres them, projects them on their first two principal
directions (numpy SVD, f32 as there) and rasterises the scatter into a
512x512 PNG written by the port's `utils/logging.py` `encode_png` (no PIL).
Prints the JAX script's line (the file, the two components' share of the
variance) and, last, one JSON line with the same and the seconds. Without
`--model_path` the weights are seeded. The model is built on the CUDA card
unless `--device` names another device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def get_parser():
    p = argparse.ArgumentParser(description="DQ-VAE codebook PCA (PyTorch)")
    p.add_argument("--yaml_path", type=str, required=True)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--out", type=str, default="codebook_pca.png")
    p.add_argument("--device", type=str, default=None,
                   help="default: the CUDA card; cpu builds the model there")
    return p


def pca_scatter(codebook, size=512):
    """(explained variance of 2 components, (size, size, 3) uint8 scatter)."""
    cb = np.asarray(codebook, np.float32)
    centered = cb - cb.mean(0)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    xy = centered @ vt[:2].T
    img = np.full((size, size, 3), 255, np.uint8)
    mn, mx = xy.min(0), xy.max(0)
    pts = ((xy - mn) / np.maximum(mx - mn, 1e-9) * (size - 9) + 4).astype(int)
    for x, y in pts:
        img[size - 1 - y - 2:size - 1 - y + 2, x - 2:x + 2] = (30, 60, 200)
    explained = float((np.linalg.norm(xy, axis=0) ** 2).sum() / (np.linalg.norm(centered) ** 2))
    return explained, img


def main(argv=None):
    opt = get_parser().parse_args(argv)
    from ..utils.logging import encode_png
    from ..utils.model_loading import load_first_stage_model

    t0 = time.perf_counter()
    model = load_first_stage_model(opt.yaml_path, opt.model_path, opt.device)
    explained, img = pca_scatter(model.quantize.codebook.weight[:-1].detach().cpu().numpy())
    with open(opt.out, "wb") as f:
        f.write(encode_png(img))
    print("wrote", opt.out, "| explained var (2 comps):", explained)
    print(json.dumps({"out": opt.out, "explained_variance_2": explained,
                      "codes": int(model.quantize.codebook_size),
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
