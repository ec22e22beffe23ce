"""Batch sampling to pickled numpy batches and optional PNG grids, for FID
(counterpart of `scripts/sample_val/sample_dynamic_uncond.py`):

    python -m dynamicvectorquantization_torch.sample.val \\
        --yaml_path configs/stage2/uncond_imagenet_p6c18.yml --model_path <checkpoint> \\
        --save_path samples --batch_size 50 --sample_num 5000 [--kv_cache_dtype int8] \\
        [--save_grids] [--device cpu]

Writes `<save_path>/numpys/batch_{bi:05d}.pkl`, one pickled (B, H, W, 3)
uint8 array a batch (whole batches: the last may overshoot `--sample_num`),
and with `--save_grids` `<save_path>/grid_{bi:05d}.png`, the batch's first
16 images as one grid (`utils/logging.py` `encode_png`; no PIL). Prints a
progress line a batch to stderr and, at the end, one JSON line to stdout:
the images, the batches and the seconds of each batch.

`--model_path` goes through `utils/model_loading.py`
`load_model_and_variables`: a checkpoint of the port's trainer (a
`step_<n>.pt` file, its `checkpoints/` directory or the run's logdir) or a
reference-named torch state dict; without it the weights are seeded from
`--seed`. Sampling runs with the f32 parameters, as the JAX script does, and
conditions on `encode_to_c(batch_size)` (label 0 for a class model, as the
JAX script's zeros). It runs on the CUDA card unless `--device` names
another device.

`--seed` seeds one `torch.Generator` for the whole run; the JAX script
splits a PRNG key per batch, so the two draw different tokens. Their tokens
can be equal only when sampling is greedy (`--top_k 1 --top_k_pos 1`).
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

import torch

from ..utils.logging import encode_png, make_grid, to_uint8
from ..utils.model_loading import load_model_and_variables


def get_parser():
    p = argparse.ArgumentParser(description="dqvq batch sampling (PyTorch + CUDA)")
    p.add_argument("--yaml_path", type=str, required=True)
    p.add_argument("--model_path", type=str, default=None,
                   help="a port trainer checkpoint (file, checkpoints/ or logdir) or a "
                        "reference-named torch state dict; none: seeded weights")
    p.add_argument("--save_path", type=str, default="samples")
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--sample_num", type=int, default=5000)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=300)
    p.add_argument("--top_k_pos", type=int, default=1024)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--top_p_pos", type=float, default=1.0)
    p.add_argument("--sample_with_fixed_pos", action="store_true")
    p.add_argument("--save_grids", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kv_cache_dtype", type=str, default=None, choices=("int8",),
                   help="int8: quantized decode KV caches (ops/kv_int8.py)")
    p.add_argument("--device", type=str, default=None,
                   help="default: the CUDA card; cpu runs the plain-PyTorch versions")
    return p


def load(opt):
    model, _ = load_model_and_variables(opt.yaml_path, opt.model_path, opt.seed,
                                        opt.kv_cache_dtype, device=opt.device)
    return model


def sample_batches(model, opt, seconds=None):
    """(B, H, W, 3) uint8 batches of `opt.batch_size` images until
    `opt.sample_num` images are drawn; each batch's seconds are appended to
    `seconds` when given."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    knobs = dict(temperature=opt.temperature, top_k=opt.top_k, top_p=opt.top_p,
                 top_k_pos=opt.top_k_pos, top_p_pos=opt.top_p_pos,
                 fix_fine_position=opt.sample_with_fixed_pos)
    total = 0
    while total < opt.sample_num:
        t0 = time.perf_counter()
        with torch.inference_mode():
            c = model.encode_to_c(opt.batch_size, device)
            images = model.decode_to_img(
                *model.sample_from_scratch(*c, generator=generator, **knobs))
            batch = to_uint8(images.float().cpu().numpy())
        if seconds is not None:
            seconds.append(time.perf_counter() - t0)
        total += len(batch)
        print(f"sampled {total}/{opt.sample_num}", file=sys.stderr, flush=True)
        yield batch


def main(argv=None):
    opt = get_parser().parse_args(argv)
    model = load(opt)
    os.makedirs(os.path.join(opt.save_path, "numpys"), exist_ok=True)
    seconds, total = [], 0
    for bi, batch in enumerate(sample_batches(model, opt, seconds)):
        with open(os.path.join(opt.save_path, "numpys", f"batch_{bi:05d}.pkl"), "wb") as f:
            pickle.dump(batch, f)
        if opt.save_grids:
            with open(os.path.join(opt.save_path, f"grid_{bi:05d}.png"), "wb") as f:
                f.write(encode_png(make_grid(batch[:16])))
        total += len(batch)
    print(json.dumps({"images": total, "batches": len(seconds), "batch_seconds": seconds}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
