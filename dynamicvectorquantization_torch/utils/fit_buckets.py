"""Seconds per bucket of a short stage-2 run through the port's command line
on the card, for comparing two trees of the repository in one run.

The shipped p6c18 config trains for 2 epochs of 4 steps on the synthetic
256^2 images with the data, stream-cap and run-length overrides of
`chip_smoke.py`'s `fit` phase, without image grids unless
`--image_log_every N` asks for them (the `image_log` bucket: the loop's
`log_images`, two sampling calls on the f32 masters per grid); validation
runs after each epoch on the f32 masters. The package is imported from `--root`, so
the same script times another tree:

    python dynamicvectorquantization_torch/utils/fit_buckets.py --root <tree> --label <name> \
        [--image_log_every N]

Prints one JSON line: the run's `loop_buckets.json` (seconds per bucket,
summed over both epochs), the validation seconds per epoch, and the
attention forward's launches by kernel where the tree counts them. The
run's directory (checkpoints included) is deleted afterwards.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

P6C18 = "configs/stage2/uncond_imagenet_p6c18.yml"
STREAM_CAPS = {"coarse_max_len": 160, "fine_max_len": 644}


def overrides():
    data = "data.params"
    synthetic = "dynamicvectorquantization_torch.data.datasets.SyntheticDataset"
    out = [f"{data}.batch_size=8", f"{data}.num_workers=4"]
    for split in ("train", "validation"):
        out += [f"{data}.{split}.target={synthetic}", f"{data}.{split}.params.size=256",
                f"{data}.{split}.params.length=32"]
    return out + [f"model.params.permuter_config.params.{k}={v}" for k, v in STREAM_CAPS.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="repository tree to import the port from")
    ap.add_argument("--label", default="")
    ap.add_argument("--image_log_every", default="0", help="steps between image grids")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    # run as a script, sys.path[0] is this file's directory, whose logging.py
    # would shadow the standard library's: import from the tree instead
    sys.path[0] = root
    os.chdir(root)

    import torch

    from dynamicvectorquantization_torch.ops.attention import fused_attention_forward
    from dynamicvectorquantization_torch.train import cli

    logdir = os.path.join("build", "fit_buckets")
    shutil.rmtree(logdir, ignore_errors=True)
    counters = ("launches", "tc_launches", "fma_launches", "wide_f32_launches", "f32_tc_launches")
    for name in counters:
        if hasattr(fused_attention_forward, name):
            setattr(fused_attention_forward, name, 0)
    try:
        cli.main(["--base", P6C18, "--logdir", logdir, "--max_epochs", "2",
                  "--max_steps_per_epoch", "4", "--save_n", "1", "--log_every", "1", "--seed", "23",
                  "--image_log_every", args.image_log_every, "--name", "run", *overrides()])
        torch.cuda.synchronize()
        (run,) = [d for d in os.listdir(logdir) if d.startswith("run")]
        with open(os.path.join(logdir, run, "loop_buckets.json")) as f:
            buckets = json.load(f)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    print(json.dumps(dict(label=args.label, root=root, buckets=buckets,
                          validate_s_per_epoch=buckets["buckets"]["validate"] / 2,
                          attention_forward={name: getattr(fused_attention_forward, name)
                                             for name in counters
                                             if hasattr(fused_attention_forward, name)},
                          device=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
