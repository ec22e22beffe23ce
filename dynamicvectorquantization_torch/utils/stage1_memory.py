"""Where a stage-1 step's device memory goes, on the card:

    python dynamicvectorquantization_torch/utils/stage1_memory.py \\
        [--cases f32:8:0,f32:8:1,f32:30:1,bf16:30:1,f32:30:0,bf16:30:0] [--steps 2]

Each case `<dtype>:<batch>:<remat>` (dtype f32 or bf16 towers, remat 0 or
1) runs in a process of its own, so that a case that runs out of memory
leaves the next one a clean card: the shipped
`dqvae-entropy-dual-r05_imagenet.yml` at full width and depth, seeded
weights, seeded 256^2 images (as `chip_smoke.py`'s), one step, then
`--steps` steps on the host clock between synchronizes, with the peak
allocated and reserved memory over them; then one more step in which every
`torch.autograd.grad` call of the trainer (the adaptive weight's two, the
autoencoder total's, the discriminator's, in that order) reports the memory
allocated when it starts (what the forward keeps for it) and the peak above
that while it runs (the backward's own: gradients, recomputed segments,
convolution workspaces). A case that runs out of memory reports
`out_of_memory` and the allocator's message. Prints one JSON line a case.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CONFIG = "configs/stage1/dqvae-entropy-dual-r05_imagenet.yml"
GRAD_CALLS = ("d_weight_nll", "d_weight_g", "autoencoder", "discriminator")


def spread(values):
    """Repeat count and spread (min / median / max) of repeated measurements."""
    v = sorted(values)
    mid = len(v) // 2
    median = v[mid] if len(v) % 2 else (v[mid - 1] + v[mid]) / 2
    return {"n": len(v), "min": v[0], "median": median, "max": v[-1]}


def images(torch, dev, b, size=256):
    """Seeded NHWC images in [-1, 1], left half smooth, right half noise (as
    `chip_smoke.py`'s `smooth_and_noisy_images`)."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.rand((b, size, size, 3), generator=g, device=dev) * 2 - 1
    ramp = torch.linspace(-0.5, 0.5, size, device=dev).view(1, 1, size, 1)
    x[:, :, :size // 2] = ramp[:, :, :size // 2] + 0.005 * x[:, :, :size // 2]
    return x.contiguous()


def gb(n_bytes):
    return n_bytes / 2 ** 30


def run_case(case, steps):
    import torch

    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    dtype, batch, remat = case.split(":")
    batch, remat = int(batch), bool(int(remat))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    overrides = ["model.params.compute_dtype=bfloat16"] if dtype == "bf16" else []
    config = load_config([CONFIG], overrides)["model"]
    with torch.device(dev):
        model = instantiate_from_config(config)
    trainer = Stage1Trainer(model, config["base_learning_rate"] * batch, warmup_steps=0,
                            max_steps=10_000, device=dev, remat=remat)
    trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    x = images(torch, dev, batch)
    out = dict(case=case, dtype=dtype, batch=batch, remat=remat, config=CONFIG,
               card=torch.cuda.get_device_name(0))
    try:
        trainer.train_step(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            trainer.train_step(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out.update(step_ms=spread(times)["median"], step_ms_spread=spread(times),
                   peak_allocated_gb=gb(torch.cuda.max_memory_allocated()),
                   peak_reserved_gb=gb(torch.cuda.max_memory_reserved()),
                   allocated_between_steps_gb=gb(torch.cuda.memory_allocated()))
        calls, grad = [], torch.autograd.grad

        def recording(*args, **kwargs):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            result = grad(*args, **kwargs)
            torch.cuda.synchronize()
            calls.append({"allocated_at_start_gb": gb(before),
                          "peak_above_start_gb": gb(torch.cuda.max_memory_allocated() - before)})
            return result

        torch.autograd.grad = recording
        try:
            trainer.train_step(x)
        finally:
            torch.autograd.grad = grad
        out["grad_calls"] = dict(zip(GRAD_CALLS, calls))
    except torch.OutOfMemoryError as e:
        out.update(out_of_memory=True, message=str(e)[:400])
        return out
    out["out_of_memory"] = False
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.getcwd(), help="the tree whose package is imported")
    p.add_argument("--cases", default="f32:8:0,f32:8:1,f32:30:1,bf16:30:1,f32:30:0,bf16:30:0")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--case", default=None, help="run one case in this process")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    if args.case:
        # run as a script, sys.path[0] is this file's directory, whose logging.py
        # would shadow the standard library's
        sys.path[0] = root
        os.chdir(root)
        print(json.dumps(run_case(args.case, args.steps)), flush=True)
        return 0
    for case in args.cases.split(","):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root,
                               "--steps", str(args.steps), "--case", case],
                              capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            print(json.dumps({"case": case, "returncode": proc.returncode,
                              "stderr": proc.stderr[-2000:]}), flush=True)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
