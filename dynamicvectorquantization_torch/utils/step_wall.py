"""Stage-2 optimizer-step time of the port on the card, for comparing two
trees of the repository in one run (parent, change, change, parent):

    python dynamicvectorquantization_torch/utils/step_wall.py --root <tree> --label <name> \\
        [--cases bf16:8,class:8,f32:8,bf16:30] [--windows 3] [--steps 4] [--eager 1] [--graph 1]

The package is imported from `--root`, so the same script times another
tree (one whose trainer dispatches every op from Python, or one that
replays a CUDA graph of the step). Each case `<dtype>:<batch>` trains the
shipped p6c18 StackGPT at full width and depth (`class`: the class p6c18,
seeded labels in [0, 1000), bf16) on cached codes of `batch` seeded 256^2
images encoded by the trainer, stream caps 160 / 644 as `chip_smoke.py`'s
`train` phase, every dropout as shipped: a first step (which captures the
graph in a tree that has one), `--windows` windows of `--steps` steps on the
host clock between synchronizes (ms a step: their median), one step under
torch.profiler (busy ms: the union of the device intervals; idle share of
the traced window; device ops), peak allocated and reserved memory, and,
where the tree has them, the graph's capture seconds and pool bytes. With
`--eager 1` a tree whose `train_step` takes `eager` times that control too;
`--graph 0` times the control alone (`eager_*` keys).
Prints one JSON line a case.
"""
from __future__ import annotations

import argparse
import gc
import inspect
import json
import os
import sys
import time

CONFIGS = {"bf16": "configs/stage2/uncond_imagenet_p6c18.yml",
           "f32": "configs/stage2/uncond_imagenet_p6c18.yml",
           "class": "configs/stage2/class_imagenet_p6c18.yml"}
STREAM_CAPS = {"coarse_max_len": 160, "fine_max_len": 644}


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


def traced(torch, fn):
    """(busy ms, traced window ms, device ops) of one call of `fn`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dynamicvectorquantization_torch.utils.device_time import busy_union_ms, window_ms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    intervals = [(e.start_ns() / 1e6, e.end_ns() / 1e6)
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
    return busy_union_ms(intervals), window_ms(intervals), len(intervals)


def run_case(torch, name, batch, args):
    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    dev = torch.device("cuda")
    config = load_config([CONFIGS[name]])
    config["model"]["params"]["permuter_config"]["params"].update(STREAM_CAPS)
    with torch.device(dev):
        model = instantiate_from_config(config["model"])
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    trainer = Stage2Trainer(model.eval(), config["model"]["learning_rate"], warmup_steps=0,
                            max_steps=10_000, device=dev,
                            compute_dtype=None if name == "f32" else "bfloat16")
    z = trainer.encode_dataset(images(torch, dev, batch).cpu().numpy(), batch=batch)
    c = (torch.randint(0, 1000, (batch,), generator=torch.Generator().manual_seed(15))
         if name == "class" else None)
    has_eager = "eager" in inspect.signature(trainer.train_step).parameters
    out = {"case": f"{name}:{batch}", "label": args.label, "batch": batch,
           "seq_len": z["coarse_content"].shape[1] + z["fine_content"].shape[1] + 1}
    modes = [False] * bool(args.graph or not has_eager) + [True] * bool(args.eager and has_eager)
    for eager in modes:
        kw = {"eager": True} if eager else {}

        def step():
            return trainer.train_step(z, c=c, **kw)

        key = "eager_" if eager else ""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = float(step()["train_loss"])
        out[f"{key}first_step_s"] = time.perf_counter() - t0
        per_step = []
        for _ in range(args.windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [step()["train_loss"] for _ in range(args.steps)]
            torch.cuda.synchronize()
            per_step.append((time.perf_counter() - t0) / args.steps * 1e3)
        busy, window, ops = traced(torch, step)
        ms = spread(per_step)
        out.update({f"{key}step_ms": ms["median"], f"{key}step_ms_spread": ms,
                    f"{key}device_busy_ms": busy, f"{key}device_window_ms": window,
                    f"{key}device_idle_share": 1.0 - busy / window if window else None,
                    f"{key}idle_vs_step_ms": 1.0 - busy / ms["median"], f"{key}device_ops": ops,
                    f"{key}peak_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                    f"{key}peak_reserved_gb": torch.cuda.max_memory_reserved() / 2 ** 30,
                    f"{key}losses": [first, float(losses[-1])]})
    try:
        from dynamicvectorquantization_torch.models.graphs import runners_of

        runners = list(runners_of(trainer).values())
    except ImportError:  # a tree without CUDA graphs
        runners = []
    if runners:
        out.update(captures=runners[0].captures, capture_s=runners[0].capture_s,
                   graph_pool_bytes=runners[0].pool_bytes())
    del trainer, model
    gc.collect()  # the trainer, and with it its graphs' pool, before the next case
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="repository tree to import the port from")
    ap.add_argument("--label", default="")
    ap.add_argument("--cases", default="bf16:8,class:8,f32:8,bf16:30")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--eager", type=int, default=1)
    ap.add_argument("--graph", type=int, default=1)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    # run as a script, sys.path[0] is this file's directory, whose logging.py
    # would shadow the standard library's: import from the tree instead
    sys.path[0] = root
    os.chdir(root)

    import torch

    if not torch.cuda.is_available():
        print("step_wall: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for case in args.cases.split(","):
        name, batch = case.split(":")
        print(json.dumps(run_case(torch, name, int(batch), args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
