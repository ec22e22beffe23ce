"""Wall time of the bf16 encode on the card, for comparing two trees of the
repository in one run.

The shipped p6c18 config (random weights from seed 0, the first stage cast to
bf16 as the stage-2 trainer casts it under `compute_dtype: bfloat16`) encodes
a seeded batch of 8 images, as `chip_smoke.py`'s bf16 encode phase does; the
package is imported from `--root`, so the same script times another tree:

    python dynamicvectorquantization_torch/utils/encode_wall.py --root <tree> --reps 50

Prints one JSON line: every encode's wall time (seconds, `torch.cuda.
synchronize` after each), their median, and the CUDA events' time of the
last `--reps` encodes run back to back.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

P6C18 = "configs/stage2/uncond_imagenet_p6c18.yml"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="repository tree to import the port from")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    # run as a script, sys.path[0] is this file's directory, whose logging.py
    # would shadow the standard library's: import from the tree instead
    sys.path[0] = root
    os.chdir(root)

    import torch

    from dynamicvectorquantization_torch.train.stage2 import cast_copy
    from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables

    dev = torch.device("cuda")
    model, _ = load_model_and_variables(P6C18, seed=0, kv_cache_dtype="int8", device=dev)
    fs16 = cast_copy(model.first_stage_model)
    g = torch.Generator(device=dev).manual_seed(6)
    size = fs16.encoder.resolution
    x = torch.rand((8, size, size, 3), generator=g, device=dev) * 2 - 1
    ramp = torch.linspace(-0.5, 0.5, size, device=dev).view(1, 1, size, 1)
    x[:, :, : size // 2] = ramp[:, :, : size // 2] + 0.005 * x[:, :, : size // 2]
    with torch.inference_mode():
        for _ in range(3):
            model.encode_to_z(x, fs16)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            model.encode_to_z(x, fs16)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.reps):
            model.encode_to_z(x, fs16)
        e1.record()
        torch.cuda.synchronize()
    print(json.dumps(dict(label=args.label, root=root, reps=args.reps,
                          encode_s_median=statistics.median(times), encode_s=times,
                          back_to_back_s=e0.elapsed_time(e1) / 1e3 / args.reps,
                          device=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
