"""Sampling to one PNG per image (counterpart of
`scripts/sample_images/sample_dynamic_uncond.py`):

    python -m dynamicvectorquantization_torch.sample.images \\
        --yaml_path <yml> --model_path <checkpoint> --save_path samples \\
        --batch_size 50 --sample_num 5000 [--kv_cache_dtype int8] [--device cpu]

Writes `<save_path>/{n:06d}.png` for n < `--sample_num` through
`utils/logging.py` `encode_png` (no PIL). The flags, the loading, the
sampling and its randomness are those of `sample/val.py` (see there; unlike
the JAX script, `--kv_cache_dtype` is honoured). Prints one JSON line to
stdout at the end: the images, the batches and the seconds of each batch.
"""
from __future__ import annotations

import json
import os
import sys

from ..utils.logging import encode_png
from .val import get_parser, load, sample_batches


def main(argv=None):
    opt = get_parser().parse_args(argv)
    model = load(opt)
    os.makedirs(opt.save_path, exist_ok=True)
    seconds, total = [], 0
    for batch in sample_batches(model, opt, seconds):
        for image in batch[: opt.sample_num - total]:
            with open(os.path.join(opt.save_path, f"{total:06d}.png"), "wb") as f:
                f.write(encode_png(image))
            total += 1
    print(json.dumps({"images": total, "batches": len(seconds), "batch_seconds": seconds}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
