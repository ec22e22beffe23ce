"""Dataset root paths, each overridable by an environment variable
(counterpart of `dynamicvectorquantization_tpu/data/paths.py`)."""
from __future__ import annotations

import os


def imagenet_root() -> str:
    return os.environ.get("DQVQ_IMAGENET_ROOT", "/data/imagenet")
