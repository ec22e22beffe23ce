"""Dataset root paths, each overridable by an environment variable
(counterpart of `dynamicvectorquantization_tpu/data/paths.py`)."""
from __future__ import annotations

import os


def imagenet_root() -> str:
    return os.environ.get("DQVQ_IMAGENET_ROOT", "/data/imagenet")


def ffhq_root() -> str:
    return os.environ.get("DQVQ_FFHQ_ROOT", "/data/ffhq")


def celebahq_root() -> str:
    return os.environ.get("DQVQ_CELEBAHQ_ROOT", "/data/celebahq")
