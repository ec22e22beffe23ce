"""LMDB-backed FFHQ dataset (counterpart of
`dynamicvectorquantization_tpu/data/ffhq_lmdb.py`; reference
`data/ffhq_lmdb.py:16-77`).

Needs the optional `lmdb` package, imported when the dataset is made, and
raises the JAX package's message without it. The keys are read once when the
dataset opens. A stored value is an encoded image, decoded by its content at
full size (`data/image_io.py` `decode_image`, as the JAX package's
`Image.open(BytesIO(value))`), then the FFHQ transforms.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import transforms as T
from .image_io import decode_image


class FFHQ_LMDB:
    def __init__(self, lmdb_path: str, split: str = "train", size: int = 256,
                 train_transform: bool = True):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError(
                "FFHQ_LMDB requires the `lmdb` package, which is not in this "
                "image; use the file-based FFHQTrain/FFHQValidation datasets."
            ) from e

        self.env = lmdb.open(lmdb_path, readonly=True, lock=False, readahead=False,
                             meminit=False)
        with self.env.begin(write=False) as txn:
            self.keys = [k for k, _ in txn.cursor()]
        self.size = size
        self.transform = T.ffhq_train_transform if train_transform else T.ffhq_val_transform

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, i, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        with self.env.begin(write=False) as txn:
            data = txn.get(self.keys[i])
        img = decode_image(data, f"{self.keys[i]!r}")
        return {"image": self.transform(img, self.size, rng), "class_label": np.int32(0)}
