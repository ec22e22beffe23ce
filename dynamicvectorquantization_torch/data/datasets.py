"""Datasets and the data module (counterpart of
`dynamicvectorquantization_tpu/data/datasets.py`).

Configs instantiate a `DataModuleFromConfig` holding train / validation
dataset configs; each dataset's `__getitem__(i, rng)` returns
`{"image": (H, W, 3) float32 in [-1, 1], "class_label": int, ...}`. Batches
are NHWC numpy arrays assembled by `data/pipeline.py`.

Ported: `FileListDataset`, ImageNet train / validation, `SyntheticDataset`
(random images, equal to the JAX package's for an index) and the procedural
`data.synthetic.SyntheticImages`. Files are opened with PIL, imported only
when a file is opened; the native JPEG decoder, FFHQ / CelebA-HQ / FacesHQ
and the LMDB reader are not ported (ROADMAP.md).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils.instantiate import instantiate_from_config
from . import paths as default_paths
from . import transforms as T


class FileListDataset:
    """Image files + labels with a per-item transform."""

    def __init__(self, files, labels=None, transform=None, size=256, human_labels=None):
        self.files = list(files)
        self.labels = labels
        self.human_labels = human_labels
        self.transform = transform
        self.size = size

    def __len__(self):
        return len(self.files)

    def _open(self, path):
        from PIL import Image

        return Image.open(path)

    def __getitem__(self, i, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        with self._open(self.files[i]) as img:
            image = self.transform(img, self.size, rng)
        ex = {"image": image}
        if self.labels is not None:
            ex["class_label"] = np.int32(self.labels[i])
        if self.human_labels is not None:
            ex["human_label"] = self.human_labels[i]
        return ex


def _imagenet_split(root, split, size, train: bool):
    """Standard ImageNet layout: <root>/<split>/<synset>/*.JPEG. Supports a
    filelist at <root>/<split>_filelist.txt ("relpath synset_index") and an
    optional synset -> human label table at <root>/synset_human.txt."""
    split_dir = os.path.join(root, split)
    filelist = os.path.join(root, f"{split}_filelist.txt")
    files, labels = [], []
    if os.path.exists(filelist):
        with open(filelist) as f:
            for line in f:
                rel, _, lab = line.strip().partition(" ")
                files.append(os.path.join(split_dir, rel))
                labels.append(int(lab or 0))
    elif os.path.isdir(split_dir):
        synsets = sorted(
            d for d in os.listdir(split_dir) if os.path.isdir(os.path.join(split_dir, d)))
        for idx, syn in enumerate(synsets):
            for fn in sorted(os.listdir(os.path.join(split_dir, syn))):
                files.append(os.path.join(split_dir, syn, fn))
                labels.append(idx)
    transform = T.imagenet_train_transform if train else T.imagenet_val_transform
    human_labels = None
    human_path = os.path.join(root, "synset_human.txt")
    if files and os.path.exists(human_path):
        table = {}
        with open(human_path) as f:
            for line in f:
                parts = line.strip().split(maxsplit=1)
                if parts:
                    table[parts[0]] = parts[1] if len(parts) > 1 else ""
        synsets = [os.path.basename(os.path.dirname(p)) for p in files]
        human_labels = [table.get(s, s) for s in synsets]
    return FileListDataset(files, labels, transform, size, human_labels=human_labels)


class _ImageNetSplit(FileListDataset):
    split, train = None, None

    def __init__(self, config=None, root=None, **kwargs):
        size = int(dict(config or {}).get("size", 256))
        ds = _imagenet_split(root or default_paths.imagenet_root(), self.split, size, self.train)
        super().__init__(ds.files, ds.labels, ds.transform, size, human_labels=ds.human_labels)


class ImageNetTrain(_ImageNetSplit):
    split, train = "train", True


class ImageNetValidation(_ImageNetSplit):
    split, train = "val", False


class SyntheticDataset:
    """Deterministic random images: tests and benchmarks without data on disk."""

    def __init__(self, config=None, size=256, length=256, num_classes=1000, **kwargs):
        if config:
            size = int(config.get("size", size))
            length = int(config.get("length", length))
        self.size = int(size)
        self.length = int(length)
        self.num_classes = num_classes

    def __len__(self):
        return self.length

    def __getitem__(self, i, rng=None):
        g = np.random.default_rng(i)
        return {
            "image": g.uniform(-1, 1, (self.size, self.size, 3)).astype(np.float32),
            "class_label": np.int32(i % self.num_classes),
        }


class DataModuleFromConfig:
    """Builds the datasets from their configs and hands out prefetching
    loaders."""

    def __init__(self, batch_size, train=None, validation=None, test=None, num_workers=None,
                 **kwargs):
        self.batch_size = batch_size
        self.num_workers = num_workers or 2
        self.dataset_configs = {k: cfg for k, cfg in (("train", train), ("validation", validation),
                                                      ("test", test)) if cfg is not None}
        self.datasets = {k: instantiate_from_config(cfg)
                         for k, cfg in self.dataset_configs.items()}

    def _loader(self, split, shuffle, seed=0):
        from .pipeline import PrefetchLoader

        return PrefetchLoader(self.datasets[split], batch_size=self.batch_size, shuffle=shuffle,
                              num_workers=self.num_workers, seed=seed)

    def train_dataloader(self, seed=0):
        return self._loader("train", shuffle=True, seed=seed)

    def val_dataloader(self, seed=0):
        return self._loader("validation", shuffle=False, seed=seed)

    def test_dataloader(self, seed=0):
        return self._loader("test", shuffle=False, seed=seed)
