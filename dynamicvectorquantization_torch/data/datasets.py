"""Datasets and the data module (counterpart of
`dynamicvectorquantization_tpu/data/datasets.py`).

Configs instantiate a `DataModuleFromConfig` holding train / validation
dataset configs; each dataset's `__getitem__(i, rng)` returns
`{"image": (H, W, 3) float32 in [-1, 1], "class_label": int, ...}`. Batches
are NHWC numpy arrays assembled by `data/pipeline.py`.

`FileListDataset` reads a file with `data/image_io.py` `read_image` (the JAX
package's libjpeg decode with DCT-domain downscale for `.jpg` / `.jpeg`,
PNG without PIL, the rest by content) and applies the array transforms of
`data/transforms.py`, so an example equals the JAX package's bit for bit for
the same file, index and generator, with or without PIL installed. Datasets:
ImageNet train / validation, FFHQ, CelebA-HQ, FacesHQ (their concatenation),
`SyntheticDataset` (random images, equal to the JAX package's for an index)
and the procedural `data.synthetic.SyntheticImages`; the LMDB-backed FFHQ is
`data/ffhq_lmdb.py`.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils.instantiate import instantiate_from_config
from . import paths as default_paths
from . import transforms as T
from .image_io import read_image


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
        """(array, mode); JPEGs decoded at the smallest DCT-domain scale that
        keeps the short side at least `size`."""
        return read_image(path, min_side=self.size)

    def __getitem__(self, i, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        ex = {"image": self.transform(self._open(self.files[i]), self.size, rng)}
        if self.labels is not None:
            ex["class_label"] = np.int32(self.labels[i])
        if self.human_labels is not None:
            ex["human_label"] = self.human_labels[i]
        return ex


def _list_images(root):
    exts = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".JPEG", ".JPG", ".PNG"}
    files = []
    for dirpath, _, filenames in sorted(os.walk(root)):
        for f in sorted(filenames):
            if os.path.splitext(f)[1] in exts:
                files.append(os.path.join(dirpath, f))
    return files


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


class _FaceSplit(FileListDataset):
    """`<root>/<split>/` if that directory exists, else every image under
    `<root>`; labels 0."""
    root_fn, split, transform_fn = None, None, None

    def __init__(self, size=256, root=None, **kwargs):
        root = root or type(self).root_fn()
        split_dir = os.path.join(root, self.split)
        files = _list_images(split_dir if os.path.isdir(split_dir) else root)
        super().__init__(files, [0] * len(files), type(self).transform_fn, int(size))


class FFHQTrain(_FaceSplit):
    root_fn, split, transform_fn = default_paths.ffhq_root, "train", T.ffhq_train_transform


class FFHQValidation(_FaceSplit):
    root_fn, split, transform_fn = default_paths.ffhq_root, "val", T.ffhq_val_transform


class CelebAHQTrain(_FaceSplit):
    root_fn, split, transform_fn = default_paths.celebahq_root, "train", T.ffhq_train_transform


class CelebAHQValidation(_FaceSplit):
    root_fn, split, transform_fn = default_paths.celebahq_root, "val", T.ffhq_val_transform


class _Concat:
    """Concatenation of datasets (the reference's FacesHQ = CelebA-HQ +
    FFHQ); empty datasets are left out unless all are empty."""

    def __init__(self, *datasets):
        self.datasets = [d for d in datasets if len(d) > 0] or list(datasets)
        self._offsets = []
        off = 0
        for d in self.datasets:
            self._offsets.append(off)
            off += len(d)
        self._len = off

    def __len__(self):
        return self._len

    def __getitem__(self, i, rng=None):
        for d, off in zip(reversed(self.datasets), reversed(self._offsets)):
            if i >= off:
                return d.__getitem__(i - off, rng=rng)
        raise IndexError(i)


class FacesHQTrain(_Concat):
    """CelebA-HQ + FFHQ train."""

    def __init__(self, size=256, **kwargs):
        super().__init__(CelebAHQTrain(size=size), FFHQTrain(size=size))


class FacesHQValidation(_Concat):
    def __init__(self, size=256, **kwargs):
        super().__init__(CelebAHQValidation(size=size), FFHQValidation(size=size))


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
