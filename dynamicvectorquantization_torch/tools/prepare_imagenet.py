"""Offline ImageNet preparation (counterpart of the JAX package's
`scripts/tools/prepare_imagenet.py`; standard library only; no download).

Given a root holding the official archives:
    <root>/ILSVRC2012_img_train.tar        (train: 1000 inner synset tars)
    <root>/ILSVRC2012_img_val.tar          (val: flat 50k JPEGs)
    <root>/validation_synset.txt           (filename -> synset map)
    <root>/synset_human.txt                (optional: synset -> human label)

it produces the layout `data/datasets.py` `_imagenet_split` reads:
    <root>/train/<synset>/*.JPEG  + <root>/train_filelist.txt
    <root>/val/<synset>/*.JPEG    + <root>/val_filelist.txt

Filelists are "relpath class_index" lines, class indices by sorted synset
order. A `.ready_<split>` marker makes a second run a no-op. `--check`
validates a prepared tree (counts, missing files, human-label coverage)
without touching it and exits 1 if it finds a fault.

    python -m dynamicvectorquantization_torch.tools.prepare_imagenet --root <dir>
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys
import tarfile

TRAIN_TAR = "ILSVRC2012_img_train.tar"
VAL_TAR = "ILSVRC2012_img_val.tar"
VAL_SYNSET = "validation_synset.txt"
HUMAN_MAP = "synset_human.txt"
EXPECTED = {"train": 1281167, "val": 50000}


def load_synset_human(path):
    """synset -> human-readable label ('n01440764<ws>tench, Tinca tinca')."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(maxsplit=1)
            out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def _require(path):
    if not os.path.exists(path):
        raise FileNotFoundError(f"missing {path}")


def _safe_extract(tar: tarfile.TarFile, dest: str):
    dest_real = os.path.realpath(dest)
    for m in tar.getmembers():
        target = os.path.realpath(os.path.join(dest, m.name))
        if not target.startswith(dest_real + os.sep) and target != dest_real:
            raise RuntimeError(f"blocked path traversal in tar member {m.name}")
    tar.extractall(path=dest, filter="data")


def _write_filelist(root, split):
    datadir = os.path.join(root, split)
    files = sorted(os.path.relpath(p, datadir)
                   for p in glob.glob(os.path.join(datadir, "*", "*.JPEG")))
    synsets = sorted({f.split(os.sep)[0] for f in files})
    index = {s: i for i, s in enumerate(synsets)}
    with open(os.path.join(root, f"{split}_filelist.txt"), "w") as f:
        for rel in files:
            f.write(f"{rel} {index[rel.split(os.sep)[0]]}\n")
    return len(files), len(synsets)


def prepare_train(root):
    marker = os.path.join(root, ".ready_train")
    if os.path.exists(marker):
        print("train already prepared (marker present)")
        return
    datadir = os.path.join(root, "train")
    if not os.path.isdir(datadir) or not os.listdir(datadir):
        path = os.path.join(root, TRAIN_TAR)
        _require(path)
        os.makedirs(datadir, exist_ok=True)
        print(f"extracting {path} -> {datadir}")
        with tarfile.open(path, "r:") as tar:
            _safe_extract(tar, datadir)
        subtars = sorted(glob.glob(os.path.join(datadir, "*.tar")))
        print(f"extracting {len(subtars)} synset sub-tars")
        for sub in subtars:
            subdir = sub[: -len(".tar")]
            os.makedirs(subdir, exist_ok=True)
            with tarfile.open(sub, "r:") as tar:
                _safe_extract(tar, subdir)
            os.remove(sub)
    n, k = _write_filelist(root, "train")
    print(f"train: {n} images across {k} synsets")
    open(marker, "w").close()


def prepare_val(root):
    marker = os.path.join(root, ".ready_val")
    if os.path.exists(marker):
        print("val already prepared (marker present)")
        return
    datadir = os.path.join(root, "val")
    flat = glob.glob(os.path.join(datadir, "*.JPEG")) if os.path.isdir(datadir) else []
    if not os.path.isdir(datadir) or (not flat and not os.listdir(datadir)):
        path = os.path.join(root, VAL_TAR)
        _require(path)
        os.makedirs(datadir, exist_ok=True)
        print(f"extracting {path} -> {datadir}")
        with tarfile.open(path, "r:") as tar:
            _safe_extract(tar, datadir)
        flat = glob.glob(os.path.join(datadir, "*.JPEG"))
    if flat:  # into synset folders
        vspath = os.path.join(root, VAL_SYNSET)
        _require(vspath)
        with open(vspath) as f:
            mapping = dict(line.split() for line in f.read().splitlines() if line)
        print(f"reorganizing {len(flat)} val images into synset folders")
        for syn in sorted(set(mapping.values())):
            os.makedirs(os.path.join(datadir, syn), exist_ok=True)
        for p in flat:
            name = os.path.basename(p)
            if name in mapping:
                shutil.move(p, os.path.join(datadir, mapping[name], name))
    n, k = _write_filelist(root, "val")
    print(f"val: {n} images across {k} synsets")
    open(marker, "w").close()


def check(root):
    ok = True
    human_path = os.path.join(root, HUMAN_MAP)
    human = load_synset_human(human_path) if os.path.exists(human_path) else None
    for split in ("train", "val"):
        fl = os.path.join(root, f"{split}_filelist.txt")
        if not os.path.exists(fl):
            print(f"[{split}] filelist missing: {fl}")
            ok = False
            continue
        with open(fl) as f:
            lines = [line.split() for line in f.read().splitlines() if line]
        n = len(lines)
        synsets = sorted({rel.split(os.sep)[0] for rel, _ in lines})
        missing = sum(not os.path.exists(os.path.join(root, split, rel))
                      for rel, _ in lines[:: max(1, n // 1000)])
        msg = f"[{split}] {n} files, {len(synsets)} synsets"
        if n != EXPECTED[split]:
            msg += f" (expected {EXPECTED[split]})"
        if missing:
            msg += f", {missing} MISSING in sample"
            ok = False
        if human is not None:
            uncovered = [s for s in synsets if s not in human]
            if uncovered:
                msg += f", {len(uncovered)} synsets lack human labels"
                ok = False
        print(msg)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=os.environ.get("DQVQ_IMAGENET_ROOT"),
                    help="ImageNet root (default: $DQVQ_IMAGENET_ROOT)")
    ap.add_argument("--split", choices=["train", "val", "all"], default="all")
    ap.add_argument("--check", action="store_true",
                    help="validate a prepared tree instead of preparing")
    args = ap.parse_args(argv)
    if not args.root:
        ap.error("--root or DQVQ_IMAGENET_ROOT required")
    if args.check:
        return 0 if check(args.root) else 1
    if args.split in ("train", "all"):
        prepare_train(args.root)
    if args.split in ("val", "all"):
        prepare_val(args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
