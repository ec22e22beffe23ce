"""The port's data layer (`dynamicvectorquantization_torch/data/`, the data
targets of `config/registry.py`) against the JAX package's: the same
datasets for an index, the same batches (order and contents) from
`PrefetchLoader` for seeds and epochs, the same transforms on images made in
the test, all exactly (both are numpy + PIL); and the port's own logging
helpers (PNG writer, metric rows). JAX-package modules are imported inside
the tests.
"""
import io
import json
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.registry import resolve_target
from dynamicvectorquantization_torch.data import transforms as T
from dynamicvectorquantization_torch.data.datasets import (
    DataModuleFromConfig,
    FileListDataset,
    ImageNetTrain,
    ImageNetValidation,
    SyntheticDataset,
)
from dynamicvectorquantization_torch.data.pipeline import PrefetchLoader, device_prefetch, to_device
from dynamicvectorquantization_torch.data.synthetic import SyntheticImages
from dynamicvectorquantization_torch.utils.logging import (
    ImageLogger,
    MetricLogger,
    draw_grain_map_color,
    encode_png,
    make_grid,
    to_uint8,
)

PKG = "dynamicvectorquantization_torch"


class _Jittered:
    """A dataset whose examples use the loader's per-example generator."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return {"image": np.full((2, 2, 3), i, np.float32) + rng.uniform(size=(2, 2, 3)),
                "class_label": np.int32(i), "name": f"item-{i}"}


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            if isinstance(x[k], list):
                assert x[k] == y[k]
            else:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])


def test_synthetic_dataset_equals_the_jax_packages():
    from dynamicvectorquantization_tpu.data.datasets import SyntheticDataset as JDataset

    ours, theirs = SyntheticDataset(size=16, length=9), JDataset(size=16, length=9)
    assert len(ours) == len(theirs) == 9
    for i in (0, 3, 8):
        a, b = ours[i], theirs[i]
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["class_label"] == b["class_label"] and a["image"].dtype == np.float32
    cfg = SyntheticDataset(config={"size": 8, "length": 5})
    assert (cfg.size, len(cfg)) == (8, 5)


def test_synthetic_images_equal_the_jax_packages():
    from dynamicvectorquantization_tpu.data.synthetic import SyntheticImages as JImages

    ours, theirs = SyntheticImages(n=4, size=32, seed=3), JImages(n=4, size=32, seed=3)
    for i in range(4):
        np.testing.assert_array_equal(ours[i]["image"], theirs[i]["image"])
    img = ours[1]["image"]
    assert img.shape == (32, 32, 3) and img.min() >= -1 and img.max() <= 1
    assert not np.array_equal(ours[0]["image"], ours[1]["image"])


@pytest.mark.parametrize("seed,epoch", [(0, 0), (23, 0), (23, 3)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_prefetch_loader_batches_equal_the_jax_packages(seed, epoch, shuffle):
    from dynamicvectorquantization_tpu.data.pipeline import PrefetchLoader as JLoader

    ds = _Jittered(23)
    kw = dict(batch_size=4, shuffle=shuffle, num_workers=3, seed=seed)
    ours, theirs = PrefetchLoader(ds, **kw), JLoader(ds, **kw)
    assert len(ours) == len(theirs) == 5
    got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
    _assert_batches_equal(got, want)
    assert got[0]["name"][0].startswith("item-")
    if shuffle and epoch:
        first = list(ours.epoch(0))
        assert not np.array_equal(first[0]["class_label"], got[0]["class_label"])


def test_prefetch_loader_keeps_the_ragged_tail_and_stops_early():
    from dynamicvectorquantization_tpu.data.pipeline import PrefetchLoader as JLoader

    ds = _Jittered(10)
    kw = dict(batch_size=4, drop_last=False, seed=1)
    ours = PrefetchLoader(ds, **kw)
    assert len(ours) == 3
    _assert_batches_equal(list(ours), list(JLoader(ds, **kw)))
    it = ours.epoch(0)
    next(it)
    it.close()  # a consumer that leaves early: the producer thread ends


def test_prefetch_loader_hands_a_dataset_failure_to_the_consumer():
    class Broken(_Jittered):
        def __getitem__(self, i, rng=None):
            raise OSError("unreadable")

    with pytest.raises(OSError, match="unreadable"):
        list(PrefetchLoader(Broken(8), batch_size=4))


def _pil(seed, w, h):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    return Image.fromarray(arr)


@pytest.mark.parametrize("w,h", [(90, 60), (50, 77), (64, 64), (40, 30)])
def test_imagenet_transforms_equal_the_jax_packages(w, h):
    """The port's transforms take (array, mode) and give what the JAX
    package's give on the PIL image, bit for bit; the FFHQ ones too."""
    from dynamicvectorquantization_tpu.data import transforms as JT

    img = _pil(w * h, w, h)
    ours = (np.asarray(img), "RGB")
    for seed in range(4):
        for name in ("imagenet_train_transform", "ffhq_train_transform"):
            a = getattr(T, name)(ours, 48, np.random.default_rng(seed))
            b = getattr(JT, name)(img, 48, np.random.default_rng(seed))
            np.testing.assert_array_equal(a, b)
    for name in ("imagenet_val_transform", "ffhq_val_transform"):
        a, b = getattr(T, name)(ours, 48), getattr(JT, name)(img, 48)
        np.testing.assert_array_equal(a, b)
    assert a.shape == (48, 48, 3) and a.dtype == np.float32 and -1 <= a.min() <= a.max() <= 1
    flips = {T.imagenet_train_transform(ours, 48, np.random.default_rng(s)).tobytes()
             for s in range(8)}
    assert len(flips) > 1


def test_imagenet_datasets_read_a_directory_tree(tmp_path):
    from dynamicvectorquantization_tpu.data.datasets import ImageNetTrain as JTrain

    for split in ("train", "val"):
        for si, syn in enumerate(("n01", "n02")):
            d = tmp_path / split / syn
            d.mkdir(parents=True)
            for j in range(2):
                _pil(10 * si + j, 40 + j, 36).save(d / f"img_{j}.png")
    (tmp_path / "synset_human.txt").write_text("n01 tench\nn02 goldfish\n")
    train = ImageNetTrain(config={"size": 32}, root=str(tmp_path))
    val = ImageNetValidation(config={"size": 32}, root=str(tmp_path))
    assert len(train) == len(val) == 4 and isinstance(train, FileListDataset)
    ex = val.__getitem__(3)
    assert ex["image"].shape == (32, 32, 3) and ex["class_label"] == 1
    assert ex["human_label"] == "goldfish"
    theirs = JTrain(config={"size": 32}, root=str(tmp_path))
    a = train.__getitem__(2, rng=np.random.default_rng(5))
    b = theirs.__getitem__(2, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(a["image"], b["image"])
    assert a["class_label"] == b["class_label"]


def _image_tree(root, fixtures):
    """ImageNet layout (train / val, two synsets) of the committed fixtures,
    and a face tree (train / val) of JPEGs and PNGs made in the test."""
    import shutil

    from PIL import Image

    names = sorted(n for n in os.listdir(fixtures) if not n.endswith((".py", ".json")))
    for split in ("train", "val"):
        for i, name in enumerate(names):
            d = root / "imagenet" / split / ("n01" if i % 2 else "n02")
            d.mkdir(parents=True, exist_ok=True)
            shutil.copy(os.path.join(fixtures, name), d / f"{split}_{name}")
    r = np.random.default_rng(3)
    for face in ("ffhq", "celebahq"):
        for split in ("train", "val"):
            d = root / face / split
            d.mkdir(parents=True)
            for j in range(3):
                arr = r.integers(0, 256, size=(72 + 8 * j, 72 + 8 * j, 3), dtype=np.uint8)
                ext = ".png" if j % 2 else ".jpg"
                Image.fromarray(arr).save(d / f"{face}_{j}{ext}", quality=90)


def test_datasets_over_image_files_equal_the_jax_packages(tmp_path, monkeypatch):
    """ImageNet (the JPEG fixtures: DCT-domain downscale, CMYK, a PNG named
    .JPEG, grey, progressive), FFHQ, CelebA-HQ and FacesHQ folders: every
    example equals the JAX dataset's for the same index and generator, bit
    for bit, and so do `PrefetchLoader`'s batches; also with PIL blocked."""
    import sys

    from dynamicvectorquantization_tpu.data import datasets as J

    from dynamicvectorquantization_torch.data import datasets as D

    _image_tree(tmp_path, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "fixtures", "images"))
    monkeypatch.setenv("DQVQ_IMAGENET_ROOT", str(tmp_path / "imagenet"))
    monkeypatch.setenv("DQVQ_FFHQ_ROOT", str(tmp_path / "ffhq"))
    monkeypatch.setenv("DQVQ_CELEBAHQ_ROOT", str(tmp_path / "celebahq"))
    pairs = []
    for name, kw in (("ImageNetTrain", {"config": {"size": 64}}),
                     ("ImageNetValidation", {"config": {"size": 64}}),
                     ("FFHQTrain", {"size": 48}), ("FFHQValidation", {"size": 48}),
                     ("CelebAHQTrain", {"size": 48}), ("CelebAHQValidation", {"size": 48}),
                     ("FacesHQTrain", {"size": 48}), ("FacesHQValidation", {"size": 48})):
        ours, theirs = getattr(D, name)(**kw), getattr(J, name)(**kw)
        assert len(ours) == len(theirs) > 0, name
        pairs.append((name, ours, theirs))
    want = {}
    for name, ours, theirs in pairs:
        for i in range(len(ours)):
            b = theirs.__getitem__(i, rng=np.random.default_rng(i))
            want[name, i] = b
            a = ours.__getitem__(i, rng=np.random.default_rng(i))
            assert sorted(a) == sorted(b), name
            np.testing.assert_array_equal(a["image"], b["image"], err_msg=f"{name}[{i}]")
            assert a.get("class_label") == b.get("class_label")
        loaders = [PrefetchLoader(ds, batch_size=2, shuffle=True, num_workers=3, seed=4)
                   for ds in (ours, theirs)]
        _assert_batches_equal(list(loaders[0].epoch(1)), list(loaders[1].epoch(1)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    for name, ours, _ in pairs:
        for i in range(len(ours)):
            np.testing.assert_array_equal(ours.__getitem__(i, rng=np.random.default_rng(i))[
                "image"], want[name, i]["image"], err_msg=f"{name}[{i}] without PIL")


def test_ffhq_lmdb_decodes_stored_images_as_the_jax_package(monkeypatch):
    """`lmdb` is optional: its absence raises the JAX package's message, and a
    stand-in module with the calls the dataset makes shows the stored bytes
    decoded by content at full size, then the FFHQ transforms."""
    import sys
    import types

    from PIL import Image

    from dynamicvectorquantization_tpu.data.ffhq_lmdb import FFHQ_LMDB as JLMDB

    from dynamicvectorquantization_torch.data.ffhq_lmdb import FFHQ_LMDB

    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError, match="lmdb"):
        FFHQ_LMDB("/nowhere")
    r = np.random.default_rng(6)
    store = {}
    for j, fmt in enumerate(("PNG", "JPEG", "PNG")):
        buf = io.BytesIO()
        Image.fromarray(r.integers(0, 256, size=(60, 52, 3), dtype=np.uint8)).save(buf, fmt)
        store[f"{j:05d}".encode()] = buf.getvalue()

    class Txn:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def cursor(self):
            return iter(sorted(store.items()))

        def get(self, key):
            return store[key]

    env = types.SimpleNamespace(begin=lambda write=False: Txn())
    monkeypatch.setitem(sys.modules, "lmdb", types.SimpleNamespace(open=lambda *a, **k: env))
    for train in (True, False):
        ours, theirs = FFHQ_LMDB("db", size=32, train_transform=train), \
            JLMDB("db", size=32, train_transform=train)
        assert len(ours) == len(theirs) == 3
        for i in range(3):
            a = ours.__getitem__(i, rng=np.random.default_rng(i))
            b = theirs.__getitem__(i, rng=np.random.default_rng(i))
            np.testing.assert_array_equal(a["image"], b["image"])
            assert a["class_label"] == b["class_label"] == 0


def test_data_targets_resolve_by_their_tail():
    other = "dynamicvectorquantization_tpu"
    assert resolve_target(f"{other}.data.datasets.SyntheticDataset") == \
        f"{PKG}.data.datasets.SyntheticDataset"
    assert resolve_target("anything.data.synthetic.SyntheticImages") == \
        f"{PKG}.data.synthetic.SyntheticImages"
    assert resolve_target("data.build.DataModuleFromConfig") == \
        f"{PKG}.data.datasets.DataModuleFromConfig"
    assert resolve_target("data.imagenet.ImageNetTrain") == f"{PKG}.data.datasets.ImageNetTrain"
    assert resolve_target("data.imagenet.ImageNetValidation").endswith("ImageNetValidation")
    for name in ("FFHQTrain", "FFHQValidation", "CelebAHQTrain", "CelebAHQValidation",
                 "FacesHQTrain", "FacesHQValidation"):
        assert resolve_target(f"data.faceshq.{name}") == f"{PKG}.data.datasets.{name}"
        assert resolve_target(f"{other}.data.datasets.{name}") == f"{PKG}.data.datasets.{name}"
    assert resolve_target("data.ffhq_lmdb.FFHQ_LMDB") == f"{PKG}.data.ffhq_lmdb.FFHQ_LMDB"
    assert resolve_target(f"{other}.data.ffhq_lmdb.FFHQ_LMDB") == \
        f"{PKG}.data.ffhq_lmdb.FFHQ_LMDB"
    for bad in ("modules.text_encoders.t5_text_encoder.T5TextEncoder",
                f"{other}.data.datasets.CocoCaptions",
                f"{other}.nn.stackgpt.StackGPT"):
        with pytest.raises(KeyError, match="ROADMAP.md") as err:
            resolve_target(bad)
        assert "Slices to port" in str(err.value)
    # the heading the error names stands in ROADMAP.md
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "ROADMAP.md")) as f:
        assert "Slices to port" in f.read()


def test_data_module_from_the_smoke_config_yields_the_jax_packages_batches():
    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs/smoke/dqtransformer-uncond-tiny.yml")
    ours = instantiate_from_config(load_config([path])["data"])
    theirs = jinst(jload([path])["data"])
    assert isinstance(ours, DataModuleFromConfig) and ours.batch_size == 8
    for make in ("train_dataloader", "val_dataloader"):
        a, b = getattr(ours, make)(seed=23), getattr(theirs, make)(seed=23)
        assert len(a) == len(b)
        _assert_batches_equal(list(a.epoch(1))[:2], list(b.epoch(1))[:2])


def test_device_prefetch_keeps_order_and_makes_tensors():
    batches = [{"image": np.full((2, 3), i, np.float32), "name": [f"n{i}"] * 2} for i in range(5)]
    timings = {}
    out = list(device_prefetch(iter(batches), "cpu", depth=2, timings=timings))
    assert [int(b["image"][0, 0]) for b in out] == list(range(5))
    assert all(isinstance(b["image"], torch.Tensor) and b["name"] == [f"n{i}"] * 2
               for i, b in enumerate(out))
    assert timings["transfer"] >= 0
    assert list(device_prefetch(iter([]), "cpu")) == []
    assert to_device({"z": np.arange(3, dtype=np.int16)}, "cpu")["z"].dtype == torch.int16


def test_png_writer_round_trips_through_pil(tmp_path):
    from PIL import Image

    r = np.random.default_rng(0)
    for shape in ((37, 53, 3), (8, 8, 1), (5, 9)):
        a = r.integers(0, 256, size=shape, dtype=np.uint8)
        back = np.asarray(Image.open(io.BytesIO(encode_png(a))))
        np.testing.assert_array_equal(back, a.reshape(back.shape))
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 2), np.uint8))
    logger = ImageLogger(str(tmp_path), batch_frequency=3)
    assert [logger.should_log(i) for i in range(4)] == [True, False, False, True]
    assert not ImageLogger(str(tmp_path), batch_frequency=0).should_log(0)
    imgs = r.uniform(-1, 1, size=(5, 6, 6, 3)).astype(np.float32)
    logger.log({"inputs": imgs}, "train", 7, 1, 2)
    path = tmp_path / "images" / "train" / "inputs_Step_7_e-1_b-2.png"
    np.testing.assert_array_equal(np.asarray(Image.open(path)), make_grid(to_uint8(imgs[:4])))


def test_grids_and_grain_maps_equal_the_jax_packages():
    from dynamicvectorquantization_tpu.utils import logging as jlog
    from dynamicvectorquantization_tpu.utils import viz

    r = np.random.default_rng(1)
    imgs = r.uniform(-1.2, 1.2, size=(6, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(make_grid(to_uint8(imgs)), jlog.make_grid(jlog.to_uint8(imgs)))
    grains = r.integers(0, 2, size=(6, 2, 2))
    np.testing.assert_array_equal(draw_grain_map_color(imgs, grains),
                                  viz.draw_grain_map_color(imgs, grains))
    ent = r.uniform(size=(6, 2, 2)).astype(np.float32)
    np.testing.assert_array_equal(draw_grain_map_color(imgs, ent),
                                  viz.draw_grain_map_color(imgs, ent))


def test_metric_logger_rows_have_the_jax_packages_keys(tmp_path):
    from dynamicvectorquantization_tpu.utils.logging import MetricLogger as JLogger

    ours, theirs = MetricLogger(str(tmp_path / "a")), JLogger(str(tmp_path / "b"))
    for lg in (ours, theirs):
        lg.log(3, {"train_loss": 1.5, "lr": 1e-3}, "train")
        lg.log(4, {"val_loss": torch.tensor(2.0)}, "val")
    rows = [[json.loads(line) for line in open(tmp_path / d / "metrics.jsonl")] for d in "ab"]
    for a, b in zip(*rows):
        assert list(a) == list(b)
        assert {k: v for k, v in a.items() if k != "time"} == \
            {k: v for k, v in b.items() if k != "time"}
    assert open(tmp_path / "a" / "metrics.csv").readline() == \
        open(tmp_path / "b" / "metrics.csv").readline()
    # the other sinks: tensorboard event files under tb/, wandb skipped where absent
    for sink in ("tensorboard", "all"):
        MetricLogger(str(tmp_path / sink), logtype=sink).log(1, {"x": 1.0})
        assert os.listdir(tmp_path / sink / "tb")
