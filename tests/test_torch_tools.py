"""The port's tools, metric sinks and launcher shims against the JAX
package's, on the CPU:

  * `tools.calculate_entropy_thresholds` writes the JAX script's JSON (file
    name, the 99 percentiles) on synthetic images and on a folder of JPEG
    files, with both bin conventions, within #3's tolerance (atol 1e-5: a
    sorted list moves no more than its entries);
  * `tools.prepare_imagenet` makes the JAX script's tree, filelists and
    markers from small archives made in the test, and `--check` reports
    alike;
  * `tools.visualize_dual_grain` writes the JAX script's overlay (the same
    pixels; PNG written without PIL) from ImageNet-layout JPEGs through one
    tiny-config checkpoint both load;
  * the tensorboard sink writes the JAX sink's tags, steps and values; wandb
    is skipped with its message where absent;
  * `utils.logger.SetupCallback` and the `pytorch_lightning.*` targets
    resolve and instantiate.

The JAX scripts run in-process with `sys.argv` patched; JAX, PIL and the
JAX package are imported inside the tests.
"""
import importlib.util
import io
import json
import os
import shutil
import sys
import tarfile
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.registry import resolve_target
from dynamicvectorquantization_torch.tools import (
    calculate_entropy_thresholds,
    prepare_imagenet,
    visualize_dual_grain,
)
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.logging import LightningShim, MetricLogger, SetupCallback

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(_REPO, "tests", "fixtures", "images")
DQVAE_TINY = os.path.join(_REPO, "configs/smoke/dqvae-dual-entropy-tiny.yml")
PKG = "dynamicvectorquantization_torch"
ENTROPY_ATOL = 1e-5  # #3's tolerance (tests/test_torch_entropy.py)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name):
    """A JAX-package script of `scripts/tools/` as a module."""
    path = os.path.join(_REPO, "scripts", "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(name, argv):
    """stdout and exit code of a JAX script's `main()` under `argv`."""
    buf, code = io.StringIO(), 0
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "argv", [name, *argv])
    try:
        with redirect_stdout(buf):
            _script(name).main()
    except SystemExit as e:
        code = e.code or 0
    finally:
        mp.undo()
    return buf.getvalue(), code


def _run_port(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        code = main(argv)
    return buf.getvalue(), code


def _imagenet_tree(root, split="train"):
    """The committed fixtures in ImageNet layout (two synsets)."""
    names = sorted(n for n in os.listdir(FIXTURES) if not n.endswith((".py", ".json")))
    for i, name in enumerate(names):
        d = os.path.join(root, split, "n01" if i % 2 else "n02")
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(FIXTURES, name), os.path.join(d, name))
    return len(names)


# ------------------------------------------------------ entropy thresholds
@pytest.mark.parametrize("dataset", ["synthetic", "imagenet"])
def test_entropy_thresholds_equal_the_jax_tools(dataset, tmp_path, monkeypatch):
    root = str(tmp_path / "imagenet")
    _imagenet_tree(root)
    monkeypatch.setenv("DQVQ_IMAGENET_ROOT", root)
    common = ["--dataset", dataset, "--patch_size", "16", "--image_size", "32" if dataset ==
              "synthetic" else "64", "--batch_size", "4", "--max_batches", "2"]
    for legacy in ([], ["--legacy_bins"]):
        theirs_dir, ours_dir = str(tmp_path / "jax"), str(tmp_path / "port")
        _run_script("calculate_entropy_thresholds", [*common, *legacy, "--out_dir", theirs_dir])
        out, code = _run_port(calculate_entropy_thresholds.main,
                              [*common, *legacy, "--out_dir", ours_dir, "--device", "cpu"])
        summary = json.loads(out.strip().splitlines()[-1])
        assert code == 0 and summary["batches"] == 2 and summary["images"] == 8
        (name,) = os.listdir(theirs_dir)
        assert os.listdir(ours_dir) == [name] == [
            f"entropy_thresholds_{dataset}_train_patch-16.json"]
        with open(os.path.join(theirs_dir, name)) as f:
            theirs = json.load(f)
        with open(os.path.join(ours_dir, name)) as f:
            ours = json.load(f)
        assert list(ours) == list(theirs) == [str(i) for i in range(1, 100)]
        np.testing.assert_allclose([ours[k] for k in ours], [theirs[k] for k in ours],
                                   atol=ENTROPY_ATOL, rtol=0)
        assert ours["99"] > ours["1"]
        shutil.rmtree(theirs_dir)
        shutil.rmtree(ours_dir)


# ----------------------------------------------------------- prepare_imagenet
def _archives(root, rng):
    """ILSVRC-style archives: a train tar of per-synset tars, a flat val tar,
    the val synset map and the human labels."""
    os.makedirs(root)

    def jpeg_bytes():
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, size=(12, 10, 3), dtype=np.uint8)).save(
            buf, format="JPEG")
        return buf.getvalue()

    def add(tar, name, data):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))

    synsets = ("n01440764", "n01443537", "n01484850")
    with tarfile.open(os.path.join(root, prepare_imagenet.TRAIN_TAR), "w") as outer:
        for syn in synsets:
            buf = io.BytesIO()
            with tarfile.open(fileobj=buf, mode="w") as inner:
                for j in range(2):
                    add(inner, f"{syn}_{j}.JPEG", jpeg_bytes())
            add(outer, f"{syn}.tar", buf.getvalue())
    mapping = {f"ILSVRC2012_val_{i:08d}.JPEG": synsets[i % 3] for i in range(1, 6)}
    with tarfile.open(os.path.join(root, prepare_imagenet.VAL_TAR), "w") as tar:
        for name in mapping:
            add(tar, name, jpeg_bytes())
    with open(os.path.join(root, prepare_imagenet.VAL_SYNSET), "w") as f:
        f.writelines(f"{k} {v}\n" for k, v in mapping.items())
    with open(os.path.join(root, prepare_imagenet.HUMAN_MAP), "w") as f:
        f.writelines(f"{s} label {s}\n" for s in synsets[:2])  # one synset uncovered


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_prepare_imagenet_makes_the_jax_scripts_tree(tmp_path):
    _archives(str(tmp_path / "a" / "root"), np.random.default_rng(0))
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    a, b = str(tmp_path / "a" / "root"), str(tmp_path / "b" / "root")
    theirs, _ = _run_script("prepare_imagenet", ["--root", a])
    ours, code = _run_port(prepare_imagenet.main, ["--root", b])
    assert code == 0 and ours.replace(b, a) == theirs
    tree = _tree(b)
    assert tree == _tree(a)
    assert tree["train_filelist.txt"].decode().splitlines() == [
        "n01440764/n01440764_0.JPEG 0", "n01440764/n01440764_1.JPEG 0",
        "n01443537/n01443537_0.JPEG 1", "n01443537/n01443537_1.JPEG 1",
        "n01484850/n01484850_0.JPEG 2", "n01484850/n01484850_1.JPEG 2"]
    assert {".ready_train", ".ready_val", "val_filelist.txt"} <= set(tree)
    # a second run is a no-op; --check reports the same, and fails on the uncovered synset
    assert _run_port(prepare_imagenet.main, ["--root", b])[0] == \
        _run_script("prepare_imagenet", ["--root", a])[0] == \
        "train already prepared (marker present)\nval already prepared (marker present)\n"
    theirs, their_code = _run_script("prepare_imagenet", ["--root", a, "--check"])
    ours, code = _run_port(prepare_imagenet.main, ["--root", b, "--check"])
    assert (ours, code) == (theirs, their_code) and code == 1 and "lack human labels" in ours


# ------------------------------------------------------------ visualize
def test_visualize_dual_grain_writes_the_jax_scripts_overlay(tmp_path, monkeypatch):
    import jax
    from PIL import Image

    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import export_dqvae_state_dict

    cfg = jload([DQVAE_TINY], [])["model"]
    cfg["params"]["lossconfig"] = None
    jvars = jax.device_get(jax.jit(jinst(cfg).init)(jax.random.PRNGKey(0)))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_dqvae_state_dict(jvars).items()}
    ckpt = str(tmp_path / "tiny.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    root = str(tmp_path / "imagenet")
    _imagenet_tree(root, "val")
    monkeypatch.setenv("DQVQ_IMAGENET_ROOT", root)
    common = ["--yaml_path", DQVAE_TINY, "--model_path", ckpt, "--num_images", "8",
              "--dataset", "imagenet"]
    _run_script("visualize_dual_grain", [*common, "--save_path", str(tmp_path / "jax")])
    out, code = _run_port(visualize_dual_grain.main,
                          [*common, "--save_path", str(tmp_path / "port"), "--device", "cpu"])
    assert code == 0 and json.loads(out.strip().splitlines()[-1])["images"] == 8
    theirs = np.asarray(Image.open(tmp_path / "jax" / "grain_overlay.png"))
    ours = np.asarray(Image.open(tmp_path / "port" / "grain_overlay.png"))
    assert ours.shape == theirs.shape == (2 * 66 - 2, 4 * 66 - 2, 3)
    np.testing.assert_array_equal(ours, theirs)
    # both grains occur over these images, so the overlay shows the router at work
    assert len(np.unique(ours.reshape(-1, 3), axis=0)) > 100


# --------------------------------------------------------- sinks and shims
def _scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(logdir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_tensorboard_sink_writes_the_jax_sinks_tags_and_values(tmp_path, monkeypatch, capsys):
    from dynamicvectorquantization_tpu.utils.logging import MetricLogger as JLogger

    loggers = [MetricLogger(str(tmp_path / "a"), logtype="tensorboard"),
               JLogger(str(tmp_path / "b"), logtype="tensorboard")]
    for lg in loggers:
        lg.log(3, {"train_loss": 1.5, "lr": 1e-3}, "train")
        lg.log(4, {"train_loss": torch.tensor(1.25)}, "train")
        lg.log(4, {"val_rec_loss": 2.0}, "val")
        lg.close()
    ours, theirs = _scalars(str(tmp_path / "a" / "tb")), _scalars(str(tmp_path / "b" / "tb"))
    assert ours == theirs
    assert ours["train/train_loss"] == [(3, 1.5), (4, 1.25)] and set(ours) == {
        "train/train_loss", "train/lr", "val/val_rec_loss"}
    monkeypatch.setitem(sys.modules, "wandb", None)
    capsys.readouterr()
    MetricLogger(str(tmp_path / "c"), logtype="wandb").log(1, {"x": 1.0})
    JLogger(str(tmp_path / "d"), logtype="wandb")
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["wandb not installed; skipping wandb sink"] * 2


def test_launcher_shims_resolve_and_instantiate():
    targets = {"utils.logger.SetupCallback": SetupCallback,
               **{f"pytorch_lightning.{n}": LightningShim for n in (
                   "callbacks.ModelCheckpoint", "callbacks.LearningRateMonitor",
                   "callbacks.RichModelSummary", "loggers.TensorBoardLogger",
                   "loggers.WandbLogger")}}
    for target, cls in targets.items():
        assert resolve_target(target) == f"{PKG}.utils.logging.{cls.__name__}"
        obj = instantiate_from_config({"target": target, "params": {"save_dir": "logs",
                                                                     "every_n_epochs": 1}})
        assert isinstance(obj, cls) and obj.kwargs["every_n_epochs"] == 1
