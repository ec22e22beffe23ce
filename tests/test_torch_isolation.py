"""The PyTorch port stands alone: importing every module of
`dynamicvectorquantization_torch` (and `chip_smoke.py`) loads neither JAX,
flax, PyYAML, orbax, PIL, scipy, torchvision nor the JAX package (PIL is
imported only when an image file is opened); entry points refuse to drift to the CPU;
`chip_smoke.py` fails without a card and outside the repository. Modules
imported only inside functions load none of the JAX stack either: the Orbax
converter reads without JAX, and the `transformers` text encoders load
neither TensorFlow nor Flax."""
import json
import os
import runpy
import shutil
import subprocess
import sys

import pytest
import torch

from dynamicvectorquantization_torch.utils.device import resolve_device
from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import dynamicvectorquantization_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "yaml", "orbax", "PIL", "scipy",
                                    "torchvision", "dynamicvectorquantization_tpu"))
print(len(names), bad)
"""


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_nothing_of_jax():
    proc = _run(["-c", _IMPORT_ALL], cwd=_REPO)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.split(" ", 1)
    assert int(n) >= 55 and bad.strip() == "[]", proc.stdout


def test_port_names_no_path_of_the_jax_package():
    """No string in the port's code (docstrings aside) names the JAX package,
    so no data file is read from it: the entropy thresholds resolve to the
    port's own copies."""
    import ast

    from dynamicvectorquantization_torch.nn import routers

    pkg = os.path.join(_REPO, "dynamicvectorquantization_torch")
    found = []
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read())
            docs = {id(node.body[0].value) for node in ast.walk(tree)
                    if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                    and node.body and isinstance(node.body[0], ast.Expr)}
            found += [f"{path}:{node.lineno}" for node in ast.walk(tree)
                      if isinstance(node, ast.Constant) and isinstance(node.value, str)
                      and id(node) not in docs and "dynamicvectorquantization_tpu" in node.value]
    assert found == []
    path = routers.threshold_path("configs/missing/entropy_thresholds_imagenet_train_patch-16.json")
    assert os.path.commonpath([path, pkg]) == pkg and os.path.exists(path)


_JAX_STACK = ("jax", "jaxlib", "flax", "orbax", "tensorflow", "dynamicvectorquantization_tpu")
_LOADED = f"""
loaded = sorted({{m.split(".")[0] for m in sys.modules}} & set({_JAX_STACK!r}))
print(json.dumps(loaded))
"""


def test_orbax_converter_reads_without_jax(tmp_path):
    """What the converter imports when it reads (`restore_tree`, below
    `tools.orbax_to_pt.main`) loads nothing of the JAX stack: an Orbax
    checkpoint written here is read in a fresh process."""
    import typing

    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    class State(typing.NamedTuple):
        step: jnp.ndarray
        params: dict
        opt: tuple

    params = {"dense": {"kernel": jnp.ones((2, 3))}, "blocks": [jnp.arange(4.0)]}
    root = str(tmp_path / "checkpoints")
    mngr = ocp.CheckpointManager(root, options=ocp.CheckpointManagerOptions(create=True))
    mngr.save(7, args=ocp.args.StandardSave(State(jnp.int32(7), params, (params, None))))
    mngr.wait_until_finished()
    script = ("import json, sys\n"
              "from dynamicvectorquantization_torch.tools import orbax_to_pt\n"
              "tree = orbax_to_pt.restore_tree(sys.argv[1])\n"
              "print(int(tree['step']), float(tree['opt'][0]['blocks'][0].sum()), tree['opt'][1])"
              + _LOADED)
    proc = _run(["-c", script, root], cwd=_REPO)
    assert proc.returncode == 0, proc.stderr
    read, loaded = proc.stdout.strip().splitlines()
    assert read == "7 6.0 None" and json.loads(loaded) == [], proc.stdout


def test_hf_text_encoders_load_no_jax(tmp_path):
    """`CLIPTextEncoder` / `BERTTextEncoder` import `transformers` in their
    constructors; that loads neither TensorFlow nor Flax, nor JAX with them."""
    pytest.importorskip("transformers")
    write = runpy.run_path(os.path.join(_REPO, "tests/fixtures/tiny_hf.py"))["write_tiny_hf_models"]
    clip_dir, bert_dir = write(tmp_path)
    script = ("import json, sys\n"
              "from dynamicvectorquantization_torch.nn import text_encoders as enc\n"
              "for cls, path in ((enc.CLIPTextEncoder, sys.argv[1]),"
              " (enc.BERTTextEncoder, sys.argv[2])):\n"
              "    cls(path).encode_text(['a red cat'], device='cpu')\n" + _LOADED)
    env = {k: v for k, v in os.environ.items() if k not in ("USE_TF", "USE_FLAX")}
    proc = _run(["-c", script, clip_dir, bert_dir], cwd=_REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [], proc.stdout


def test_entry_points_need_cuda_or_an_explicit_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        load_model_and_variables(TINY)
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_card_and_outside_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run(["chip_smoke.py"], cwd=_REPO, env=env)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], cwd=str(tmp_path), env=env)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
