"""The PyTorch port stands alone: importing every module of
`dynamicvectorquantization_torch` (and `chip_smoke.py`) loads neither JAX,
flax, PyYAML, orbax, PIL nor the JAX package (PIL is imported only when an
image file is opened); entry points refuse to drift to the CPU;
`chip_smoke.py` fails without a card and outside the repository."""
import os
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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "yaml", "orbax", "PIL",
                                    "dynamicvectorquantization_tpu"))
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
