"""The slice as a whole, stage 2: the port's training loop
(`dynamicvectorquantization_torch/train/loop.py` `Trainer.fit`) against the
JAX package's `Trainer.fit` on `configs/smoke/dqtransformer-uncond-tiny.yml`
(every dropout 0 there), f32 on the CPU, from ONE initial state: the JAX
`model.init` trees the JAX loop draws from its seed are drawn here with the
same keys and carried to the port by `utils.weights.
dualformer_state_dict_from_flax`; the port's loop then keeps the weights it
was given (`init_weights=False`). Both read the same synthetic batches in the
same order (tests/test_torch_data.py). One epoch of 4 steps and one
validation, `steps_per_dispatch` 1, cached codes on and off: every logged
`train_loss`, `val_loss`, their parts and the learning rate within 1e-4
relative, rows at the same steps.

JAX is imported inside the fixtures; one JAX fit per mode is shared.
"""
import json
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.train.loop import Trainer
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.weights import dualformer_state_dict_from_flax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")
SEED, STEPS = 23, 4
RTOL = 1e-4


def _rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    """{"on" / "off": the metric rows of the JAX loop}, and the initial state
    it started from as a port state_dict."""
    import jax

    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload
    from dynamicvectorquantization_tpu.parallel.mesh import make_mesh
    from dynamicvectorquantization_tpu.train.loop import Trainer as JTrainer
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    cfg = jload([TINY])
    rows = {}
    for mode in ("on", "off"):
        model, data = jinst(cfg["model"]), jinst(cfg["data"])
        model.learning_rate = cfg["model"]["learning_rate"]
        model.min_learning_rate = cfg["model"]["min_learning_rate"]
        logdir = str(tmp_path_factory.mktemp(f"jax-{mode}"))
        trainer = JTrainer(logdir, max_epochs=1, seed=SEED, log_every=1, save_top_k=1,
                           mesh=make_mesh(1), max_steps_per_epoch=STEPS, resume=False,
                           steps_per_dispatch=1, cached_codes=mode)
        trainer.images.should_log = lambda *a, **k: False  # no sampling: losses only
        with trainer.mesh:
            trainer.fit(model, data)
        rows[mode] = _rows(logdir)
    # the state the JAX loop starts from (train/loop.py, `_fit_stage2`)
    fs_vars = model.first_stage_model.init(jax.random.PRNGKey(SEED + 5))
    variables = jax.device_get(model.init(jax.random.PRNGKey(SEED), fs_vars))
    return rows, dualformer_state_dict_from_flax(variables)


def _port_fit(logdir, state_dict, cached_codes, **kw):
    cfg = load_config([TINY])
    model, data = instantiate_from_config(cfg["model"]), instantiate_from_config(cfg["data"])
    model.load_state_dict(state_dict)
    model.learning_rate = cfg["model"]["learning_rate"]
    model.min_learning_rate = cfg["model"]["min_learning_rate"]
    trainer = Trainer(logdir, max_epochs=1, seed=SEED, log_every=1, image_log_frequency=0,
                      save_top_k=1, device="cpu", max_steps_per_epoch=STEPS, resume=False,
                      cached_codes=cached_codes, init_weights=False, **kw)
    return trainer.fit(model, data), _rows(logdir)


@pytest.mark.parametrize("cached_codes", ["on", "off"])
def test_port_loop_logs_the_jax_loops_losses(jax_fits, tmp_path, cached_codes):
    jrows, state_dict = jax_fits
    want = jrows[cached_codes]
    step_obj, got = _port_fit(str(tmp_path), state_dict, cached_codes)
    assert [(r["step"], r["split"]) for r in got] == [(r["step"], r["split"]) for r in want]
    assert [(r["step"], r["split"]) for r in got] == \
        [(i, "train") for i in range(1, STEPS + 1)] + [(STEPS, "val")]
    compared = 0
    for a, b in zip(got, want):
        names = [k for k in b if k.endswith("_loss") or k == "lr"]
        assert set(names) <= set(a) and ("train_loss" in names or "val_loss" in names)
        for k in names:
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=1e-9, err_msg=f"{a['step']} {k}")
            compared += 1
    assert compared >= 5 * (STEPS + 1)
    assert got[0]["train_loss"] > got[STEPS - 1]["train_loss"]
    assert step_obj.count == STEPS and step_obj.epoch == 1
    assert set(want[0]) <= set(got[0])  # the JAX loop's row keys
    assert ("cache_encode_seconds" in got[0]) == (cached_codes == "on")


def test_cached_and_inline_encoding_train_alike(jax_fits, tmp_path):
    _, state_dict = jax_fits
    _, on = _port_fit(str(tmp_path / "on"), state_dict, "on")
    _, off = _port_fit(str(tmp_path / "off"), state_dict, "off")
    for a, b in zip(on, off):
        key = "train_loss" if a["split"] == "train" else "val_loss"
        assert a[key] == b[key]  # the same streams either way, to the bit


def test_loop_writes_buckets_and_a_checkpoint(jax_fits, tmp_path):
    _, state_dict = jax_fits
    step_obj, _ = _port_fit(str(tmp_path), state_dict, "auto")
    with open(tmp_path / "loop_buckets.json") as f:
        buckets = json.load(f)
    assert buckets["global_step"] == STEPS and buckets["wall_seconds"] > 0
    assert {"encode", "dispatch", "pull", "validate", "checkpoint", "log_sync"} <= \
        set(buckets["buckets"])
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["index.json", f"step_{STEPS}.pt"]
    state = torch.load(tmp_path / "checkpoints" / f"step_{STEPS}.pt", weights_only=True)
    assert state["stage"] == 2 and state["trainer"]["count"] == STEPS
    assert state["trainer"]["epoch"] == 1 and state["trainer"]["seed"] == SEED + 1
    assert set(state["trainer"]["masters"]) == set(step_obj.masters)
    assert any(k.startswith("quantize.codebook") for k in state["first_stage"])
    with open(tmp_path / "checkpoints" / "index.json") as f:
        assert "val_loss" in json.load(f)[str(STEPS)]


def test_accumulated_batches_take_half_the_steps(jax_fits, tmp_path):
    _, state_dict = jax_fits
    step_obj, rows = _port_fit(str(tmp_path), state_dict, "auto", accumulate_grad_batches=2)
    assert step_obj.accum == 2 and step_obj.count == STEPS  # 8 loader batches, 4 steps
    assert [r["step"] for r in rows if r["split"] == "train"] == list(range(1, STEPS + 1))
    with pytest.raises(ValueError, match="cached_codes"):
        _port_fit(str(tmp_path / "x"), state_dict, "on", accumulate_grad_batches=2)
