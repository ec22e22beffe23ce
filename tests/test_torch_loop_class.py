"""The slice as a whole for a class-conditional model: the port's training
loop (`train/loop.py` `Trainer.fit`) against the JAX package's on the tiny
class yml of tests/test_torch_class_cond.py (written here), synthetic data
with ten classes, f32 on the CPU, from ONE initial state (the JAX loop's
`model.init` trees carried to the port). Two epochs of two steps with
cached codes, the labels cached beside the streams: every logged train and
val loss within atol 1e-5, rows at the same steps. Then the port alone:
the same run without cached codes (labels through the uncached path and the
image grids) equal to the cached one bit for bit, accumulated microbatches
with their labels, and a resumed run (all dropouts 0.1) equal to the
uninterrupted one bit for bit.

JAX is imported inside the fixtures; one JAX fit is shared.
"""
import json
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import dump_yaml, load_config
from dynamicvectorquantization_torch.train.loop import Trainer
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.weights import dualformer_state_dict_from_flax
from tests.test_torch_class_cond import TINY, class_config


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SEED, EPOCHS, STEPS = 23, 2, 2
DROPOUTS = {k: 0.1 for k in ("attn_pdrop", "resid_pdrop", "embd_pdrop")}


def _rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def class_yml(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "dqtransformer-class-tiny.yml"
    path.write_text(dump_yaml(class_config(load_config([TINY]))))
    return str(path)


@pytest.fixture(scope="module")
def jax_fit(class_yml, tmp_path_factory):
    """The JAX loop's metric rows with cached codes, and the initial state it
    started from as a port state_dict."""
    import jax

    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload
    from dynamicvectorquantization_tpu.parallel.mesh import make_mesh
    from dynamicvectorquantization_tpu.train.loop import Trainer as JTrainer
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    cfg = jload([class_yml])
    model, data = jinst(cfg["model"]), jinst(cfg["data"])
    assert model.cond_stage_key == "class_label"
    model.learning_rate = cfg["model"]["learning_rate"]
    model.min_learning_rate = cfg["model"]["min_learning_rate"]
    logdir = str(tmp_path_factory.mktemp("jax"))
    trainer = JTrainer(logdir, max_epochs=EPOCHS, seed=SEED, log_every=1, save_top_k=1,
                       mesh=make_mesh(1), max_steps_per_epoch=STEPS, resume=False,
                       steps_per_dispatch=1, cached_codes="on")
    trainer.images.should_log = lambda *a, **k: False  # no sampling: losses only
    with trainer.mesh:
        trainer.fit(model, data)
    fs_vars = model.first_stage_model.init(jax.random.PRNGKey(SEED + 5))
    variables = jax.device_get(model.init(jax.random.PRNGKey(SEED), fs_vars))
    return _rows(logdir), dualformer_state_dict_from_flax(variables)


def _port_fit(class_yml, logdir, state_dict, dropouts=False, **kw):
    cfg = load_config([class_yml])
    if dropouts:
        cfg["model"]["params"]["transformer_config"]["params"].update(DROPOUTS)
    model, data = instantiate_from_config(cfg["model"]), instantiate_from_config(cfg["data"])
    model.load_state_dict(state_dict)
    model.learning_rate = cfg["model"]["learning_rate"]
    model.min_learning_rate = cfg["model"]["min_learning_rate"]
    opts = dict(max_epochs=EPOCHS, seed=SEED, log_every=1, image_log_frequency=0, save_top_k=1,
                device="cpu", max_steps_per_epoch=STEPS, resume=False, cached_codes="on",
                init_weights=False, steps_per_dispatch=1)
    opts.update(kw)
    return Trainer(str(logdir), **opts).fit(model, data), _rows(logdir)


def _losses(rows):
    return [(r["step"], r["split"], r["train_loss" if r["split"] == "train" else "val_loss"])
            for r in rows]


def test_class_loop_logs_the_jax_loops_losses(class_yml, jax_fit, tmp_path):
    want, state_dict = jax_fit
    step_obj, got = _port_fit(class_yml, tmp_path, state_dict)
    steps = [(i, "train") for i in (1, 2)] + [(2, "val")] + \
        [(i, "train") for i in (3, 4)] + [(4, "val")]
    assert [(r["step"], r["split"]) for r in got] == [(r["step"], r["split"]) for r in want] \
        == steps
    compared = 0
    for a, b in zip(got, want):
        names = [k for k in b if k.endswith("_loss")]
        assert set(names) <= set(a) and names
        for k in names:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0, err_msg=f"{a['step']} {k}")
            compared += 1
        if "lr" in b:
            np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
    assert compared >= 5 * len(steps)
    assert "cache_encode_seconds" in got[0]
    assert step_obj.count == EPOCHS * STEPS and step_obj.epoch == EPOCHS


def test_uncached_class_run_equals_the_cached_one(class_yml, jax_fit, tmp_path):
    """Labels through the uncached path (`(x, labels)` per step) give the
    cached run's losses to the bit; the image grids sample from the labels
    of the logged batch."""
    _, state_dict = jax_fit
    _, cached = _port_fit(class_yml, tmp_path / "on", state_dict)
    _, inline = _port_fit(class_yml, tmp_path / "off", state_dict, cached_codes="off",
                          image_log_frequency=STEPS)
    assert _losses(inline) == _losses(cached)
    grids = sorted(os.listdir(tmp_path / "off" / "images" / "train"))
    assert len(grids) == 4 * EPOCHS and any(g.startswith("samples_from_scratch") for g in grids)
    step_obj, rows = _port_fit(class_yml, tmp_path / "accum", state_dict, cached_codes="auto",
                               accumulate_grad_batches=2)
    assert step_obj.accum == 2 and step_obj.count == EPOCHS * STEPS
    assert all(np.isfinite(loss) for _, _, loss in _losses(rows))


def test_resumed_class_run_equals_the_uninterrupted_one(class_yml, jax_fit, tmp_path):
    _, state_dict = jax_fit
    whole, whole_rows = _port_fit(class_yml, tmp_path / "whole", state_dict, dropouts=True,
                                  image_log_frequency=STEPS)
    first, _ = _port_fit(class_yml, tmp_path / "part", state_dict, dropouts=True,
                         image_log_frequency=STEPS, stop_epoch=1)
    assert first.epoch == 1 and first.count == STEPS
    resumed, rows = _port_fit(class_yml, tmp_path / "part", state_dict, dropouts=True,
                              image_log_frequency=STEPS, resume=True)
    assert resumed.epoch == EPOCHS and resumed.count == EPOCHS * STEPS
    for name in whole.masters:
        assert torch.equal(whole.masters[name], resumed.masters[name]), name
        assert torch.equal(whole.v[name], resumed.v[name]), name
    assert _losses(rows) == _losses(whole_rows)
    state = torch.load(tmp_path / "part" / "checkpoints" / f"step_{EPOCHS * STEPS}.pt",
                       weights_only=True)
    assert sorted(state) == ["first_stage", "stage", "trainer"]  # nothing new in checkpoints
