"""The slice as a whole, stage 1: the port's `Trainer.fit` against the JAX
package's on `configs/smoke/dqvae-dual-entropy-tiny.yml` (DQ-VAE + LPIPS +
PatchGAN at 64^2), f32 on the CPU, one epoch of 2 steps and one validation
from ONE initial state: the JAX `Stage1Trainer.init_state` the JAX loop would
draw (same key, same sample batch) is drawn here, handed to the JAX loop, and
carried to the port by `utils.weights.stage1_state_from_flax`.

The codebook restart draws a permutation the two frameworks' generators
cannot share, so both sides get the same draw, as in
tests/test_torch_stage1_train.py: `jax.random.permutation` / `uniform` are
replaced while the JAX loop runs, the port's `_draw_restart` likewise.

Every logged train and validation loss within 1e-4 relative (+ 1e-6
absolute for losses near zero).
"""
import json
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.train.loop import Trainer
from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.weights import load_stage1_state, stage1_state_from_flax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(_REPO, "configs/smoke/dqvae-dual-entropy-tiny.yml")
SEED, STEPS = 23, 2


def _rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _shared_draw(pool_rows, noise_shape):
    perm = np.random.default_rng(pool_rows).permutation(pool_rows)
    noise = (None if noise_shape is None else
             np.random.default_rng(7).uniform(size=noise_shape).astype(np.float32))
    return noise, perm


def _port_draw(pool_rows, noise_shape, generator, device):
    noise, perm = _shared_draw(pool_rows, noise_shape)
    return (None if noise is None else torch.from_numpy(noise)), torch.from_numpy(perm)


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """(the JAX loop's metric rows, the state it started from, converted)."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload
    from dynamicvectorquantization_tpu.parallel.mesh import make_mesh
    from dynamicvectorquantization_tpu.train import loop as jloop
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    cfg = jload([TINY])
    model, data = jinst(cfg["model"]), jinst(cfg["data"])
    model.learning_rate = 8 * cfg["model"]["base_learning_rate"]
    model.min_learning_rate = 0.0
    # the state the JAX loop draws (train/loop.py, `_fit_stage1`), drawn before
    # the random functions are replaced and handed to it
    x0 = next(iter(data.train_dataloader(seed=SEED).epoch(0)))["image"]
    probe = jloop.Stage1Trainer(model, learning_rate=model.learning_rate, warmup_steps=0,
                                max_steps=STEPS)
    state = probe.init_state(jax.random.PRNGKey(SEED), jnp.asarray(x0[:1]))
    converted = stage1_state_from_flax(jax.device_get(state))

    logdir = str(tmp_path_factory.mktemp("jax-stage1"))
    trainer = jloop.Trainer(logdir, max_epochs=1, seed=SEED, log_every=1, save_top_k=1,
                            mesh=make_mesh(1), max_steps_per_epoch=STEPS, resume=False,
                            steps_per_dispatch=1)
    trainer.images.should_log = lambda *a, **k: False
    mp = pytest.MonkeyPatch()
    mp.setattr(jloop.Stage1Trainer, "init_state", lambda self, *a, **k: state)
    mp.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(_shared_draw(n, None)[1]))
    mp.setattr(jax.random, "uniform",
               lambda key, shape, *a, **k: jnp.asarray(_shared_draw(1, shape)[0]))
    try:
        with trainer.mesh:
            trainer.fit(model, data)
    finally:
        mp.undo()
    return _rows(logdir), converted


def _port_fit(logdir, converted, **kw):
    cfg = load_config([TINY])
    model, data = instantiate_from_config(cfg["model"]), instantiate_from_config(cfg["data"])
    load_stage1_state(Stage1Trainer(model, 1e-3, device="cpu"), converted)
    model.quantize._draw_restart = _port_draw
    model.learning_rate = 8 * cfg["model"]["base_learning_rate"]
    trainer = Trainer(logdir, max_epochs=1, seed=SEED, log_every=1, save_top_k=1, device="cpu",
                      max_steps_per_epoch=STEPS, resume=False, init_weights=False, **kw)
    return trainer.fit(model, data), _rows(logdir)


def test_port_stage1_loop_logs_the_jax_loops_losses(jax_fit, tmp_path):
    want, converted = jax_fit
    step_obj, got = _port_fit(str(tmp_path), converted, image_log_frequency=100)
    assert [(r["step"], r["split"]) for r in got] == [(r["step"], r["split"]) for r in want] == \
        [(1, "train"), (2, "train"), (2, "val")]
    compared = 0
    for a, b in zip(got, want):
        names = [k for k in b if k.endswith("_loss") or k in (
            "train_aeloss", "lr", "val_fine_ratio", "train_fine_ratio", "train_d_weight")]
        assert set(names) <= set(a), set(names) - set(a)
        for k in names:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{a['step']} {k}")
            compared += 1
    assert compared >= 25
    assert step_obj.step == STEPS and step_obj.epoch == 1
    assert step_obj.ae_opt.count == step_obj.disc_opt.count == STEPS
    # the four grids of the first step, as the JAX loop names them
    names = sorted(os.listdir(tmp_path / "images" / "train"))
    assert names == [f"{n}_Step_1_e-0_b-0.png" for n in
                     ("entropy_map", "grain_map", "inputs", "reconstructions")]
    assert os.listdir(tmp_path / "checkpoints")


def test_stage1_checkpoint_holds_the_whole_state_and_resumes_bit_equal(jax_fit, tmp_path):
    """Two epochs in one run against one epoch, a checkpoint, and a resumed
    second epoch: the same validation rows and parameters, to the bit (the
    EMA codebook, BatchNorm statistics, both Adam states and the restart
    generator's state all come back)."""
    _, converted = jax_fit

    def run(logdir, **kw):
        cfg = load_config([TINY])
        model, data = instantiate_from_config(cfg["model"]), instantiate_from_config(cfg["data"])
        load_stage1_state(Stage1Trainer(model, 1e-3, device="cpu"), converted)
        model.learning_rate = 8e-5
        trainer = Trainer(logdir, max_epochs=2, seed=SEED, log_every=1, image_log_frequency=0,
                          save_top_k=1, device="cpu", max_steps_per_epoch=STEPS,
                          init_weights=False, **kw)
        return trainer.fit(model, data)

    whole = run(str(tmp_path / "whole"), resume=False)
    run(str(tmp_path / "parts"), resume=False, stop_epoch=1)
    state = torch.load(tmp_path / "parts" / "checkpoints" / f"step_{STEPS}.pt", weights_only=True)
    assert state["stage"] == 1 and state["trainer"]["step"] == STEPS
    assert {"model", "ae_opt", "disc_opt", "step", "epoch", "generator"} == set(state["trainer"])
    assert any("cluster_size_ema" in k for k in state["trainer"]["model"])
    assert any("running_mean" in k for k in state["trainer"]["model"])
    resumed = run(str(tmp_path / "parts"), resume=True)
    assert resumed.step == whole.step == 2 * STEPS and resumed.epoch == 2
    a, b = _rows(str(tmp_path / "whole")), _rows(str(tmp_path / "parts"))

    def strip(r):
        return {k: v for k, v in r.items() if k not in ("time", "images_per_sec")}

    assert [strip(r) for r in a] == [strip(r) for r in b]
    for (k, v), (_, w) in zip(whole.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(v, w), k
    assert torch.equal(whole.generator.get_state(), resumed.generator.get_state())
