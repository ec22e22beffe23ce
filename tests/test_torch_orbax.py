"""Reading the JAX loop's Orbax checkpoints through the converter
(`python -m dynamicvectorquantization_torch.tools.orbax_to_pt`): a tiny JAX
stage-2 fit (`configs/smoke/dqtransformer-uncond-tiny.yml`, dropout 0,
cached codes) writes Orbax in `tmp_path` after one epoch of two steps and
resumes for a second epoch; the port's loop resumes from the converted
checkpoint (its first stage the JAX run's, carried by
`utils.weights.dqvae_state_dict_from_flax`), and its second epoch logs the
JAX resumed epoch's losses, learning rates and validation within the
loop's 1e-4 relative (`tests/test_torch_loop.py`). The converted file holds
the JAX state's masters, moments, count and epoch; `load_model_and_variables`
refuses the Orbax directory itself, naming the converter, and loads the
converted run. The converter reads the checkpoints without Orbax, into the
tree Orbax's own restore gives. A JAX `Stage1State` written by Orbax's
manager converts into a stage-1 checkpoint the port's `Stage1Trainer`
loads whole.

JAX and Orbax are imported inside the fixture and the tests.
"""
import json
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.tools import orbax_to_pt
from dynamicvectorquantization_torch.train.loop import Trainer
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables
from dynamicvectorquantization_torch.utils.weights import (dqvae_state_dict_from_flax,
                                                           stackgpt_state_dict_from_flax)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")
SEED, STEPS = 23, 2
RTOL = 1e-4


def _rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(the JAX run's logdir, its rows, the first stage as a torch file, the
    JAX state at step 2 as the port's names)."""
    import jax

    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload
    from dynamicvectorquantization_tpu.parallel.mesh import make_mesh
    from dynamicvectorquantization_tpu.train.loop import Trainer as JTrainer
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    cfg = jload([TINY])
    logdir = str(tmp_path_factory.mktemp("jax"))
    state2 = None
    for epochs, resume in ((1, False), (2, True)):
        model, data = jinst(cfg["model"]), jinst(cfg["data"])
        model.learning_rate = cfg["model"]["learning_rate"]
        model.min_learning_rate = cfg["model"]["min_learning_rate"]
        trainer = JTrainer(logdir, max_epochs=epochs, seed=SEED, log_every=1, save_top_k=2,
                           mesh=make_mesh(1), max_steps_per_epoch=STEPS, resume=resume,
                           steps_per_dispatch=1, cached_codes="on")
        trainer.images.should_log = lambda *a, **k: False
        with trainer.mesh:
            trainer.fit(model, data)
        if state2 is None:
            state2 = orbax_to_pt.restore_tree(os.path.join(logdir, "checkpoints"))
    fs_vars = jax.device_get(model.first_stage_model.init(jax.random.PRNGKey(SEED + 5)))
    fs_path = str(tmp_path_factory.mktemp("fs") / "first_stage.pt")
    torch.save(dqvae_state_dict_from_flax(fs_vars), fs_path)
    return logdir, _rows(logdir), fs_path, state2


def test_port_resumes_the_converted_jax_checkpoint(jax_run, tmp_path):
    logdir, jrows, fs_path, state2 = jax_run
    run = str(tmp_path / "port")
    path = orbax_to_pt.main([os.path.join(logdir, "checkpoints", str(STEPS)), "--out", run,
                             "--first_stage", fs_path, "--seed", str(SEED)])
    assert path.endswith(f"step_{STEPS}.pt")
    state = torch.load(path, weights_only=True)
    assert state["stage"] == 2 and state["trainer"]["count"] == STEPS
    assert state["trainer"]["epoch"] == 1 and state["trainer"]["seed"] == SEED + 1
    want = stackgpt_state_dict_from_flax(state2["params"])
    assert set(state["trainer"]["masters"]) == set(want) == set(state["trainer"]["m"])
    for k, t in want.items():
        assert torch.equal(state["trainer"]["masters"][k], t), k
    assert any(float(m.abs().max()) > 0 for m in state["trainer"]["v"].values())

    cfg = load_config([TINY])
    model, data = instantiate_from_config(cfg["model"]), instantiate_from_config(cfg["data"])
    model.learning_rate = cfg["model"]["learning_rate"]
    model.min_learning_rate = cfg["model"]["min_learning_rate"]
    trainer = Trainer(run, max_epochs=2, seed=SEED, log_every=1, image_log_frequency=0,
                      save_top_k=2, device="cpu", max_steps_per_epoch=STEPS, resume=True,
                      cached_codes="on", steps_per_dispatch=1, init_weights=False)
    step_obj = trainer.fit(model, data)
    assert step_obj.count == 2 * STEPS and step_obj.epoch == 2
    got = _rows(run)
    resumed = [r for r in jrows if r["step"] > STEPS]
    assert [(r["step"], r["split"]) for r in got] == [(r["step"], r["split"]) for r in resumed] \
        == [(3, "train"), (4, "train"), (4, "val")]
    compared = 0
    for a, b in zip(got, resumed):
        for k in (k for k in b if k.endswith("_loss") or k == "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=1e-9,
                                       err_msg=f"{a['step']} {k}")
            compared += 1
    assert compared >= 15


def _assert_trees_equal(got, want, path=""):
    """`got` (numpy leaves, lists) holds `want` (Orbax's restore: jax or numpy
    arrays, Python scalars, lists) leaf for leaf: dtype, shape and values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_trees_equal(a, b, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("step", [STEPS, 2 * STEPS])
def test_reader_equals_orbax_restore(jax_run, step):
    """The converter reads the JAX loop's checkpoints without Orbax (its
    `_METADATA` and the OCDBT store through `tensorstore`) into the tree that
    Orbax's own `StandardCheckpointer` restores."""
    import orbax.checkpoint as ocp

    path = os.path.join(jax_run[0], "checkpoints", str(step))
    want = ocp.StandardCheckpointer().restore(orbax_to_pt.step_directory(path))
    got = orbax_to_pt.restore_tree(path)
    _assert_trees_equal(got, want)
    assert int(got["step"]) == step


def test_model_loading_refuses_orbax_and_reads_the_converted_run(jax_run, tmp_path):
    logdir, _, fs_path, _ = jax_run
    with pytest.raises(ValueError, match="orbax_to_pt"):
        load_model_and_variables(TINY, os.path.join(logdir, "checkpoints"), device="cpu")
    run = str(tmp_path / "port")
    orbax_to_pt.main([os.path.join(logdir, "checkpoints"), "--out", run, "--first_stage",
                      fs_path])
    model, sd = load_model_and_variables(TINY, run, device="cpu")
    fs = torch.load(fs_path, weights_only=True)
    assert torch.equal(sd["first_stage_model.quant_conv.weight"], fs["quant_conv.weight"])
    assert int(torch.load(os.path.join(run, "checkpoints", "step_4.pt"),
                          weights_only=True)["trainer"]["count"]) == 4  # the newest step


def test_stage1_state_converts_and_loads_into_the_port_trainer(tmp_path):
    """A JAX `Stage1State` at the tiny stage-1 config, written by Orbax's
    checkpoint manager as the JAX loop writes it (`<root>/<step>/default`),
    converts into a port stage-1 checkpoint that the port's trainer loads
    whole: parameters, EMA codebook, discriminator statistics, both Adam
    states, step and epoch."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload
    from dynamicvectorquantization_tpu.train.stage1 import Stage1Trainer as JStage1
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
    from dynamicvectorquantization_torch.utils.weights import stage1_state_from_flax

    tiny1 = os.path.join(_REPO, "configs/smoke/dqvae-dual-entropy-tiny.yml")
    cfg = jload([tiny1])
    model = jinst(cfg["model"])
    x0 = np.random.default_rng(0).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    state = JStage1(model, learning_rate=1e-4, warmup_steps=0, max_steps=4).init_state(
        jax.random.PRNGKey(SEED), jnp.asarray(x0))
    state = state._replace(step=jnp.int32(3), epoch=jnp.int32(1))
    root = str(tmp_path / "checkpoints")
    mngr = ocp.CheckpointManager(root, options=ocp.CheckpointManagerOptions(create=True))
    mngr.save(3, args=ocp.args.StandardSave(state))
    mngr.wait_until_finished()

    _assert_trees_equal(orbax_to_pt.restore_tree(root), ocp.StandardCheckpointer().restore(
        orbax_to_pt.step_directory(root)))
    path = orbax_to_pt.main([root, "--out", str(tmp_path / "port")])
    got = torch.load(path, weights_only=True)
    assert got["stage"] == 1 and got["trainer"]["step"] == 3 and got["trainer"]["epoch"] == 1
    port = instantiate_from_config(load_config([tiny1])["model"])
    trainer = Stage1Trainer(port, 1e-4, device="cpu")
    trainer.load_state_dict(got["trainer"])  # every key, strictly
    want = stage1_state_from_flax(jax.device_get(state))["state_dict"]
    for k, t in want.items():
        assert torch.equal(port.state_dict()[k], t), k
    assert any(k.endswith("codebook.embed_ema") for k in want)
    assert any(k.endswith("running_var") for k in want)
    assert trainer.step == 3 and trainer.ae_opt.count == int(state.ae_opt[0].count)
