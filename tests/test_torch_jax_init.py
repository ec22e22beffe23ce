"""The exporter of the JAX campaign runs' initial stage-1 state
(`tests/fixtures/stage1/jax_campaign_init.py`) and the step-0 run it writes
(`tools/stage1_causes.py` `write_initial_run`), at the tiny smoke config:
the run resumes through the port's CLI into a trainer whose model holds the
JAX init's tensors exactly, with zero moments at step 0; the carry file's
tensors go into a run whose other tensors are the port's seeded init."""
import importlib.util
import os

import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY1 = "configs/smoke/dqvae-dual-entropy-tiny.yml"
SEED = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fixture():
    path = os.path.join(_REPO, "tests/fixtures/stage1/jax_campaign_init.py")
    spec = importlib.util.spec_from_file_location("jax_campaign_init", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_exported_step0_run_resumes_into_the_jax_init(tmp_path):
    from dynamicvectorquantization_torch.tools.stage1_causes import write_initial_run
    from dynamicvectorquantization_torch.train import cli

    mod = _fixture()
    run, carry = str(tmp_path / "run"), str(tmp_path / "carry.pt")
    converted = mod.export(run, base=TINY1, seed=SEED, overrides=(), carry=carry)
    trainer = cli.main(["--resume", run, "--device", "cpu", "-t", "false", "--max_epochs", "1",
                        "--seed", str(SEED)])
    assert trainer.step == 0 and trainer.epoch == 0
    own = trainer.model.state_dict()
    jax_sd = converted["state_dict"]
    assert set(jax_sd) <= set(own)
    assert all(k.startswith("loss.perceptual_loss.scaling_layer.") for k in set(own) - set(jax_sd))
    for k, v in jax_sd.items():
        assert torch.equal(own[k].cpu(), torch.as_tensor(v)), k
    for opt in (trainer.ae_opt, trainer.disc_opt):
        assert opt.count == 0
        assert all(float(t.abs().max()) == 0.0 for t in (*opt.m.values(), *opt.v.values()))
    # a fresh run's trainer generator (seed + 1) at step 0: no state was carried
    fresh = torch.Generator().manual_seed(SEED + 1)
    assert torch.equal(trainer.generator.get_state(), fresh.get_state())

    # the carry file: the towers stay the port's seeded draw, the rest is JAX's
    carried = torch.load(carry, weights_only=True)
    assert carried and not any(k.startswith(mod.TOWERS) for k in carried)
    assert any(k.startswith("loss.discriminator.") for k in carried)
    assert any(k.startswith("quantize.") for k in carried)
    base = os.path.join(_REPO, TINY1)
    plain, grafted = str(tmp_path / "plain"), str(tmp_path / "grafted")
    write_initial_run(plain, [base], [], SEED, None, device="cpu")
    write_initial_run(grafted, [base], [], SEED, carried, device="cpu")
    a = torch.load(os.path.join(plain, "checkpoints/step_0.pt"), weights_only=True)
    b = torch.load(os.path.join(grafted, "checkpoints/step_0.pt"), weights_only=True)
    a, b = a["trainer"]["model"], b["trainer"]["model"]
    for k in b:
        want = carried[k] if k in carried else a[k]
        assert torch.equal(b[k], want), k
    assert any(not torch.equal(a[k], carried[k]) for k in carried)
