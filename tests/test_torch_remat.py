"""`remat` in the port's stage-1 trainer, on the CPU at the 32^2 config of
`tests/test_torch_stage1_train.py`.

A step with `remat` (the towers' blocks checkpointed, `nn/blocks.py`
`segment`) must equal the step without it bit for bit: the same ops run on
the same inputs, and the recompute runs nothing that updates a buffer or
draws from a generator. Held over one step at `accum` 1 and 2, in f32 and
with bf16 towers, with and without ResnetBlock dropout 0.1: logs, every
parameter and buffer (EMA codebook, BatchNorm statistics), both optimizers'
moments and the generator's state. The quantizer runs as often with `remat`
as without it (its search, its EMA update and its restart draw are outside
every segment) while the ResnetBlocks run more often (the recompute). A run
resumed under `remat` equals the uninterrupted one. The port's `remat` step
against the JAX `Stage1Trainer(remat=True)` is in
`tests/test_torch_stage1_train.py` (`test_remat_step_matches_jax`), beside
the JAX state it starts from.

The helpers shared with other port tests are imported inside the tests.
"""
import copy
import os

import pytest
import torch

from dynamicvectorquantization_torch.models.dqvae import DualGrainVQModel
from dynamicvectorquantization_torch.nn.blocks import ResnetBlock
from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer, resolve_remat


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LR = 1e-3
TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs/smoke/dqvae-dual-entropy-tiny.yml")


def _model(dropout=0.0, compute_dtype=None):
    from tests.test_torch_stage1_train import _config

    cfg = _config()
    for tower in ("encoderconfig", "decoderconfig"):
        cfg[tower]["params"]["dropout"] = dropout
    return DualGrainVQModel(**cfg, compute_dtype=compute_dtype)


def _trainer(remat, dropout=0.0, accum=1, compute_dtype=None):
    trainer = Stage1Trainer(_model(dropout, compute_dtype), LR, warmup_steps=0, max_steps=100,
                            device="cpu", remat=remat, accum=accum)
    return trainer.init_state(torch.Generator().manual_seed(0))


def _batch(seed, accum):
    from tests.test_torch_stage1_train import _images

    return _images(seed, *((accum,) if accum > 1 else ()), b=2)


class _Calls:
    """Counts calls of the quantizer's forward, EMA update and restart draw
    and of every ResnetBlock's forward."""

    def __init__(self, model):
        self.n = dict(quantize=0, ema_update=0, restart_draw=0, resnet_block=0)
        q = model.quantize
        for name, obj, attr in (("quantize", q, "forward"), ("ema_update", q, "_ema_update"),
                                ("restart_draw", q, "_draw_restart")):
            setattr(obj, attr, self._counting(name, getattr(obj, attr)))
        for m in model.modules():
            if isinstance(m, ResnetBlock):
                m.register_forward_pre_hook(lambda *_: self._add("resnet_block"))

    def _add(self, name):
        self.n[name] += 1

    def _counting(self, name, fn):
        def wrapped(*args, **kwargs):
            self._add(name)
            return fn(*args, **kwargs)
        return wrapped


def _differences(a, b):
    """Names of what differs between two (logs, state_dict, generator state)."""
    (la, sa, ga), (lb, sb, gb) = a, b
    out = [k for k in la if not torch.equal(la[k], lb[k])]
    out += [f"model.{k}" for k in sa["model"] if not torch.equal(sa["model"][k], sb["model"][k])]
    for opt in ("ae_opt", "disc_opt"):
        out += [f"{opt}.{part}.{k}" for part in ("m", "v") for k in sa[opt][part]
                if not torch.equal(sa[opt][part][k], sb[opt][part][k])]
        out += [f"{opt}.count"] * (sa[opt]["count"] != sb[opt]["count"])
    out += ["generator"] * (not torch.equal(ga, gb))
    out += ["step"] * (sa["step"] != sb["step"])
    return out


@pytest.mark.parametrize("accum,compute_dtype,dropout", [
    (1, None, 0.0), (2, None, 0.0), (1, "bfloat16", 0.0), (2, "bfloat16", 0.1), (1, None, 0.1)],
    ids=["f32", "f32-accum2", "bf16", "bf16-accum2-dropout", "f32-dropout"])
def test_remat_step_equals_the_step_without_it(accum, compute_dtype, dropout):
    x = _batch(1, accum)
    runs, calls = [], []
    for remat in (False, True):
        trainer = _trainer(remat, dropout, accum, compute_dtype)
        assert trainer.remat is remat
        calls.append(_Calls(trainer.model))
        g = torch.Generator().manual_seed(3)
        logs = trainer.train_step(x, g)
        runs.append((logs, copy.deepcopy(trainer.state_dict()), g.get_state()))
    assert _differences(*runs) == []
    plain, remat = calls[0].n, calls[1].n
    # the quantizer: two searches a microbatch (the AE pass and the discriminator
    # pass's fresh forward), one EMA update and one restart draw, with remat as without
    assert plain["quantize"] == remat["quantize"] == 2 * accum
    assert plain["ema_update"] == remat["ema_update"] == plain["restart_draw"] == \
        remat["restart_draw"] == accum
    # the recompute ran every ResnetBlock of the AE pass once more
    blocks = sum(isinstance(m, ResnetBlock) for m in _model().modules())
    assert plain["resnet_block"] == 2 * accum * blocks
    assert remat["resnet_block"] == 3 * accum * blocks
    if dropout:  # the masks reach the step: another loss than without dropout
        base = _trainer(False, 0.0, accum, compute_dtype).train_step(
            x, torch.Generator().manual_seed(3))
        assert float(base["train_aeloss"]) != float(runs[1][0]["train_aeloss"])


def test_resume_under_remat_is_bit_equal():
    """Two steps from the trainer's own generator, against one step, a
    state_dict round trip into a fresh trainer and the second step."""
    xs = [_batch(2, 1), _batch(3, 1)]
    whole = _trainer(True, 0.1)
    for x in xs:
        logs = whole.train_step(x)
    a = (logs, copy.deepcopy(whole.state_dict()), whole.generator.get_state())
    first = _trainer(True, 0.1)
    first.train_step(xs[0])
    saved = copy.deepcopy(first.state_dict())
    resumed = Stage1Trainer(_model(0.1), LR, warmup_steps=0, max_steps=100, device="cpu",
                            remat=True)
    resumed.load_state_dict(saved)
    logs = resumed.train_step(xs[1])
    b = (logs, copy.deepcopy(resumed.state_dict()), resumed.generator.get_state())
    assert _differences(a, b) == []


def test_remat_resolves_from_the_device():
    assert resolve_remat(None, torch.device("cpu")) is False
    assert resolve_remat(None, torch.device("cuda")) is True
    assert resolve_remat(False, torch.device("cuda")) is False
    assert resolve_remat(True, torch.device("cpu")) is True
    model = _model()
    assert Stage1Trainer(model, LR, device="cpu").remat is False
    assert Stage1Trainer(model, LR, device="cpu", remat=True).remat is True


@pytest.mark.cuda
def test_trainer_on_the_card_takes_remat_by_default():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    model = instantiate_from_config(load_config([TINY])["model"])
    assert Stage1Trainer(model, LR).remat is True

