"""The DQ-VAE in its bf16 compute mode (mode (ii):
`DualGrainVQModel(compute_dtype="bfloat16")`, f32 parameters, bf16 towers)
against the JAX package's `DQVAENet(compute_dtype="bfloat16")` and its
`Stage1Trainer`, on the CPU.

Two frameworks that both compute in bf16 round in different places (XLA's
CPU sigmoid rounds three steps to bf16 where the port rounds once; the
port's attention rounds as the TPU kernel, not as JAX's CPU einsums; sums
run in other orders), and each rounding moves a value by up to 2^-9 of it.
So the tolerances are bf16's, and the training comparison is measured
against a yardstick from the JAX package itself: the port's bf16 step may
lie no farther from JAX's bf16 step than 1.5 times JAX's own f32 step does
(plus a floor).

  * forward at the tiny config (64^2, batch 2): the layers' dtypes as the
    JAX modules give them; the entropy (f32 images) within 1e-5 and the grain
    map exactly; the features the VQ searches within 10 % of their mean row
    norm (L2) and the codes equal to the f32 search of JAX's features except
    at near ties; the decoder on JAX's own latents within 3 % of the image's
    largest value; the commitment loss within 2 % (relative).
  * two `Stage1Trainer` steps from one converted state (the 32^2 config of
    `tests/test_torch_stage1_train.py`, with its shared restart draw): logs,
    both optimizers' first moments (relative L2) and the EMA codebook (at
    most 4 of 64 codes counted differently; the first step's codebook within
    the yardstick).
  * `model.params.compute_dtype=bfloat16` on the command line reaches the
    model; float16 raises.

JAX is imported inside the tests.
"""
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.models.dqvae import DualGrainVQModel
from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.weights import (
    dqvae_state_dict_from_flax,
    load_stage1_state,
    stage1_state_from_flax,
)

BF16 = torch.bfloat16
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DQVAE_TINY = os.path.join(_REPO, "configs/smoke/dqvae-dual-entropy-tiny.yml")
LR = 1e-3
YARDSTICK = 1.5  # see the module docstring


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed, b=2, size=64):
    """Left half smooth, right half noisy, so both grains occur."""
    r = np.random.default_rng(seed)
    x = r.uniform(-1, 1, size=(b, size, size, 3)).astype(np.float32)
    x[:, :, : size // 2] = (0.2 + 0.01 * x[:, :, : size // 2]).astype(np.float32)
    return x


def _bf16_config():
    cfg = load_config([DQVAE_TINY], ["model.params.compute_dtype=bfloat16"])["model"]
    cfg["params"]["lossconfig"] = None  # the GAN loss is not part of the forward
    return cfg


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables, the port's model with the same weights),
    both with compute_dtype bf16."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from tests.test_torch_stackgpt import perturbed

    cfg = _bf16_config()
    jm = jinst(cfg)
    init = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    r = np.random.default_rng(5)
    k, d = 64, 32
    codebook = (0.5 * r.normal(size=(k + 1, d))).astype(np.float32)
    codebook[k] = 0.0
    jvars = {"params": perturbed(init["params"], r, 0.05),
             "ema": {"quantize": {**init["ema"]["quantize"], "codebook": jnp.asarray(codebook)}}}
    tm = instantiate_from_config(cfg)
    tm.load_state_dict(dqvae_state_dict_from_flax(jvars))
    return jm, jvars, tm.eval()


def test_the_command_line_override_reaches_the_model_and_float16_raises():
    cfg = _bf16_config()
    assert cfg["params"]["compute_dtype"] == "bfloat16"
    model = instantiate_from_config(cfg)
    assert model.compute_dtype == BF16
    for mod in (model.encoder.conv_in, model.encoder.conv_out_coarse, model.quant_conv,
                model.post_quant_conv, model.decoder.conv_in, model.encoder.down[0].downsample,
                model.encoder.down[3].attn[0].q, model.encoder.norm_out_fine):
        assert mod.compute_dtype == BF16
    # the decoder's last norm and conv and the position tables have no dtype (f32)
    assert model.decoder.norm_out.compute_dtype is None
    assert model.decoder.conv_out.compute_dtype is None
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for bad in ("float16", torch.float16):
        with pytest.raises(NotImplementedError):
            DualGrainVQModel(**dict(cfg["params"], compute_dtype=bad))


def test_forward_dtypes_follow_the_jax_modules(pair):
    _, _, tm = pair
    seen = {}
    hooks = [tm.get_submodule(name).register_forward_hook(
        lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
        for name in ("encoder.conv_in", "encoder.mid_coarse.attn_1", "encoder.conv_out_fine",
                     "quant_conv", "post_quant_conv", "decoder.position_bias_learned",
                     "decoder.conv_in", "decoder.norm_out", "decoder.conv_out")]
    with torch.no_grad():
        quant, loss, *_ = tm.encode(torch.from_numpy(_images(1)))
        dec = tm.decode(quant)
    for h in hooks:
        h.remove()
    want = {"encoder.conv_in": BF16, "encoder.mid_coarse.attn_1": BF16,
            "encoder.conv_out_fine": BF16, "quant_conv": BF16, "post_quant_conv": BF16,
            # x + sin(...) + table: f32 positions promote the bf16 latent
            "decoder.position_bias_learned": torch.float32, "decoder.conv_in": BF16,
            "decoder.norm_out": torch.float32, "decoder.conv_out": torch.float32}
    assert seen == want
    assert quant.dtype == loss.dtype == dec.dtype == torch.float32


def test_forward_matches_jax_in_bf16(pair):
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.entropy import patch_entropy as jax_entropy

    jm, jvars, tm = pair
    x = _images(7)
    quant_r, loss_r, info_r, grain_r, _, ent_r = jm.encode(jvars, jnp.asarray(x))

    def features(m, a):
        return m.quant_conv(m.encoder(a, jax_entropy(a, 16))["h_dual"])

    h_j = np.asarray(jm.net.apply(jvars, jnp.asarray(x), method=features).astype(jnp.float32))
    feats = {}
    hook = tm.quant_conv.register_forward_hook(lambda m, i, o: feats.__setitem__("h", o))
    with torch.no_grad():
        quant, loss, info, grain, _, ent = tm.encode(torch.from_numpy(x))
        dec = tm.decode(torch.from_numpy(np.asarray(quant_r)))
    hook.remove()
    dec_r = np.asarray(jm.decode(jvars, quant_r))
    np.testing.assert_allclose(ent.numpy(), np.asarray(ent_r), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(grain.numpy(), np.asarray(grain_r))
    assert 0 < grain.float().mean() < 1  # both grains

    h_j = h_j.reshape(-1, h_j.shape[-1]).astype(np.float64)
    h_p = feats["h"].float().permute(0, 2, 3, 1).reshape(h_j.shape).numpy().astype(np.float64)
    row_diff = np.linalg.norm(h_p - h_j, axis=1)
    assert row_diff.max() <= 0.1 * np.linalg.norm(h_j, axis=1).mean()
    cb = tm.quantize.codebook.weight[:-1].double().numpy()
    scores = (cb * cb).sum(1)[None] - 2.0 * h_j @ cb.T
    ref = scores.argmin(1)
    got = info[2].numpy().reshape(-1)
    rows = np.arange(len(ref))
    allowed = 2 * row_diff * np.linalg.norm(cb[got] - cb[ref], axis=1)
    assert np.all((got == ref) | (scores[rows, got] - scores[rows, ref] <= allowed))
    assert (got == ref).mean() >= 0.95
    np.testing.assert_array_equal(np.asarray(info_r[2]).reshape(-1), ref)  # JAX's: the f32 search
    # the quantized latents are the f32 codebook rows of the codes (up to the
    # straight-through sum's f32 rounding)
    np.testing.assert_allclose(quant.numpy().reshape(-1, cb.shape[1]), cb[got], atol=1e-6,
                               rtol=0)

    assert dec.dtype == torch.float32 and dec.shape == dec_r.shape == (2, 64, 64, 3)
    assert np.abs(dec.numpy() - dec_r).max() <= 0.03 * np.abs(dec_r).max()
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=2e-2, atol=0)


# --------------------------------------------------------------- training
def _stage1_pair(dtype):
    """(JAX trainer, its initial state, the port's trainer in that state) at
    `compute_dtype` dtype, as `tests/test_torch_stage1_train.py` builds them."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.models.dqvae import DualGrainVQModel as JModel
    from dynamicvectorquantization_tpu.train.stage1 import Stage1Trainer as JTrainer
    from tests.test_torch_stage1_train import _config, _images as images32, _port_draw

    jtrainer = JTrainer(JModel(**_config(), compute_dtype=dtype), learning_rate=LR,
                        warmup_steps=0, max_steps=100, remat=False)
    state = jax.device_get(jtrainer.init_state(jax.random.PRNGKey(1),
                                               jnp.asarray(images32(0))))
    trainer = Stage1Trainer(DualGrainVQModel(**_config(), compute_dtype=dtype), LR,
                            warmup_steps=0, max_steps=100, device="cpu")
    load_stage1_state(trainer, stage1_state_from_flax(state))
    trainer.model.quantize._draw_restart = _port_draw
    return jtrainer, state, trainer


@pytest.fixture(scope="module")
def steps():
    """Two steps of the JAX trainer in bf16 and in f32 and of the port's in
    bf16, from one state: per run, per step, (the state in the port's names,
    the logs)."""
    from tests.test_torch_stage1_train import _images as images32
    from tests.test_torch_stage1_train import _jax_steps, _snapshot

    batches = [images32(1), images32(2)]
    runs = {}
    for name, dtype in (("jax_bf16", "bfloat16"), ("jax_f32", None)):
        jtrainer, state, _ = _stage1_pair(dtype)
        runs[name] = [(stage1_state_from_flax(s), logs)
                      for s, logs in _jax_steps(jtrainer, state, batches)]
    _, _, trainer = _stage1_pair("bfloat16")
    runs["port_bf16"] = []
    for x in batches:
        logs = trainer.train_step(x, torch.Generator().manual_seed(0))
        runs["port_bf16"].append((_snapshot(trainer), {k: float(v) for k, v in logs.items()}))
    runs["trainer"] = trainer
    return runs


def _moment_distance(a, b, opt):
    m, ref = a[opt][1], b[opt][1]
    num = sum(float(((m[k] - ref[k]) ** 2).sum()) for k in ref)
    return (num / sum(float((ref[k] ** 2).sum()) for k in ref)) ** 0.5


@pytest.mark.parametrize("step", range(2))
def test_two_steps_lie_within_the_bf16_yardstick(steps, step):
    port, ref, f32 = (steps[k][step] for k in ("port_bf16", "jax_bf16", "jax_f32"))
    assert sorted(port[1]) == sorted(ref[1])
    for key, want in ref[1].items():
        got, yard = port[1][key], abs(f32[1][key] - want)
        assert np.isfinite(got)
        assert abs(got - want) <= YARDSTICK * yard + 1e-2 * max(1.0, abs(want)), key
    for opt in ("ae_opt", "disc_opt"):
        assert port[0][opt][0] == step + 1
        assert _moment_distance(port[0], ref[0], opt) <= \
            YARDSTICK * _moment_distance(f32[0], ref[0], opt) + 0.05, opt
    # the EMA codebook: at most 4 of the 64 codes counted differently (a row
    # near a tie assigned to the other code); in the first step, where every
    # code restarts from the batch's rows, within the yardstick. From the
    # second step on a differently assigned row moves a whole code, and with
    # it the codebook's distance, so only the counts are held there.
    sd = [r[0]["state_dict"] for r in (port, ref, f32)]
    cb, cb_ref, cb_f32 = (d["quantize.codebook.weight"][:-1] for d in sd)
    size, size_ref = (d["quantize.codebook.cluster_size_ema"] for d in sd[:2])
    assert int((size != size_ref).sum()) <= 4
    if step == 0:
        rel = [float((a - cb_ref).norm() / cb_ref.norm()) for a in (cb, cb_f32)]
        assert rel[0] <= YARDSTICK * rel[1] + 1e-2


def test_training_keeps_f32_parameters_and_moments(steps):
    trainer = steps["trainer"]
    assert trainer.model.compute_dtype == BF16
    for name, p in trainer.ae_params.items():
        assert p.dtype == torch.float32, name
        assert trainer.ae_opt.m[name].dtype == torch.float32, name
    assert all(t.dtype == torch.float32 for t in trainer.model.quantize.codebook.buffers())
    moved = max(float((steps["port_bf16"][1][0]["state_dict"][k] -
                       steps["port_bf16"][0][0]["state_dict"][k]).abs().max())
                for k in ("encoder.conv_in.weight", "decoder.conv_out.weight"))
    assert moved > 0
