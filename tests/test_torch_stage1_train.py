"""Stage-1 (DQ-VAE + GAN) training in the PyTorch port against the JAX
package's `Stage1Trainer`, f32 on the CPU, at the tiny configuration of the
JAX package's own stage-1 test (32^2 images, entropy router, PatchGAN `ndf`
8 with two layers, budget loss): the JAX state is converted by
`utils.weights.stage1_state_from_flax` and both sides take the same two
steps on the same numpy batches.

Randomness: the codebook restart draws a permutation (and, with fewer rows
than codes, jitter) that the two frameworks' generators cannot share, so
both sides are given the same draw: `jax.random.permutation` / `uniform`
are replaced while the JAX step is traced, the port's
`VectorQuantizeEMA._draw_restart` likewise. At this size (32 rows, 64
codes) every code restarts in step 1, so that branch decides the codebook.

Tolerances, first step: logs 1e-5 relative (+ 1e-6 absolute); the Adam
moments, which are the gradients up to a factor, 1e-5 of the optimizer's
largest entry; the EMA collection and BatchNorm statistics 1e-5;
parameters 1e-6 absolute except where Adam's m / (sqrt(v) + eps) is taken
of a gradient entry so small (< 1e-4 of the optimizer's largest; some
leaves, like an attention key bias, have a mathematically zero gradient)
that f32 noise decides its sign: those, under 6 % of the entries, may
differ by a whole update, 2 lr. The second step therefore starts from
parameters that already differ a little, and is held to 2e-4 (logs,
parameters) and 1e-3 (moments) instead. LPIPS must not move at all.

JAX is imported inside the tests.
"""
import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.models.dqvae import DualGrainVQModel
from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
from dynamicvectorquantization_torch.utils.weights import (
    load_stage1_state,
    stage1_state_from_flax,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LR = 1e-3
STEPS = 2


def _config():
    from tests.test_dqvae import dual_config

    cfg = dual_config(resolution=32, entropy_router=True)
    cfg["lossconfig"] = {
        "target": "modules.losses.vqperceptual_multidisc.VQLPIPSWithDiscriminator",
        "params": {
            "disc_start": 0,
            "disc_config": {
                "target": "modules.discriminator.model.NLayerDiscriminator",
                "params": {"input_nc": 3, "ndf": 8, "n_layers": 2, "use_actnorm": False},
            },
            "disc_init": True,
            "codebook_weight": 1.0,
            "disc_weight": 1.0,
            "disc_weight_max": 0.75,
            "perceptual_weight": 1.0,
            "disc_loss": "hinge",
            "budget_loss_config": {
                "target": "modules.dynamic_modules.budget.BudgetConstraint_RatioMSE_DualGrain",
                "params": {"target_ratio": 0.5, "gamma": 1.0,
                           "min_grain_size": 2, "max_grain_size": 4},
            },
        },
    }
    return cfg


def _images(seed, *lead, b=2):
    """Left half smooth, right half noisy, so both grains occur."""
    r = np.random.default_rng(seed)
    x = r.uniform(-1, 1, size=(*lead, b, 32, 32, 3)).astype(np.float32)
    x[..., :16, :] = (0.2 + 0.01 * x[..., :16, :]).astype(np.float32)
    return x


def _shared_draw(pool_rows, noise_shape):
    perm = np.random.default_rng(pool_rows).permutation(pool_rows)
    noise = (None if noise_shape is None else
             np.random.default_rng(7).uniform(size=noise_shape).astype(np.float32))
    return noise, perm


def _port_draw(pool_rows, noise_shape, generator, device):
    noise, perm = _shared_draw(pool_rows, noise_shape)
    return (None if noise is None else torch.from_numpy(noise)), torch.from_numpy(perm)


def _both(accum=1):
    """(JAX trainer, its initial state, the port's trainer in the same state)."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.models.dqvae import DualGrainVQModel as JModel
    from dynamicvectorquantization_tpu.train.stage1 import Stage1Trainer as JTrainer

    jtrainer = JTrainer(JModel(**_config()), learning_rate=LR, warmup_steps=0, max_steps=100,
                        remat=False, accum=accum)
    state = jax.device_get(jtrainer.init_state(jax.random.PRNGKey(1), jnp.asarray(_images(0))))
    trainer = Stage1Trainer(DualGrainVQModel(**_config()), LR, warmup_steps=0, max_steps=100,
                            accum=accum, device="cpu")
    load_stage1_state(trainer, stage1_state_from_flax(state))
    trainer.model.quantize._draw_restart = _port_draw
    return jtrainer, state, trainer


def _jax_steps(jtrainer, state, batches):
    """The JAX trainer's steps with the shared restart draw traced in."""
    import jax
    import jax.numpy as jnp

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(_shared_draw(n, None)[1]))
    mp.setattr(jax.random, "uniform",
               lambda key, shape, *a, **k: jnp.asarray(_shared_draw(1, shape)[0]))
    try:
        step = jax.jit(jtrainer.train_step)
        out = []
        for i, x in enumerate(batches):
            state, logs = step(state, jnp.asarray(x), jax.random.PRNGKey(10 + i))
            out.append((jax.device_get(state), {k: float(v) for k, v in logs.items()}))
    finally:
        mp.undo()
    return out


def _snapshot(trainer):
    return dict(state_dict={k: v.clone() for k, v in trainer.model.state_dict().items()},
                ae_opt=(trainer.ae_opt.count, {k: v.clone() for k, v in trainer.ae_opt.m.items()},
                        {k: v.clone() for k, v in trainer.ae_opt.v.items()}),
                disc_opt=(trainer.disc_opt.count,
                          {k: v.clone() for k, v in trainer.disc_opt.m.items()},
                          {k: v.clone() for k, v in trainer.disc_opt.v.items()}),
                step=trainer.step, epoch=trainer.epoch)


@pytest.fixture(scope="module")
def two_steps():
    """Per step: (the converted JAX state, its logs, the port's snapshot, its logs)."""
    jtrainer, state, trainer = _both()
    batches = [_images(1), _images(2)]
    ref = _jax_steps(jtrainer, state, batches)
    out = []
    for (jstate, jlogs), x in zip(ref, batches):
        logs = trainer.train_step(x, torch.Generator().manual_seed(0))
        out.append((stage1_state_from_flax(jstate), jlogs, _snapshot(trainer),
                    {k: float(v) for k, v in logs.items()}))
    return out, stage1_state_from_flax(state)


LOG_RTOL = (1e-5, 2e-4)  # by step, see the module docstring
MOMENT_REL = (1e-5, 1e-3)
PARAM_ATOL = (1e-6, 2e-4)


def _assert_moments(ours, ref, rel, what):
    """Every leaf within `rel` of the largest entry over all leaves."""
    assert sorted(ours) == sorted(ref)
    scale = max(float(t.abs().max()) for t in ref.values())
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(), atol=rel * scale, rtol=0,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("step", range(STEPS))
def test_logs_match_jax(two_steps, step):
    _, jlogs, _, logs = two_steps[0][step]
    assert sorted(logs) == sorted(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(logs[k], v, rtol=LOG_RTOL[step], atol=1e-6, err_msg=k)
    assert logs["train_d_weight"] <= 0.75 + 1e-6
    assert 0.0 < logs["train_fine_ratio"] < 1.0 and logs["train_budget_loss"] >= 0.0
    assert logs["train_nll_loss"] == logs["train_rec_loss"]


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("opt", ["ae_opt", "disc_opt"])
def test_adam_states_match_jax(two_steps, step, opt):
    ref, _, snap, _ = two_steps[0][step]
    (count_r, m_r, v_r), (count, m, v) = ref[opt], snap[opt]
    assert count == count_r == step + 1
    _assert_moments(m, m_r, MOMENT_REL[step], f"{opt} m")
    _assert_moments(v, v_r, MOMENT_REL[step], f"{opt} v")
    assert any(float(t.abs().max()) > 0 for t in m.values())


@pytest.mark.parametrize("step", range(STEPS))
def test_parameters_match_jax(two_steps, step):
    ref, _, snap, _ = two_steps[0][step]
    sd, sd_r = snap["state_dict"], ref["state_dict"]
    names = [k for k in sd_r if k.startswith(("encoder.", "decoder.", "quant_conv.",
                                              "post_quant_conv.", "loss.discriminator."))
             and "running" not in k and "num_batches" not in k]
    assert len(names) > 100
    largest = {opt: max(float(t.abs().max()) for t in ref[opt][1].values())
               for opt in ("ae_opt", "disc_opt")}
    loose = 0
    for k in names:
        opt = "disc_opt" if k.startswith("loss.discriminator.") else "ae_opt"
        tiny = ref[opt][1][k.removeprefix("loss.discriminator.")].abs() < 1e-4 * largest[opt]
        diff = (sd[k] - sd_r[k]).abs()
        if not tiny.all():
            assert float(diff[~tiny].max()) <= PARAM_ATOL[step], k
        if tiny.any():
            assert float(diff[tiny].max()) <= 2.02 * LR * (step + 1), k
            loose += int(tiny.sum())
    total = sum(sd_r[k].numel() for k in names)
    assert loose < 0.06 * total  # the tight comparison covers over 94 % of the entries
    moved = max(float((sd[k] - two_steps[1]["state_dict"][k]).abs().max()) for k in names)
    assert moved > 0.5 * LR


@pytest.mark.parametrize("step", range(STEPS))
def test_ema_collection_matches_jax(two_steps, step):
    ref, _, snap, _ = two_steps[0][step]
    for k in ("weight", "cluster_size_ema", "embed_ema"):
        key = f"quantize.codebook.{k}"
        np.testing.assert_allclose(snap["state_dict"][key].numpy(), ref["state_dict"][key].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    # one update per step, not two: the discriminator pass's is discarded
    before = (two_steps[1] if step == 0 else two_steps[0][step - 1][0])["state_dict"]
    assert not torch.equal(snap["state_dict"]["quantize.codebook.weight"],
                           before["quantize.codebook.weight"])
    assert float(snap["state_dict"]["quantize.codebook.weight"][-1].abs().max()) == 0.0


def test_every_code_restarts_in_the_first_step(two_steps):
    ref, _, snap, _ = two_steps[0][0]
    assert torch.equal(ref["state_dict"]["quantize.codebook.cluster_size_ema"], torch.ones(64))
    assert torch.equal(snap["state_dict"]["quantize.codebook.cluster_size_ema"], torch.ones(64))


@pytest.mark.parametrize("step", range(STEPS))
def test_batchnorm_statistics_match_jax(two_steps, step):
    ref, _, snap, _ = two_steps[0][step]
    keys = [k for k in ref["state_dict"] if "running" in k]
    assert len(keys) == 4
    for k in keys:
        np.testing.assert_allclose(snap["state_dict"][k].numpy(), ref["state_dict"][k].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
        assert not torch.equal(snap["state_dict"][k], two_steps[1]["state_dict"][k])
    # g_loss, d_loss real, d_loss fake: three training calls a step
    tracked = [v for k, v in snap["state_dict"].items() if k.endswith("num_batches_tracked")]
    assert all(int(v) == 3 * (step + 1) for v in tracked)


def test_lpips_does_not_move(two_steps):
    steps, start = two_steps
    keys = [k for k in start["state_dict"] if k.startswith("loss.perceptual_loss.")]
    assert len(keys) == 31
    for k in keys:
        assert torch.equal(steps[-1][2]["state_dict"][k], start["state_dict"][k]), k
        assert torch.equal(steps[-1][0]["state_dict"][k], start["state_dict"][k]), k


def test_converted_state_loads_strictly_and_counts_steps(two_steps):
    steps, start = two_steps
    assert steps[-1][2]["step"] == steps[-1][0]["step"] == STEPS
    assert steps[-1][2]["epoch"] == steps[-1][0]["epoch"] == 0
    model = DualGrainVQModel(**_config())
    own = model.state_dict()
    constants = {k for k in own if ".scaling_layer." in k}
    assert set(own) - constants == set(start["state_dict"])
    trainer = Stage1Trainer(model, LR, device="cpu")
    load_stage1_state(trainer, steps[0][0])
    assert trainer.step == 1 and trainer.ae_opt.count == 1 and trainer.disc_opt.count == 1
    for k, v in steps[0][0]["state_dict"].items():
        assert torch.equal(model.state_dict()[k], v), k


def test_accum_two_matches_jax():
    """Microbatches of 4 images: 64 rows for 64 codes, so the restart takes
    whole input rows (no tiling, no jitter). With fewer rows the restarted
    codebook holds near-duplicate pairs of jittered rows, and which of a pair
    the discriminator pass's fresh forward picks is decided by f32 noise."""
    jtrainer, state, trainer = _both(accum=2)
    x = _images(3, 2, b=4)
    (jstate, jlogs), = _jax_steps(jtrainer, state, [x])
    logs = trainer.train_step(x, torch.Generator().manual_seed(0))
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), v, rtol=1e-5, atol=1e-6, err_msg=k)
    ref, snap = stage1_state_from_flax(jstate), _snapshot(trainer)
    for opt in ("ae_opt", "disc_opt"):
        assert snap[opt][0] == ref[opt][0] == 1  # each optimizer stepped once
        _assert_moments(snap[opt][1], ref[opt][1], 1e-5, f"{opt} m")
    for k, v in ref["state_dict"].items():
        if k.startswith("quantize.") or "running" in k:  # evolved per microbatch
            np.testing.assert_allclose(snap["state_dict"][k].numpy(), v.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
    tracked = [v for k, v in snap["state_dict"].items() if k.endswith("num_batches_tracked")]
    assert all(int(v) == 6 for v in tracked)
    with pytest.raises(ValueError):
        trainer.train_step(_images(3, 3, b=4))


def test_eval_step_matches_jax():
    import jax
    import jax.numpy as jnp

    jtrainer, state, trainer = _both()
    x = _images(4)
    ref = jax.jit(jtrainer.eval_step)(state, jnp.asarray(x))
    before = _snapshot(trainer)["state_dict"]
    out = trainer.eval_step(x)
    assert sorted(out) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(out[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k  # evaluation moves nothing


def _fresh_trainer(seed=0, **kwargs):
    trainer = Stage1Trainer(DualGrainVQModel(**_config()), LR, warmup_steps=0, max_steps=100,
                            device="cpu", **kwargs)
    return trainer.init_state(torch.Generator().manual_seed(seed))


def test_train_steps_equals_sequential_steps():
    xs = _images(5, 2)
    a, b = _fresh_trainer(), _fresh_trainer()
    stacked = a.train_steps(xs, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(1)
    seq = [b.train_step(x, g) for x in xs]
    assert stacked["train_aeloss"].shape == (2,)
    for k in stacked:
        assert torch.equal(stacked[k], torch.stack([s[k] for s in seq])), k
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k
    assert a.step == b.step == 2


def test_init_state_is_seeded_and_trains():
    a, b, c = _fresh_trainer(0), _fresh_trainer(0), _fresh_trainer(1)
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k
    assert not torch.equal(a.model.encoder.conv_in.weight, c.model.encoder.conv_in.weight)
    cb = a.model.quantize.codebook
    assert torch.equal(cb.embed_ema, cb.weight[:-1]) and float(cb.cluster_size_ema.sum()) == 0.0
    x = _images(6)
    g = torch.Generator().manual_seed(2)
    first = float(a.eval_step(x)["val_rec_loss"])
    for _ in range(8):
        logs = a.train_step(x, g)
        assert all(np.isfinite(float(v)) for v in logs.values())
    assert float(a.eval_step(x)["val_rec_loss"]) < first


def test_gate_step_follows_epoch_or_step():
    cfg = _config()
    cfg["lossconfig"]["params"]["disc_start"] = 1
    for with_epoch, want in ((True, [0.0, 0.0]), (False, [0.0, 1.0])):
        model = DualGrainVQModel(**cfg, loss_with_epoch=with_epoch)
        trainer = Stage1Trainer(model, LR, device="cpu").init_state(
            torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(1)
        got = [float(trainer.train_step(_images(7), g)["train_disc_factor"]) for _ in range(2)]
        assert got == want
    trainer.epoch = 1
    assert float(trainer.train_step(_images(7), g)["train_disc_factor"]) == 1.0


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        Stage1Trainer(DualGrainVQModel(**_config()), LR, remat=True, device="cpu")
    cfg = _config()
    cfg["lossconfig"] = None
    with pytest.raises(ValueError):
        Stage1Trainer(DualGrainVQModel(**cfg), LR, device="cpu")
    # bf16 is ported (tests/test_torch_bf16_stage1.py); float16 is not
    with pytest.raises(NotImplementedError):
        DualGrainVQModel(**_config(), compute_dtype="float16")


def test_trainer_defaults_to_cuda():
    model = DualGrainVQModel(**_config())
    if torch.cuda.is_available():
        assert Stage1Trainer(model, LR).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Stage1Trainer(model, LR)
