"""The triple-grain DQ-VAE and the Gumbel-gated feature router in the PyTorch
port against the JAX package, f32 on the CPU: the triple routers (every
`gate_type`, with and without GroupNorm; the two-threshold entropy router
at 32^2 patches), `TripleGrainEncoder` on shared weights (inference, and a
training forward with JAX's Gumbel noise fed to both sides), the triple
budget loss, and three stage-1 steps of a tiny triple-grain config and of a
tiny dual-grain feature-router config (`update_router`, the Gumbel gate)
against the JAX `Stage1Trainer`.

Gumbel noise: the two frameworks' generators cannot share a draw, so the JAX
noise is read out as it is drawn (`jax.random.gumbel` wrapped while the JAX
step is traced; one draw feeds the autoencoder pass and the discriminator
pass's fresh forward alike) and fed to the port (`draw_gumbel` replaced in
`train/stage1.py`, the encoder's `gumbel_noise` seam below it). The
codebook restart's draw is shared as in `tests/test_torch_stage1_train.py`,
whose tolerances hold here: logs 1e-5 relative on the first step, 2e-4
after (the third step as the second), Adam moments 1e-5 / 1e-3 of the
optimizer's largest entry, parameters 1e-6 / 2e-4 except entries whose
gradient is so small that f32 noise decides Adam's sign (at most a whole
update, 2 lr a step, on under 6 % of the entries); features 1e-4; grain
indices, masks and codes exact. Two differences, both measured: the steps
take lr 1e-4, not 1e-3. Adam's first update is +-lr on every entry, so
an entry whose sign f32 noise decides parts the two sides by 2 lr; at 1e-3
those partings moved the discriminator's mean fake logit (a value near 0)
by 8.8e-5 after the second step here, where at 1e-4 every log stays within
1.5e-5 relative over three steps. And the discriminator's moments, whose
gradient is taken on the reconstruction after the autoencoder's update (so
after those partings), are held to 2e-5 of their largest entry after the
first step (1.12e-5 measured, one entry of 384 past 1e-5) and to 1e-2
after the third (7.6e-3 measured, on its first conv alone: a LeakyReLU kink
of that layer that one side crosses); every other layer within 1e-3.

Then the port alone: a run resumed from its state after any step equals the
uninterrupted run bit for bit (the noise follows the trainer's generator,
whose state the state_dict carries); the shipped ymls build; the loop's
image logs draw three grains. The `cuda` cases hold the kernels at the
triple config's new shapes and the device-drawn gate against the plain path.

JAX and the helpers shared with other port tests are imported inside the
JAX-side tests.
"""
import copy
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.models.budget import (
    BudgetConstraintNormedSeparateRatioMSETripleGrain,
)
from dynamicvectorquantization_torch.models.dqvae import DualGrainVQModel, TripleGrainVQModel
from dynamicvectorquantization_torch.nn import routers
from dynamicvectorquantization_torch.nn.encoder_dual import draw_gumbel, gumbel_softmax_st
from dynamicvectorquantization_torch.train import stage1
from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.weights import (
    dqvae_state_dict_from_flax,
    load_stage1_state,
    stage1_state_from_flax,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUAL_FEAT_YML = os.path.join(_REPO, "configs/stage1/dqvae-dual-r-05_imagenet.yml")
TRIPLE_YML = os.path.join(_REPO, "configs/stage1/dqvae-triple-r-03-03_imagenet.yml")
THRESHOLDS = "scripts/tools/thresholds/entropy_thresholds_imagenet_train_patch-16.json"
ATOL = 1e-4
LR = 1e-4
STEPS = 3
LOG_RTOL = (1e-5, 2e-4, 2e-4)
MOMENT_REL = {"ae_opt": (1e-5, 1e-3, 1e-3), "disc_opt": (2e-5, 1e-3, 1e-2)}
PARAM_ATOL = (1e-6, 2e-4, 2e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _images(seed, b=2, size=64):
    """Left half smooth, right half noisy, so every grain can occur."""
    r = np.random.default_rng(seed)
    x = r.uniform(-1, 1, size=(b, size, size, 3)).astype(np.float32)
    x[:, :, : size // 2] = (0.2 + 0.01 * x[:, :, : size // 2]).astype(np.float32)
    return x


def _loss(budget):
    return {
        "target": "modules.losses.vqperceptual_multidisc.VQLPIPSWithDiscriminator",
        "params": {
            "disc_start": 0,
            "disc_config": {
                "target": "modules.discriminator.model.NLayerDiscriminator",
                "params": {"input_nc": 3, "ndf": 8, "n_layers": 2, "use_actnorm": False},
            },
            "disc_init": True, "codebook_weight": 1.0, "disc_weight": 1.0,
            "disc_weight_max": 0.75, "perceptual_weight": 1.0, "disc_loss": "hinge",
            "budget_loss_config": budget,
        },
    }


def _model_config(encoder, resolution, budget=None):
    return dict(
        encoderconfig=encoder,
        decoderconfig={
            "target": "modules.dynamic_modules.DecoderPositional.Decoder",
            "params": {"ch": 16, "in_ch": 32, "out_ch": 3, "ch_mult": [1, 1, 2, 2],
                       "num_res_blocks": 1, "resolution": resolution,
                       "attn_resolutions": [resolution // 8], "latent_size": resolution // 8,
                       "window_size": 2, "position_type": "fourier+learned"},
        },
        lossconfig=_loss(budget) if budget else None,
        vqconfig={
            "target": "modules.vector_quantization.quantize2_mask.VectorQuantize2",
            "params": {"codebook_size": 64, "codebook_dim": 32, "commitment_beta": 0.25,
                       "decay": 0.99, "restart_unused_codes": True, "use_pallas": False},
        },
        quant_before_dim=32, quant_after_dim=32, image_size=resolution,
        entropy_patch_size=resolution // 2,
    )


def triple_config(router="2layer-fc-SiLu", normalization="group-8", loss=False):
    """The shipped triple-grain yml cut to 64^2 (coarse 2x2, median 4x4, fine
    8x8) and ch 16; `router` a feature router's gate_type, or "entropy"."""
    if router == "entropy":
        router_cfg = {"target": "modules.dynamic_modules.RouterTriple.TripleGrainFixedEntropyRouter",
                      "params": {"json_path": THRESHOLDS, "fine_grain_ratito": 0.3,
                                 "median_grain_ratito": 0.3}}
    else:
        router_cfg = {"target": "modules.dynamic_modules.RouterTriple.TripleGrainFeatureRouter",
                      "params": {"num_channels": 32, "normalization_type": normalization,
                                 "gate_type": router}}
    encoder = {
        "target": "modules.dynamic_modules.EncoderTriple.TripleGrainEncoder",
        "params": {"ch": 16, "ch_mult": [1, 1, 2, 2, 4, 4], "num_res_blocks": 1,
                   "attn_resolutions": [4, 8], "dropout": 0.0, "in_channels": 3,
                   "resolution": 64, "z_channels": 32, "router_config": router_cfg},
    }
    budget = {"target": "modules.dynamic_modules.budget."
                        "BudgetConstraint_NormedSeperateRatioMSE_TripleGrain",
              "params": {"target_fine_ratio": 0.3, "target_median_ratio": 0.3, "gamma": 10.0,
                         "min_grain_size": 2, "median_grain_size": 4, "max_grain_size": 8}}
    return _model_config(encoder, 64, budget if loss else None)


def dual_feat_config(loss=False):
    """The shipped dual-grain feature-router yml (Gumbel gate, 2-layer SiLU
    gate, GroupNorm) cut to 32^2 (coarse 2x2, fine 4x4) and ch 16."""
    encoder = {
        "target": "modules.dynamic_modules.EncoderDual.DualGrainEncoder",
        "params": {"ch": 16, "ch_mult": [1, 1, 2, 2, 4], "num_res_blocks": 1,
                   "attn_resolutions": [4, 8], "dropout": 0.0, "in_channels": 3,
                   "resolution": 32, "z_channels": 32, "update_router": True,
                   "router_config": {
                       "target": "modules.dynamic_modules.RouterDual.DualGrainFeatureRouter",
                       "params": {"num_channels": 32, "normalization_type": "group-8",
                                  "gate_type": "2layer-fc-SiLu"}}},
    }
    budget = {"target": "modules.dynamic_modules.budget.BudgetConstraint_RatioMSE_DualGrain",
              "params": {"target_ratio": 0.5, "gamma": 10.0, "min_grain_size": 2,
                         "max_grain_size": 4, "calculate_all": True}}
    cfg = _model_config(encoder, 32, budget if loss else None)
    cfg["decoderconfig"]["params"]["attn_resolutions"] = [4]
    return cfg


def _gumbel(seed, shape):
    return np.random.default_rng(seed).gumbel(size=shape).astype(np.float32)


# ----------------------------------------------------------------- routers
@pytest.mark.parametrize("gate_type", ["1layer-fc", "2layer-fc-SiLu", "2layer-fc-ReLu"])
@pytest.mark.parametrize("normalization_type", ["none", "group-4"])
def test_triple_feature_router(gate_type, normalization_type):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn.routers import TripleGrainFeatureRouter as JRouter
    from tests.test_torch_decoder import _nhwc, _to_torch
    from tests.test_torch_stackgpt import perturbed

    c = 8
    feats = [_nhwc(2, (2, 8, 8, c)), _nhwc(3, (2, 4, 4, c)), _nhwc(4, (2, 2, 2, c))]
    jmod = JRouter(c, normalization_type, gate_type)
    params = jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, feats))["params"]
    params = perturbed(jax.device_get(params), np.random.default_rng(4), 0.05)
    ref = np.asarray(jmod.apply({"params": params}, *map(jnp.asarray, feats)))
    router = routers.TripleGrainFeatureRouter(c, normalization_type, gate_type)
    sd = dqvae_state_dict_from_flax({"params": {"encoder": {"router": params}}})
    router.load_state_dict({k[len("encoder.router."):]: v for k, v in sd.items()})
    with torch.no_grad():
        out = router(h_fine=_to_torch(feats[0]), h_median=_to_torch(feats[1]),
                     h_coarse=_to_torch(feats[2])).numpy()
    assert out.shape == (2, 2, 2, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_triple_fixed_entropy_router_thresholds():
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn.routers import TripleGrainFixedEntropyRouter as JRouter

    entropy = np.random.default_rng(1).uniform(0, 3.4, size=(2, 4, 4)).astype(np.float32)
    for kw in ({"json_path": THRESHOLDS, "fine_grain_ratito": 0.3, "median_grain_ratito": 0.3},
               {"json_path": THRESHOLDS},
               {"fine_threshold": 2.0, "median_threshold": 1.0}):
        ref = np.asarray(JRouter(**kw).apply({}, entropy=jnp.asarray(entropy)))
        out = routers.TripleGrainFixedEntropyRouter(**kw)(entropy=torch.from_numpy(entropy))
        np.testing.assert_array_equal(out.numpy(), ref)
        assert set(np.unique(ref.argmax(-1))) == {0, 1, 2}  # every grain occurs
        assert np.all(ref.sum(-1) == 1)


def test_triple_budget_loss_matches_jax():
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.models.budget import (
        BudgetConstraintNormedSeparateRatioMSETripleGrain as JBudget,
    )

    gate = np.random.default_rng(2).dirichlet(np.ones(3), size=(4, 8, 8)).astype(np.float32)
    for kw in ({}, {"target_fine_ratio": 0.3, "target_median_ratio": 0.3, "gamma": 10.0},
               {"target_fine_ratio": 0.5, "target_median_ratio": 0.2, "min_grain_size": 2,
                "median_grain_size": 4, "max_grain_size": 8}):
        ref = float(JBudget(**kw)(jnp.asarray(gate)))
        out = float(BudgetConstraintNormedSeparateRatioMSETripleGrain(**kw)(torch.from_numpy(gate)))
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        BudgetConstraintNormedSeparateRatioMSETripleGrain(0.6, 0.6)


def test_gumbel_softmax_st_is_hard_forward_and_soft_backward():
    logits = torch.tensor([[0.3, 1.2, -0.5]], requires_grad=True)
    noise = torch.tensor([[2.0, 0.0, 0.0]])
    gate = gumbel_softmax_st(logits, noise)
    torch.testing.assert_close(gate.detach(), torch.tensor([[1.0, 0.0, 0.0]]), atol=1e-6, rtol=0)
    (g,) = torch.autograd.grad(gate[0, 0], logits)
    soft = torch.softmax(logits + noise, -1).detach()[0]
    torch.testing.assert_close(g[0, 0], soft[0] * (1 - soft[0]))  # the softmax Jacobian
    u = draw_gumbel((4096,), torch.Generator().manual_seed(0))
    assert abs(float(u.mean()) - 0.5772) < 0.05 and torch.isfinite(u).all()  # Euler's gamma


# ---------------------------------------------------------------- encoders
TRIPLE_TARGET = "models.stage1_dynamic.dqvae_triple_feat.TripleGrainVQModel"


def _pair(cfg, seed=5):
    """(JAX model, its variables, the port's model with the same weights):
    the port's seeded init, perturbed from a numpy seed (so GroupNorm's unit
    scales carry signal too), carried to JAX by the JAX package's reference
    converter."""
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import convert_dqvae_state_dict

    tm = TripleGrainVQModel(**cfg)
    tm.init_weights(torch.Generator().manual_seed(seed))
    r = np.random.default_rng(seed)
    sd = {k: v + torch.from_numpy(r.normal(0.0, 0.05, tuple(v.shape)).astype(np.float32))
          if v.is_floating_point() and not k.startswith("quantize.") else v
          for k, v in tm.state_dict().items()}
    codebook = (0.5 * r.normal(size=(65, 32))).astype(np.float32)
    codebook[64] = 0.0  # codes far apart, so the argmin is nowhere near a tie
    sd["quantize.codebook.weight"] = torch.from_numpy(codebook)
    tm.load_state_dict(sd)
    jvars = convert_dqvae_state_dict({k: v.numpy() for k, v in sd.items()})
    return jinst({"target": TRIPLE_TARGET, "params": cfg}), jvars, tm.eval()


def _jax_encoder(jm, jvars, x, ent, train, noise):
    """The JAX encoder's outputs, a training forward gated with `noise`."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn import encoder_triple

    def fed(key, logits, tau=1.0, axis=-1):
        y_soft = jax.nn.softmax((logits + jnp.asarray(noise)) / tau, axis=axis)
        y_hard = jax.nn.one_hot(jnp.argmax(y_soft, axis=axis), logits.shape[axis], axis=axis,
                                dtype=logits.dtype)
        return y_hard + y_soft - jax.lax.stop_gradient(y_soft)

    mp = pytest.MonkeyPatch()
    mp.setattr(encoder_triple, "gumbel_softmax_st", fed)
    try:
        return jax.device_get(jax.jit(lambda v, a, e: jm.net.apply(
            v, a, e, method=lambda m, a_, e_: m.encoder(a_, e_, train=train),
            rngs={"gumbel": jax.random.PRNGKey(3)}))(jvars, jnp.asarray(x), ent))
    finally:
        mp.undo()


@pytest.mark.parametrize("router", ["2layer-fc-SiLu", "entropy"])
def test_triple_grain_encoder_matches_jax(router):
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.entropy import patch_entropy as jax_entropy
    from tests.test_torch_decoder import _from_torch, _to_torch

    jm, jvars, tm = _pair(triple_config(router))
    assert tm.use_entropy == (router == "entropy") and tm.feature_key == "h_triple"
    x = _images(6)
    ent = jax_entropy(jnp.asarray(x), 32) if router == "entropy" else None
    t_ent = None if ent is None else torch.from_numpy(np.array(ent))
    noise = _gumbel(7, (2, 2, 2, 3))
    for train in (False, True):
        ref = _jax_encoder(jm, jvars, x, ent, train, noise)
        with torch.no_grad():
            out = tm.encoder(_to_torch(x), t_ent, train=train,
                             gumbel_noise=torch.from_numpy(noise) if train else None)
        np.testing.assert_array_equal(out["indices"].numpy(), np.asarray(ref["indices"]))
        np.testing.assert_array_equal(out["codebook_mask"].numpy(),
                                      np.asarray(ref["codebook_mask"]))
        np.testing.assert_allclose(out["gate"].numpy(), np.asarray(ref["gate"]), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(_from_torch(out["h_triple"]), np.asarray(ref["h_triple"]),
                                   atol=ATOL, rtol=0)
        assert out["h_triple"].shape == (2, 32, 8, 8)
        if train or router == "entropy":
            assert len(np.unique(out["indices"].numpy())) >= 2
    # the DQ-VAE encodes through `h_triple`: codes equal JAX's
    import jax

    quant_r, _, info_r, grain_r, gate_r, _ = jax.jit(jm.encode)(jvars, jnp.asarray(x))
    with torch.no_grad():
        quant, _, info, grain, gate, _ = tm.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(info[2].numpy(), np.asarray(info_r[2]))
    np.testing.assert_array_equal(grain.numpy(), np.asarray(grain_r))
    np.testing.assert_allclose(quant.numpy(), np.asarray(quant_r), atol=ATOL, rtol=0)


def test_port_state_dict_converts_to_the_jax_triple_model():
    """The port's triple-grain names are the reference's: the JAX package's
    reference converter takes the port's state_dict to the JAX model's own
    tree, leaf for leaf and shape for shape."""
    import jax

    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import convert_dqvae_state_dict

    cfg = triple_config()
    tm = TripleGrainVQModel(**cfg)
    conv = convert_dqvae_state_dict({k: v.numpy() for k, v in tm.state_dict().items()})
    ref = jax.eval_shape(jinst({"target": TRIPLE_TARGET, "params": cfg}).init,
                         jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path
    want = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in flat(ref)[0]}
    got = {jax.tree_util.keystr(p): tuple(np.shape(v)) for p, v in flat(conv)[0]}
    assert got == want and any("head_median" in k for k in got)
    assert any("feature_norm_median" in k for k in got)


# ----------------------------------------------------- stage-1 training
def _jax_runs(cfg, triple, batches):
    """The JAX trainer's steps with the restart draw shared and each step's
    Gumbel noise read out; (initial state, [(state, logs, noise)])."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.models.dqvae import DualGrainVQModel as JDual
    from dynamicvectorquantization_tpu.models.dqvae import TripleGrainVQModel as JTriple
    from dynamicvectorquantization_tpu.train.stage1 import Stage1Trainer as JTrainer
    from tests.test_torch_stage1_train import _shared_draw

    import flax.linen as fnn

    import dynamicvectorquantization_tpu.nn.lpips  # noqa: F401  (its constants, before any trace)

    jtrainer = JTrainer((JTriple if triple else JDual)(**cfg), learning_rate=LR, warmup_steps=0,
                        max_steps=100, remat=False)

    def jitted_init(module, rngs, *args, **kwargs):  # one compile instead of op-by-op
        return jax.jit(lambda r, *a: fnn.Module.init(module, r, *a, **kwargs))(rngs, *args)

    mp = pytest.MonkeyPatch()
    mp.setattr(type(jtrainer.net), "init", jitted_init)
    mp.setattr(type(jtrainer.loss), "init", jitted_init)
    try:
        state = jax.device_get(jtrainer.init_state(jax.random.PRNGKey(1),
                                                   jnp.asarray(batches[0])))
    finally:
        mp.undo()
    drawn = []
    gumbel = jax.random.gumbel

    def recorded(key, shape=(), dtype=jnp.float32):
        g = gumbel(key, shape, dtype)
        jax.debug.callback(lambda a: drawn.append(np.asarray(a)), g)
        return g

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(_shared_draw(n, None)[1]))
    mp.setattr(jax.random, "uniform",
               lambda key, shape, *a, **k: jnp.asarray(_shared_draw(1, shape)[0]))
    mp.setattr(jax.random, "gumbel", recorded)
    out, s = [], state
    try:
        step = jax.jit(jtrainer.train_step)
        for i, x in enumerate(batches):
            del drawn[:]
            s, logs = step(s, jnp.asarray(x), jax.random.PRNGKey(10 + i))
            s = jax.device_get(s)
            logs = {k: float(v) for k, v in logs.items()}
            jax.effects_barrier()
            # the autoencoder pass and the discriminator pass's forward: one draw
            assert len(drawn) == 2 and np.array_equal(drawn[0], drawn[1])
            out.append((s, logs, drawn[0].copy()))
    finally:
        mp.undo()
    return state, out


def _snapshot(trainer):
    return dict(state_dict={k: v.clone() for k, v in trainer.model.state_dict().items()},
                ae_opt=(trainer.ae_opt.count, {k: v.clone() for k, v in trainer.ae_opt.m.items()},
                        {k: v.clone() for k, v in trainer.ae_opt.v.items()}),
                disc_opt=(trainer.disc_opt.count,
                          {k: v.clone() for k, v in trainer.disc_opt.m.items()},
                          {k: v.clone() for k, v in trainer.disc_opt.v.items()}))


def _three_steps(kind):
    from tests.test_torch_stage1_train import _port_draw

    triple = kind == "triple"
    cfg = triple_config(loss=True) if triple else dual_feat_config(loss=True)
    size = 64 if triple else 32
    batches = [_images(20 + i, size=size) for i in range(STEPS)]
    state, ref = _jax_runs(cfg, triple, batches)
    trainer = Stage1Trainer((TripleGrainVQModel if triple else DualGrainVQModel)(**cfg), LR,
                            warmup_steps=0, max_steps=100, device="cpu")
    load_stage1_state(trainer, stage1_state_from_flax(state))
    trainer.model.quantize._draw_restart = _port_draw
    fed = []

    def draw(shape, generator, device):
        assert tuple(shape) == fed[0].shape
        return torch.from_numpy(fed[0])

    mp = pytest.MonkeyPatch()
    mp.setattr(stage1, "draw_gumbel", draw)
    out = []
    try:
        for (jstate, jlogs, noise), x in zip(ref, batches):
            fed[:] = [noise]
            logs = trainer.train_step(x, torch.Generator().manual_seed(0))
            out.append((stage1_state_from_flax(jstate), jlogs, _snapshot(trainer),
                        {k: float(v) for k, v in logs.items()}))
    finally:
        mp.undo()
    return out, stage1_state_from_flax(state)


@pytest.fixture(scope="module", params=["triple", "dual_feat"])
def three_steps(request):
    return request.param, _three_steps(request.param)


def test_logs_match_jax(three_steps):
    kind, (steps, _) = three_steps
    for step, (_, jlogs, _, logs) in enumerate(steps):
        assert sorted(logs) == sorted(jlogs)
        for k, v in jlogs.items():
            np.testing.assert_allclose(logs[k], v, rtol=LOG_RTOL[step], atol=1e-6,
                                       err_msg=f"step {step} {k}")
        assert logs["train_budget_loss"] >= 0.0
    if kind == "triple":
        assert "train_median_ratio" in steps[0][3]
    else:
        assert "train_median_ratio" not in steps[0][3]


def test_adam_states_and_parameters_match_jax(three_steps):
    from tests.test_torch_stage1_train import _assert_moments

    _, (steps, start) = three_steps
    for step, (ref, _, snap, _) in enumerate(steps):
        for opt in ("ae_opt", "disc_opt"):
            assert snap[opt][0] == ref[opt][0] == step + 1
            _assert_moments(snap[opt][1], ref[opt][1], MOMENT_REL[opt][step], f"{opt} m")
            _assert_moments(snap[opt][2], ref[opt][2], MOMENT_REL[opt][step], f"{opt} v")
        sd, sd_r = snap["state_dict"], ref["state_dict"]
        names = [k for k in sd_r if k.startswith(("encoder.", "decoder.", "quant_conv.",
                                                  "post_quant_conv.", "loss.discriminator."))
                 and "running" not in k and "num_batches" not in k]
        largest = {opt: max(float(t.abs().max()) for t in ref[opt][1].values())
                   for opt in ("ae_opt", "disc_opt")}
        loose = 0
        for k in names:
            opt = "disc_opt" if k.startswith("loss.discriminator.") else "ae_opt"
            tiny = ref[opt][1][k.removeprefix("loss.discriminator.")].abs() < 1e-4 * largest[opt]
            diff = (sd[k] - sd_r[k]).abs()
            if not tiny.all():
                assert float(diff[~tiny].max()) <= PARAM_ATOL[step], (step, k)
            if tiny.any():
                assert float(diff[tiny].max()) <= 2.02 * LR * (step + 1), (step, k)
                loose += int(tiny.sum())
        assert loose < 0.06 * sum(sd_r[k].numel() for k in names)
    # the router's gate took gradients through the Gumbel straight-through path
    gate = [k for k in steps[0][2]["ae_opt"][1] if k.startswith("encoder.router.gate")]
    assert gate and all(float(steps[0][2]["ae_opt"][1][k].abs().max()) > 0 for k in gate)


def test_ema_and_batchnorm_match_jax(three_steps):
    _, (steps, _) = three_steps
    for ref, _, snap, _ in steps:
        for k, v in ref["state_dict"].items():
            if k.startswith("quantize.") or "running" in k:
                np.testing.assert_allclose(snap["state_dict"][k].numpy(), v.numpy(), atol=1e-5,
                                           rtol=1e-5, err_msg=k)


# ------------------------------------------------------ the port alone
def _fresh(kind, seed=0):
    cfg = triple_config(loss=True) if kind == "triple" else dual_feat_config(loss=True)
    model = (TripleGrainVQModel if kind == "triple" else DualGrainVQModel)(**cfg)
    trainer = Stage1Trainer(model, LR, warmup_steps=0, max_steps=100, device="cpu", seed=seed)
    return trainer.init_state(torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def uninterrupted():
    """Three steps of the port's own triple-grain run (its generator draws the
    Gumbel noise and the restarts), with the state after each."""
    trainer = _fresh("triple")
    x = _images(30)
    states, logs = [copy.deepcopy(trainer.state_dict())], []
    for _ in range(STEPS):
        logs.append(trainer.train_step(x))
        states.append(copy.deepcopy(trainer.state_dict()))
    return x, states, logs


@pytest.mark.parametrize("resume_at", range(STEPS))
def test_resume_is_bit_equal_at_any_step(uninterrupted, resume_at):
    x, states, logs = uninterrupted
    trainer = _fresh("triple", seed=0)
    trainer.load_state_dict(copy.deepcopy(states[resume_at]))
    for step in range(resume_at, STEPS):
        got = trainer.train_step(x)
        for k, v in logs[step].items():
            assert torch.equal(got[k], v), (step, k)
    final = trainer.state_dict()
    for k, v in states[-1]["model"].items():
        assert torch.equal(final["model"][k], v), k
    assert torch.equal(final["generator"], states[-1]["generator"])


def test_gumbel_noise_follows_the_trainer_generator(uninterrupted):
    """Another seed draws other noise, so other grains; the same seed, the same."""
    x, _, logs = uninterrupted
    other = _fresh("triple", seed=0)
    other.generator.manual_seed(1)
    ratios = [(float(logs[0]["train_fine_ratio"]), float(logs[0]["train_median_ratio"]))]
    got = other.train_step(x)
    ratios.append((float(got["train_fine_ratio"]), float(got["train_median_ratio"])))
    assert not torch.equal(got["train_aeloss"], logs[0]["train_aeloss"])
    assert all(0.0 <= a + b <= 1.0 for a, b in ratios)
    ev = other.eval_step(x)
    assert {"val_fine_ratio", "val_median_ratio"} <= set(ev)


@pytest.mark.parametrize("path,cls,shape", [
    (DUAL_FEAT_YML, DualGrainVQModel, (8, 16, 16, 2)),
    (TRIPLE_YML, TripleGrainVQModel, (8, 8, 8, 3))])
def test_shipped_configs_build(path, cls, shape):
    from dynamicvectorquantization_torch.utils.model_loading import load_first_stage_model

    model = load_first_stage_model(path, device="cpu")
    assert type(model) is cls and model.encoder.gumbel_shape(8) == shape
    assert not model.use_entropy
    n = sum(p.numel() for p in model.parameters())
    assert n > 40_000_000
    assert model.loss.__class__.__name__ == "DummyLoss"


def test_triple_grain_map_and_image_logs(tmp_path):
    """Three grains get three colours, as JAX's triple drawer gives them (the
    port draws every grain map with `draw_grain_map_color`)."""
    from dynamicvectorquantization_torch.train.loop import Trainer
    from dynamicvectorquantization_torch.utils.logging import ImageLogger, draw_grain_map_color
    from dynamicvectorquantization_tpu.utils import viz

    images = np.zeros((1, 8, 8, 3), np.float32)
    grains = np.array([[[0, 1], [2, 2]]])
    out = draw_grain_map_color(images, grains)
    np.testing.assert_array_equal(out, viz.draw_triple_grain_256res_color(images, grains))
    colours = {tuple(out[0, 2, 2]), tuple(out[0, 2, 6]), tuple(out[0, 6, 2])}
    assert len(colours) == 3
    model = _fresh("triple").model

    class _Loop:
        images = ImageLogger(str(tmp_path), batch_frequency=1)

    Trainer._log_stage1_images(_Loop(), model, torch.from_numpy(_images(31)), "train", 0, 0, 0)
    written = sorted(os.listdir(tmp_path / "images" / "train"))
    assert [n.split("_")[0] for n in written] == ["grain", "inputs", "reconstructions"]


# ------------------------------------------------------------------- cuda
@pytest.mark.cuda
def test_cuda_kernels_at_the_triple_configs_new_shapes(cuda_device):
    """#4 / #5 f32 at (8, 64, 512) (the coarse head's 8x8 attention), #10 f32
    at 16^2 x 512 -> 8^2, #3 at 32^2 patches: each against its plain version."""
    from dynamicvectorquantization_torch.ops import attention, downsample, entropy

    r = np.random.default_rng(40)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * r.normal(size=shape)).astype(np.float32)).to(cuda_device)

    q, k, v = t(8, 64, 512), t(8, 64, 512), t(8, 64, 512)
    scale = 512 ** -0.5
    y, lse = attention.fused_attention_forward(q, k, v, 1, scale, causal=False, return_lse=True)
    y_ref, lse_ref = attention.fused_attention_forward_plain(q, k, v, 1, scale, causal=False,
                                                             return_lse=True)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=0)
    dy = t(8, 64, 512)
    grads = attention.fused_attention_backward(q, k, v, y, lse, dy, 1, scale, causal=False)
    refs = attention.fused_attention_backward_plain(q, k, v, y_ref, lse_ref, dy, 1, scale,
                                                    causal=False)
    for a, b in zip(grads, refs):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    x, w, b = t(8, 512, 16, 16), t(512, 512, 3, 3, scale=(9 * 512) ** -0.5), t(512, scale=0.1)
    conv = downsample.strided_conv3x3_down
    before = (conv.f32_blocked_launches, sum(conv.f32_tiling_launches.values()))
    out = conv(x, w, b)
    assert (conv.f32_blocked_launches, sum(conv.f32_tiling_launches.values())) == (
        before[0] + 1, before[1] + 1)
    # the tiling the kernel reports: its tile and the block count of its grid
    rows, cols, channels = conv.last_f32_tiling["tile"]
    assert conv.last_f32_tiling["tiling"] in downsample.F32_TILINGS and cols == 16
    assert conv.last_f32_tiling["blocks"] == -(-8 // rows) * -(-8 // cols) * -(-512 // channels) * 8
    torch.testing.assert_close(out, downsample.strided_conv3x3_down_plain(x, w, b), atol=1e-4,
                               rtol=0)
    images = torch.from_numpy(_images(41, b=8, size=256)).to(cuda_device)
    torch.testing.assert_close(entropy.patch_entropy(images, 32),
                               entropy.patch_entropy_plain(images, 32), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_gumbel_gate_drawn_on_the_device(cuda_device):
    """The noise is drawn on the images' card from the trainer's generator;
    fed to the plain path on the CPU it gives the same grains and features."""
    trainer = Stage1Trainer(TripleGrainVQModel(**triple_config(loss=True)), LR,
                            device=cuda_device).init_state(
        torch.Generator(device=cuda_device).manual_seed(0))
    x = torch.from_numpy(_images(42)).to(cuda_device)
    noise = trainer._gumbel_noise(x, trainer.generator)
    assert noise.device.type == "cuda" and noise.shape == (2, 2, 2, 3)
    cpu = TripleGrainVQModel(**triple_config())
    cpu.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()
                         if not k.startswith("loss.")})
    with torch.no_grad():
        out = trainer.model.encoder(x.permute(0, 3, 1, 2).contiguous(), train=True,
                                    gumbel_noise=noise)
        ref = cpu.encoder(x.cpu().permute(0, 3, 1, 2).contiguous(), train=True,
                          gumbel_noise=noise.cpu())
    assert torch.equal(out["indices"].cpu(), ref["indices"])
    torch.testing.assert_close(out["h_triple"].cpu(), ref["h_triple"], atol=1e-4, rtol=0)
