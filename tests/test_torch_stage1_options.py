"""The stage-1 options that no shipped config sets, in the PyTorch port
against the JAX package's modules on shared weights and the same numpy
inputs, f32 on the CPU:

  * ActNorm in `NLayerDiscriminator` (`use_actnorm`): `loc` / `scale` set
    from data as the JAX module's init sets them (1e-5 relative), the
    discriminator's output in both modes, and ActNorm's `reverse` and
    `logdet` paths (1e-5); the stage-1 trainer sets them from its sample
    batch (the loop: the first training batch's first image) and carries
    them in its state dict;
  * `disc_conditional`: `g_loss`, `nll_and_g` and `d_loss` with a condition
    concatenated on the channel axis (1e-5, the BatchNorm statistics 1e-6;
    `perceptual_weight` 0, so the L1 term stands for `nll`);
  * ResnetBlock dropout in a training forward of the DQ-VAE, the JAX masks
    read out as flax's `Dropout` draws them and fed to the port (the two
    generators cannot share a draw), reconstruction atol 1e-4;
  * the decoder's `give_pre_end` (atol 1e-4; the position types are cases
    of `tests/test_torch_decoder.py`'s `test_positional_decoder`);
  * `VectorQuantizeEMA.get_soft_codes` (soft codes 1e-6, codes exact; the
    stochastic branch on its own: shape, support, seeding, the argmin as the
    temperature falls);
  * `activate_sos_for_fine_sequence=False`: teacher-forced losses of the
    unconditional and the class model (atol 1e-5), a stage-2 step on cached
    codes, and the sampler's raise, as JAX's.

JAX and the helpers shared with other port tests are imported inside the
tests.
"""
import copy
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.models.dqvae import DualGrainVQModel
from dynamicvectorquantization_torch.nn.blocks import ResnetBlock
from dynamicvectorquantization_torch.nn.decoder_positional import PositionalDecoder
from dynamicvectorquantization_torch.nn.discriminator import ActNorm, NLayerDiscriminator
from dynamicvectorquantization_torch.ops.vq import VectorQuantizeEMA
from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.weights import (
    discriminator_state_dict_from_flax,
    dqvae_state_dict_from_flax,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DQVAE_TINY = os.path.join(_REPO, "configs/smoke/dqvae-dual-entropy-tiny.yml")
STAGE2_TINY = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")
TOL = dict(atol=1e-5, rtol=1e-5)


def _nhwc(seed, shape, scale=1.0, shift=0.0):
    r = np.random.default_rng(seed)
    return (shift + scale * r.normal(size=shape)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _from_nchw(y):
    return y.permute(0, 2, 3, 1).detach().numpy()


# ------------------------------------------------------------------ ActNorm
def test_actnorm_discriminator_matches_jax():
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn.discriminator import NLayerDiscriminator as JDisc

    x, y = _nhwc(0, (2, 32, 32, 3)), _nhwc(1, (2, 32, 32, 3))
    jdisc = JDisc(input_nc=3, ndf=8, n_layers=2, use_actnorm=True)
    params = jax.device_get(jax.jit(jdisc.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    sd = discriminator_state_dict_from_flax(params, {})
    disc = NLayerDiscriminator(ndf=8, n_layers=2, use_actnorm=True)
    affine = (".loc", ".scale", ".initialized")
    assert sum(k.endswith(affine) for k in sd) == 6
    missing = disc.load_state_dict({k: v for k, v in sd.items() if not k.endswith(affine)},
                                   strict=False).missing_keys
    assert sorted(missing) == sorted(k for k in sd if k.endswith(affine))
    assert not disc.actnorm_initialized()
    disc.init_actnorm(_nchw(x))  # each ActNorm from its own input, as flax's init
    assert disc.actnorm_initialized()
    for k, v in sd.items():
        if k.endswith((".loc", ".scale")):
            np.testing.assert_allclose(disc.state_dict()[k].numpy(), v.numpy(), err_msg=k, **TOL)
    for train in (False, True):
        ref = jax.jit(jdisc.apply, static_argnames="train")({"params": params}, jnp.asarray(y),
                                                            train=train)
        with torch.no_grad():
            out = _from_nchw(disc(_nchw(y), train=train))
        np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_actnorm_reverse_and_logdet_match_jax():
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn.discriminator import ActNorm as JActNorm

    x, y = _nhwc(2, (2, 5, 5, 4), 3.0, 1.0), _nhwc(3, (2, 5, 5, 4))
    jact = JActNorm(logdet=True)
    variables = jax.device_get(jact.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    h_ref, logdet_ref = jact.apply(variables, jnp.asarray(y))
    back_ref = jact.apply(variables, jnp.asarray(y), reverse=True)
    act = ActNorm(4, logdet=True)
    act.initialize(_nchw(x))
    for name in ("loc", "scale"):
        np.testing.assert_allclose(getattr(act, name).detach().numpy().reshape(-1),
                                   variables["params"][name], **TOL)
    with torch.no_grad():
        h, logdet = act(_nchw(y))
        back = act(_nchw(y), reverse=True)
    np.testing.assert_allclose(_from_nchw(h), np.asarray(h_ref), **TOL)
    np.testing.assert_allclose(logdet.numpy(), np.asarray(logdet_ref), **TOL)
    np.testing.assert_allclose(_from_nchw(back), np.asarray(back_ref), **TOL)


def _actnorm_stage1_config():
    from tests.test_torch_stage1_train import _config

    cfg = _config()
    cfg["lossconfig"]["params"]["disc_config"]["params"]["use_actnorm"] = True
    return cfg


def test_stage1_trainer_sets_actnorm_from_its_sample_batch():
    from tests.test_torch_stage1_train import _images

    trainer = Stage1Trainer(DualGrainVQModel(**_actnorm_stage1_config()), 1e-3, device="cpu")
    disc = trainer.loss.discriminator
    x0 = _images(0)[:1]
    trainer.init_state(torch.Generator().manual_seed(0), x0)
    outs = []
    hooks = [m.register_forward_hook(lambda m, i, o: outs.append(o)) for m in disc.main
             if isinstance(m, ActNorm)]
    with torch.no_grad():
        disc(_nchw(x0))
    for h in hooks:
        h.remove()
    assert len(outs) == 2
    for o in outs:  # every channel of the sample at mean 0, std 1 (std / (std + 1e-6))
        flat = o.transpose(0, 1).reshape(o.shape[1], -1)
        np.testing.assert_allclose(flat.mean(dim=1).numpy(), 0.0, atol=1e-5)
        np.testing.assert_allclose(flat.std(dim=1).numpy(), 1.0, atol=1e-3)
    logs = trainer.train_step(_images(1), torch.Generator().manual_seed(1))
    assert all(np.isfinite(float(v)) for v in logs.values())
    # the state dict carries them: a fresh trainer takes them over and keeps them
    state = copy.deepcopy(trainer.state_dict())
    other = Stage1Trainer(DualGrainVQModel(**_actnorm_stage1_config()), 1e-3, device="cpu")
    other.load_state_dict(state)
    other.init_state()  # weights kept: ActNorm already set
    for k, v in state["model"].items():
        if k.startswith("loss.discriminator."):
            assert torch.equal(other.model.state_dict()[k], v), k
    # without a sample, one zero image, as the JAX trainer's init
    trainer.init_state(torch.Generator().manual_seed(0))
    zeros = NLayerDiscriminator(ndf=8, n_layers=2, use_actnorm=True)
    zeros.load_state_dict(disc.state_dict())
    zeros.init_actnorm(torch.zeros(1, 3, 32, 32))
    for (k, v), w in zip(disc.state_dict().items(), zeros.state_dict().values()):
        assert torch.equal(v, w), k


def test_loop_sets_actnorm_from_the_first_training_image(tmp_path, monkeypatch):
    from dynamicvectorquantization_torch.train import cli

    seen = []
    init_state = Stage1Trainer.init_state

    def recording(self, generator=None, sample_batch=None, **kwargs):
        seen.append(np.array(sample_batch))
        return init_state(self, generator, sample_batch, **kwargs)

    monkeypatch.setattr(Stage1Trainer, "init_state", recording)
    trainer = cli.main(["--base", DQVAE_TINY, "--device", "cpu", "--logdir", str(tmp_path),
                        "--train", "False", "--max_steps_per_epoch", "1",
                        "model.params.lossconfig.params.disc_config.params.use_actnorm=true"])
    data = instantiate_from_config(load_config([DQVAE_TINY])["data"])
    first = next(iter(data.train_dataloader(seed=23).epoch(0)))["image"][:1]
    assert len(seen) == 1 and seen[0].shape == (1, 64, 64, 3)
    np.testing.assert_array_equal(seen[0], np.asarray(first))
    assert trainer.loss.discriminator.actnorm_initialized()


# --------------------------------------------------------- disc_conditional
def test_conditional_discriminator_losses_match_jax():
    import jax
    import jax.numpy as jnp

    # The JAX loss imports its LPIPS module in `setup`, here inside `jax.jit(init)`; that
    # module's constants are jnp arrays, which a first import inside a trace leaves as
    # tracers for every later test of the process. Import it outside the trace.
    import dynamicvectorquantization_tpu.nn.lpips  # noqa: F401
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from tests.test_torch_stage1_loss import LOSS_CONFIG, _perturbed

    cfg = copy.deepcopy(LOSS_CONFIG)
    cfg["params"]["disc_conditional"] = True
    cfg["params"]["perceptual_weight"] = 0.0  # the condition reaches the discriminator alone
    cfg["params"]["disc_config"]["params"]["input_nc"] = 4  # the image and a 1-channel map
    x, y, c = _nhwc(4, (2, 32, 32, 3)), _nhwc(5, (2, 32, 32, 3)), _nhwc(6, (2, 32, 32, 1))
    jx, jy, jc = jnp.asarray(x), jnp.asarray(y), jnp.asarray(c)
    jloss = jinst(cfg)
    variables = jax.device_get(jax.jit(jloss.init)({"params": jax.random.PRNGKey(0)}, jx, jx,
                                                   jc))
    params = dict(variables["params"])
    assert "perceptual_loss" not in params
    params["discriminator"] = _perturbed(params["discriminator"], 10)
    stats = variables["batch_stats"]
    jvars = {"params": params, "batch_stats": stats}
    tloss = instantiate_from_config(cfg)
    tloss.discriminator.load_state_dict(discriminator_state_dict_from_flax(
        params["discriminator"], stats["discriminator"]), strict=True)
    saved = copy.deepcopy(tloss.state_dict())
    tx, ty, tc = (torch.from_numpy(a) for a in (x, y, c))

    @jax.jit
    def reference(jvars):
        return (jloss.apply(jvars, jy, jc, train=False, method="g_loss"),
                jloss.apply(jvars, jx, jy, jc, method="nll_and_g"),
                jloss.apply(jvars, jx, jy, 3, jc, train=True, method="d_loss",
                            mutable=["batch_stats"]))

    g_ref, (nll_ref, gg_ref), ((d_ref, log_ref), mut) = jax.device_get(reference(jvars))
    with torch.no_grad():
        np.testing.assert_allclose(float(tloss.g_loss(ty, tc)), float(g_ref), **TOL)
        nll, gg = tloss.nll_and_g(tx, ty, tc)
        np.testing.assert_allclose([float(nll), float(gg)], [float(nll_ref), float(gg_ref)],
                                   **TOL)
        assert float(gg) != float(tloss.g_loss(ty, torch.zeros_like(tc)))  # cond reaches it
        d, log = tloss.d_loss(tx, ty, 3, tc, train=True)
    np.testing.assert_allclose(float(d), float(d_ref), **TOL)
    for k in log_ref:
        np.testing.assert_allclose(float(log[k]), float(log_ref[k]), err_msg=k, **TOL)
    after = discriminator_state_dict_from_flax(params["discriminator"],
                                               mut["batch_stats"]["discriminator"])
    for k, v in after.items():
        if "running" in k:
            np.testing.assert_allclose(tloss.discriminator.state_dict()[k].numpy(), v.numpy(),
                                       atol=1e-6, rtol=1e-6, err_msg=k)
    tloss.load_state_dict(saved)


# ------------------------------------------------------- ResnetBlock dropout
class _Recorded:
    """Masks read out of a JAX forward, handed to the port's blocks in the
    order they first ask (the two towers call their blocks in JAX's order;
    the shapes are checked)."""

    def __init__(self, masks):
        self.masks = masks
        self.of = {}

    def keep(self, block, shape, device):
        if block not in self.of:
            self.of[block] = torch.from_numpy(np.array(self.masks[len(self.of)])).permute(
                0, 3, 1, 2)
        assert self.of[block].shape == shape
        return self.of[block]


def test_resnet_block_dropout_matches_jax_masks():
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import convert_dqvae_state_dict
    from tests.test_torch_encoder import _images

    cfg = load_config([DQVAE_TINY])["model"]
    cfg["params"]["lossconfig"] = None
    for tower in ("encoderconfig", "decoderconfig"):
        cfg["params"][tower]["params"]["dropout"] = 0.1
    # the port's seeded weights, carried to JAX by its converter
    tm = instantiate_from_config(cfg)
    tm.init_weights(torch.Generator().manual_seed(0))
    r = np.random.default_rng(5)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(torch.from_numpy(r.normal(0.0, 0.05, tuple(p.shape)).astype(np.float32)))
        cb = tm.quantize.codebook.weight
        cb[:-1] = torch.from_numpy((0.5 * r.normal(size=tuple(cb[:-1].shape))).astype(np.float32))
    jvars = convert_dqvae_state_dict({k: v.numpy() for k, v in tm.state_dict().items()})
    jm = jinst(cfg)
    x = _images(6)

    @jax.jit
    def forward_and_masks(variables, x):
        masks = []

        def read_masks(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.Dropout):
                masks.append(out != 0)
            return out

        rngs = {name: jax.random.PRNGKey(i) for i, name in enumerate(("dropout", "vq"))}
        with fnn.intercept_methods(read_masks):
            (rec, *_), _ = jm.net.apply(variables, x, train=True, rngs=rngs, mutable=["ema"])
        return rec, masks

    ref, masks = jax.device_get(forward_and_masks(jvars, jnp.asarray(x)))
    blocks = sum(isinstance(m, ResnetBlock) for m in tm.modules())
    assert len(masks) == blocks and 0.05 < 1 - np.mean([m.mean() for m in masks]) < 0.15
    recorded = _Recorded(masks)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), train=True, commit=False, dropout=recorded)[0]
        plain = tm(torch.from_numpy(x))[0]
    assert len(recorded.of) == blocks
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    assert float((out - plain).abs().max()) > 1e-2  # the masks reach the output
    # the seeded masks: a function of the seed and the block, the same on a rerun
    with torch.no_grad():
        a, b = (tm(torch.from_numpy(x), train=True, commit=False,
                   generator=torch.Generator().manual_seed(3))[0] for _ in range(2))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):  # a training forward with dropout needs its masks
        tm.decode(torch.zeros(1, 8, 8, 32), train=True)


# --------------------------------------------------------------- give_pre_end
def test_decoder_give_pre_end_matches_jax():
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn import decoder_positional as jd
    from dynamicvectorquantization_tpu.utils.torch_ckpt import convert_dqvae_state_dict

    cfg = dict(load_config([STAGE2_TINY])["model"]["params"]["first_stage_config"]["params"]
               ["decoderconfig"]["params"], give_pre_end=True)
    tmod = PositionalDecoder(**cfg)
    r = np.random.default_rng(7)
    with torch.no_grad():
        for name, p in tmod.named_parameters():
            one = float("norm" in name and name.endswith("weight"))
            p.copy_(torch.from_numpy((one + 0.05 * r.normal(size=tuple(p.shape)))
                                     .astype(np.float32)))
    # the JAX module has no norm_out / conv_out with give_pre_end; the port keeps the
    # reference's (unused) parameters
    params = convert_dqvae_state_dict({f"decoder.{k}": v.numpy()
                                       for k, v in tmod.state_dict().items()
                                       if not k.startswith(("norm_out", "conv_out"))})
    jmod = jd.PositionalDecoder(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in cfg.items()})
    x = _nhwc(7, (2, 8, 8, cfg["in_ch"]))
    ref = jax.jit(jmod.apply)({"params": params["params"]["decoder"]}, jnp.asarray(x))
    with torch.no_grad():
        out = _from_nchw(tmod(_nchw(x)))
    assert out.shape == (2, 64, 64, cfg["ch"] * cfg["ch_mult"][0])
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=0)


# ------------------------------------------------------------- soft codes
def test_soft_codes_match_jax():
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.vq import VectorQuantizeEMA as JVQ

    x = _nhwc(8, (2, 4, 4, 8), 0.3)
    jvq = JVQ(codebook_size=16, codebook_dim=8, use_pallas=False)
    variables = jax.device_get(jvq.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x)))
    codebook = _nhwc(9, (17, 8), 0.3)
    codebook[16] = 0.0
    variables = {"ema": {**variables["ema"], "codebook": codebook}}
    tvq = VectorQuantizeEMA(codebook_size=16, codebook_dim=8)
    tvq.codebook.weight.copy_(torch.from_numpy(codebook))
    for temp in (1.0, 0.05):
        soft_ref, code_ref = jvq.apply(variables, jnp.asarray(x), temp=temp,
                                       method="get_soft_codes")
        soft, code = tvq.get_soft_codes(torch.from_numpy(x), temp=temp)
        assert soft.shape == (2, 4, 4, 16) and code.shape == (2, 4, 4)
        np.testing.assert_allclose(soft.numpy(), np.asarray(soft_ref), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(code.numpy(), np.asarray(code_ref))


def test_stochastic_soft_codes():
    tvq = VectorQuantizeEMA(codebook_size=16, codebook_dim=8)
    tvq.codebook.weight[:16].copy_(torch.from_numpy(_nhwc(10, (16, 8), 0.3)))
    x = torch.from_numpy(_nhwc(11, (4, 8, 8, 8), 0.3))
    with pytest.raises(ValueError):
        tvq.get_soft_codes(x, stochastic=True)
    draws = [tvq.get_soft_codes(x, temp=1.0, stochastic=True,
                                generator=torch.Generator().manual_seed(s))[1] for s in (0, 0, 1)]
    assert draws[0].shape == (4, 8, 8) and draws[0].dtype == torch.int64
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < 16
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    greedy = tvq.get_soft_codes(x)[1]
    assert not torch.equal(draws[0], greedy)  # at temp 1 the draw spreads over the codes
    cold = tvq.get_soft_codes(x, temp=1e-4, stochastic=True,
                              generator=torch.Generator().manual_seed(2))[1]
    assert torch.equal(cold, greedy)


# ------------------------------------------- fine sequence without its sos
def _stage2_configs(kind):
    """(the port's model config, the JAX package's) of the tiny stage-2 yml,
    or its class version, with `activate_sos_for_fine_sequence=False`."""
    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload_config

    out = []
    for loader in (load_config, jload_config):
        cfg = loader([STAGE2_TINY])
        if kind == "class":
            from tests.test_torch_class_cond import class_config

            cfg = class_config(cfg)
        cfg["model"]["params"]["activate_sos_for_fine_sequence"] = False
        out.append(cfg["model"])
    return out


@pytest.mark.parametrize("kind", ["uncond", "class"])
def test_fine_sequence_without_sos_matches_jax(kind):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import (
        convert_dqvae_state_dict,
        convert_stackgpt_state_dict,
    )
    from tests.test_torch_encoder import _images

    cfg, jcfg = _stage2_configs(kind)
    model = instantiate_from_config(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    r = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.transformer.parameters():
            p.add_(torch.from_numpy(r.normal(0.0, 0.05, tuple(p.shape)).astype(np.float32)))
        cb = model.first_stage_model.quantize.codebook.weight
        cb[:-1] = torch.from_numpy((0.5 * r.normal(size=tuple(cb[:-1].shape))).astype(np.float32))
    model.eval()
    _, z = model.encode_to_z(torch.from_numpy(_images(1, b=4)))
    labels = torch.tensor([3, 7, 0, 9]) if kind == "class" else None
    with torch.no_grad():
        losses = model.forward_tokens(z, labels)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    fs = {k[len("first_stage_model."):]: v for k, v in sd.items()
          if k.startswith("first_stage_model.")}
    fs["quantize.codebook.cluster_size_ema"] = np.zeros(fs["quantize.codebook.weight"].shape[0] - 1,
                                                       np.float32)
    fs["quantize.codebook.embed_ema"] = fs["quantize.codebook.weight"][:-1]
    jmodel = jinst(jcfg)
    jvars = {"transformer": convert_stackgpt_state_dict(sd, prefix="transformer."),
             "first_stage": convert_dqvae_state_dict(fs)}
    jz = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in z.items()}
    ref = jmodel.forward_tokens(jvars, jz, jz if labels is None else jnp.asarray(labels.numpy()))
    for key in ("content_loss", "position_loss", "coarse_position_loss", "fine_position_loss"):
        np.testing.assert_allclose(float(losses[key]), float(ref[key]), atol=1e-5, rtol=0,
                                   err_msg=key)
    with_sos = copy.deepcopy(model)
    with_sos.activate_sos_for_fine_sequence = True
    with torch.no_grad():  # the prefix token makes another loss
        assert float(with_sos.forward_tokens(z, labels)["fine_position_loss"]) != \
            float(losses["fine_position_loss"])
    trainer = Stage2Trainer(model, 1e-3, warmup_steps=0, max_steps=10, device="cpu")
    logs = trainer.train_step({k: v.to(torch.int16) for k, v in z.items()},
                              torch.Generator().manual_seed(0), c=labels)
    assert all(np.isfinite(float(v)) for v in logs.values())
    c = model.encode_to_c(4 if labels is None else labels, "cpu")
    with pytest.raises(NotImplementedError, match="activate_sos_for_fine_sequence=True"):
        model.sample_from_scratch(*c)
    jc = jmodel.encode_to_c(jz["coarse_content"] if labels is None
                            else jnp.asarray(labels.numpy()))
    with pytest.raises(NotImplementedError, match="activate_sos_for_fine_sequence=True"):
        jmodel.sample_from_scratch(jvars["transformer"], *jc, jax.random.PRNGKey(0))
