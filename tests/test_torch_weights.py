"""Weight conversion and config surface of the PyTorch port.

Port state_dict -> the JAX package's `convert_stackgpt_state_dict` /
`convert_dqvae_state_dict` -> the port's `utils/weights.py` must give back
the same arrays, and the flax trees in between must have exactly the paths
and shapes of the JAX modules' own init. The port's YAML subset parser must
read every shipped config as PyYAML does.
"""
import glob
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.registry import resolve_target
from dynamicvectorquantization_torch.config.yaml_config import load_config, load_yaml, parse_yaml
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables
from dynamicvectorquantization_torch.utils.weights import (
    dqvae_state_dict_from_flax,
    stackgpt_state_dict_from_flax,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")


def _port_model():
    model = instantiate_from_config(load_config([TINY])["model"])
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def _shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


def _assert_same(sd_a, sd_b):
    assert sorted(sd_a) == sorted(sd_b)
    for k in sd_a:
        np.testing.assert_array_equal(np.asarray(sd_a[k]), np.asarray(sd_b[k]), err_msg=k)


def test_stackgpt_roundtrip_through_jax_converter():
    import jax

    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import convert_stackgpt_state_dict

    gpt = _port_model().transformer
    sd = {k: v.numpy() for k, v in gpt.state_dict().items()}
    flax_params = convert_stackgpt_state_dict(sd, prefix="")
    _assert_same(stackgpt_state_dict_from_flax(flax_params), sd)

    cfg = load_config([TINY])["model"]["params"]["transformer_config"]
    jgpt = jinst(cfg)
    lc, lf = 3, 4
    z = lambda n: np.zeros((1, n), np.int32)  # noqa: E731
    jvars = jax.eval_shape(lambda: jgpt.init(
        {"params": jax.random.PRNGKey(0)}, z(lc), z(lf), z(lc), z(lf), z(lc), z(lf) + 1))
    assert _shapes(flax_params["params"]) == _shapes(jvars["params"])


def test_dqvae_decode_half_roundtrip_through_jax_converter():
    import jax

    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import convert_dqvae_state_dict

    vq = _port_model().first_stage_model
    sd = {k: v.numpy() for k, v in vq.state_dict().items()}
    flax_vars = convert_dqvae_state_dict(sd)
    _assert_same(dqvae_state_dict_from_flax(flax_vars), sd)

    cfg = load_config([TINY])["model"]["params"]["first_stage_config"]
    jvars = jax.eval_shape(lambda: jinst(cfg).init(jax.random.PRNGKey(0)))
    # the whole tree: encoder (router included), quant convs and decoder
    assert _shapes(flax_vars["params"]) == _shapes(jvars["params"])
    assert _shapes(flax_vars["ema"])[("quantize", "codebook")] == \
        tuple(jvars["ema"]["quantize"]["codebook"].shape)


def test_load_reference_style_checkpoint(tmp_path):
    """A Lightning-style `{"state_dict": ...}` file with the reference's extra
    keys (the GAN loss) loads; a file that lacks a key the model owns
    fails."""
    sd = _port_model().state_dict()
    extra = {"first_stage_model.loss.discriminator.main.0.bias": torch.zeros(3),
             "first_stage_model.loss.logvar": torch.zeros(1)}
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {**sd, **extra}, "epoch": 3}, path)
    _, loaded = load_model_and_variables(TINY, model_path=path, device="cpu")
    _assert_same({k: v.numpy() for k, v in loaded.items()}, {k: v.numpy() for k, v in sd.items()})

    del sd["transformer.pos_emb"]
    torch.save(sd, path)
    with pytest.raises(KeyError):
        load_model_and_variables(TINY, model_path=path, device="cpu")


def test_reference_named_ema_buffers_load_and_round_trip():
    """The quantizer's EMA statistics sit beside the codebook under the
    reference's names, so a reference-named DQ-VAE state_dict (the JAX
    package's export) loads them, and they come back through its converter."""
    import jax

    from dynamicvectorquantization_torch.utils.model_loading import load_into
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import (
        convert_dqvae_state_dict,
        export_dqvae_state_dict,
    )

    cfg = load_config([TINY])["model"]["params"]["first_stage_config"]
    jvars = jax.device_get(jinst(cfg).init(jax.random.PRNGKey(0)))
    r = np.random.default_rng(0)
    ema = dict(jvars["ema"]["quantize"])
    ema["cluster_size_ema"] = r.uniform(0, 3, size=ema["cluster_size_ema"].shape).astype(np.float32)
    ema["embed_ema"] = r.normal(size=ema["embed_ema"].shape).astype(np.float32)
    jvars = {"params": jvars["params"], "ema": {"quantize": ema}}
    ref = export_dqvae_state_dict(jvars)
    names = {f"quantize.codebook.{k}" for k in ("weight", "cluster_size_ema", "embed_ema")}
    assert names <= set(ref)

    vq = instantiate_from_config(cfg)
    assert names <= set(vq.state_dict())
    load_into(vq, {k: torch.from_numpy(np.array(v)) for k, v in ref.items()})
    np.testing.assert_array_equal(vq.quantize.codebook.cluster_size_ema.numpy(),
                                  ema["cluster_size_ema"])
    np.testing.assert_array_equal(vq.quantize.codebook.embed_ema.numpy(), ema["embed_ema"])
    assert set(vq.state_dict()) == set(ref) == set(dqvae_state_dict_from_flax(jvars))
    back = convert_dqvae_state_dict({k: v.numpy() for k, v in vq.state_dict().items()})
    for k, v in ema.items():
        np.testing.assert_array_equal(np.asarray(back["ema"]["quantize"][k]), np.asarray(v))
    with pytest.raises(KeyError):  # a file without the EMA statistics lacks keys the model owns
        load_into(vq, {k: torch.from_numpy(np.array(v)) for k, v in ref.items()
                       if not k.endswith("_ema")})


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(_REPO, "configs/*/*.yml"))))
def test_yaml_subset_reads_configs_like_pyyaml(path):
    import yaml

    with open(path) as f:
        assert load_yaml(path) == yaml.safe_load(f)


def test_yaml_subset_scalars_and_refusals():
    doc = parse_yaml("a:\n  b: 1.0e-05  # c\n  c: 1e-5\n  d: [1, 2]\n  e: ~\n  f: 'x: #y'\nz:\n")
    assert doc == {"a": {"b": 1e-05, "c": "1e-5", "d": [1, 2], "e": None, "f": "x: #y"},
                   "z": None}
    with pytest.raises(ValueError):
        parse_yaml("a:\n  - 1\n")


def test_unported_target_raises():
    assert resolve_target("modules.dynamic_modules.stackgpt.StackGPT").startswith(
        "dynamicvectorquantization_torch.")
    with pytest.raises(KeyError):
        resolve_target("modules.text_encoders.t5_text_encoder.T5TextEncoder")


def test_learned_relative_table_round_trips_through_jax_converter():
    """The window-sized `position_bias_learned` table of a `learned-relative`
    decoder: port -> the JAX package's converter -> the port, and the flax
    tree has the JAX decoder's own paths and shapes."""
    import jax

    from dynamicvectorquantization_torch.nn.decoder_positional import PositionalDecoder
    from dynamicvectorquantization_tpu.nn.decoder_positional import PositionalDecoder as JDecoder
    from dynamicvectorquantization_tpu.utils.torch_ckpt import convert_dqvae_state_dict

    cfg = dict(load_config([TINY])["model"]["params"]["first_stage_config"]["params"]
               ["decoderconfig"]["params"], position_type="learned-relative")
    dec = PositionalDecoder(**cfg)
    dec.position_bias_learned.init_weights(torch.Generator().manual_seed(0))
    assert tuple(dec.position_bias_learned.row_embed.weight.shape) == (cfg["window_size"],
                                                                       cfg["in_ch"])
    sd = {f"decoder.{k}": v.numpy() for k, v in dec.state_dict().items()}
    flax_vars = convert_dqvae_state_dict(sd)
    _assert_same(dqvae_state_dict_from_flax(flax_vars), sd)
    jdec = JDecoder(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()})
    x = np.zeros((1, cfg["latent_size"], cfg["latent_size"], cfg["in_ch"]), np.float32)
    jvars = jax.eval_shape(lambda: jdec.init(jax.random.PRNGKey(0), x))
    assert _shapes(flax_vars["params"]["decoder"]) == _shapes(jvars["params"])


def test_actnorm_loc_and_scale_round_trip():
    """An ActNorm discriminator's `loc` / `scale`, flax (C,) <-> port
    (1, C, 1, 1), both ways, with the JAX module's paths and shapes; the
    converted state dict marks them set."""
    import jax

    from dynamicvectorquantization_torch.nn.discriminator import NLayerDiscriminator
    from dynamicvectorquantization_torch.utils.weights import (
        discriminator_params_to_flax,
        discriminator_state_dict_from_flax,
    )
    from dynamicvectorquantization_tpu.nn.discriminator import NLayerDiscriminator as JDisc

    disc = NLayerDiscriminator(ndf=8, n_layers=2, use_actnorm=True)
    disc.init_weights(torch.Generator().manual_seed(0))
    disc.init_actnorm(torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1)))
    sd = disc.state_dict()
    tree = discriminator_params_to_flax(sd)
    jvars = jax.eval_shape(lambda: JDisc(ndf=8, n_layers=2, use_actnorm=True).init(
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32)))
    assert _shapes(tree) == _shapes(jvars["params"])
    back = discriminator_state_dict_from_flax(tree, {})
    _assert_same({k: v.numpy() for k, v in back.items()}, {k: v.numpy() for k, v in sd.items()})
    assert all(int(back[k]) == 1 for k in back if k.endswith("initialized"))
    again = discriminator_params_to_flax(back)
    for path, v in _shapes(tree).items():
        a, b = tree, again
        for p in path:
            a, b = a[p], b[p]
        np.testing.assert_array_equal(a, b, err_msg="/".join(path))
