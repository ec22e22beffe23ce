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
    keys (EMA statistics, loss) loads; a file that lacks a key the model owns
    fails."""
    sd = _port_model().state_dict()
    extra = {"first_stage_model.quantize.codebook.cluster_size_ema": torch.zeros(3),
             "first_stage_model.loss.logvar": torch.zeros(1)}
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {**sd, **extra}, "epoch": 3}, path)
    _, loaded = load_model_and_variables(TINY, model_path=path, device="cpu")
    _assert_same({k: v.numpy() for k, v in loaded.items()}, {k: v.numpy() for k, v in sd.items()})

    del sd["transformer.pos_emb"]
    torch.save(sd, path)
    with pytest.raises(KeyError):
        load_model_and_variables(TINY, model_path=path, device="cpu")


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
        resolve_target("modules.dynamic_modules.EncoderTriple.TripleGrainEncoder")
