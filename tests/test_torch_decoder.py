"""DQ-VAE decode half in the PyTorch port against the JAX package, block by
block and whole: the same weights (JAX init, perturbed from a numpy seed,
converted to torch names), the same NHWC inputs, f32, atol 1e-4.
"""
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.nn import blocks, fourier
from dynamicvectorquantization_torch.nn.decoder_positional import PositionalDecoder
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.weights import _flatten, _leaf, dqvae_state_dict_from_flax
from tests.test_torch_stackgpt import perturbed


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _nhwc(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _to_torch(x):  # NHWC numpy -> NCHW tensor
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _from_torch(y):  # NCHW tensor -> NHWC numpy
    return y.permute(0, 2, 3, 1).detach().numpy()


def _block_state_dict(params):
    """Flax block params -> torch names (GroupNorm_0 level dropped)."""
    sd = {}
    for path, v in _flatten(params).items():
        tleaf, tv = _leaf(path[-1], v)
        mods = [m for m in path[:-1] if m != "GroupNorm_0"]
        sd[".".join(mods + [tleaf])] = torch.from_numpy(np.ascontiguousarray(tv))
    return sd


def _jax_init(module, x, seed=0):
    import jax

    params = module.init(jax.random.PRNGKey(seed), x)["params"]
    return perturbed(jax.device_get(params), np.random.default_rng(seed + 10), 0.05)


def _check(jmod, tmod, x, params, sd):
    import jax.numpy as jnp

    tmod.load_state_dict(sd)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = _from_torch(tmod(_to_torch(x)))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 16)])
def test_resnet_block(cin, cout):
    from dynamicvectorquantization_tpu.nn import blocks as jb

    x = _nhwc(0, (2, 8, 8, cin))
    jmod = jb.ResnetBlock(in_channels=cin, out_channels=cout)
    params = _jax_init(jmod, x)
    _check(jmod, blocks.ResnetBlock(cin, cout), x, params, _block_state_dict(params))


def test_attn_block():
    from dynamicvectorquantization_tpu.nn import blocks as jb

    x = _nhwc(1, (2, 8, 8, 32))
    jmod = jb.AttnBlock(32)
    params = _jax_init(jmod, x)
    _check(jmod, blocks.AttnBlock(32), x, params, _block_state_dict(params))


def test_upsample():
    from dynamicvectorquantization_tpu.nn import blocks as jb

    x = _nhwc(2, (2, 4, 4, 16))
    jmod = jb.Upsample(16)
    params = _jax_init(jmod, x)
    _check(jmod, blocks.Upsample(16), x, params, _block_state_dict(params))


def test_fourier_and_learned_position_embeddings():
    from dynamicvectorquantization_tpu.nn import fourier as jf

    x = _nhwc(3, (2, 8, 8, 32))
    jmod = jf.FourierPositionEmbedding(8, 32)
    params = _jax_init(jmod, x)
    sd = {f"lff.ffm.conv.{k.split('.')[-1]}": v
          for k, v in _block_state_dict(params).items()}
    _check(jmod, fourier.FourierPositionEmbedding(8, 32), x, params, sd)

    jmod = jf.PositionEmbedding2DLearned(8, 32)
    params = _jax_init(jmod, x)
    _check(jmod, fourier.PositionEmbedding2DLearned(8, 32), x, params,
           _block_state_dict(params))


@pytest.mark.parametrize("position_type", ["fourier+learned", "none"])
def test_positional_decoder(position_type):
    from dynamicvectorquantization_tpu.nn import decoder_positional as jd

    cfg = dict(load_config([TINY])["model"]["params"]["first_stage_config"]["params"]
               ["decoderconfig"]["params"], position_type=position_type)
    x = _nhwc(4, (2, 8, 8, cfg["in_ch"]))
    jmod = jd.PositionalDecoder(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in cfg.items()})
    params = _jax_init(jmod, x)
    sd = {k[len("decoder."):]: v
          for k, v in dqvae_state_dict_from_flax({"params": {"decoder": params}}).items()}
    _check(jmod, PositionalDecoder(**cfg), x, params, sd)


def test_codebook_entry_and_decode():
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import convert_dqvae_state_dict

    # weights travel port -> JAX here (the other direction is covered above
    # and in test_torch_weights.py); the JAX DQ-VAE is never initialised
    cfg = load_config([TINY])["model"]["params"]["first_stage_config"]
    tvq = instantiate_from_config(cfg)
    tvq.init_weights(torch.Generator().manual_seed(0))
    k = cfg["params"]["vqconfig"]["params"]["codebook_size"]
    sd = {name: v.numpy() for name, v in tvq.state_dict().items()}
    # the JAX quantizer also declares its EMA statistics; decode never reads them
    sd["quantize.codebook.cluster_size_ema"] = np.zeros(k, np.float32)
    sd["quantize.codebook.embed_ema"] = sd["quantize.codebook.weight"][:-1]
    jvars = convert_dqvae_state_dict(sd)
    jvq = jinst(cfg)

    codes = np.random.default_rng(6).integers(0, k + 1, (2, 8, 8))
    codes[0, 0, :3] = k  # the padding code, whose row is zero
    jq = np.asarray(jvq.get_code_emb_with_depth(jvars, jnp.asarray(codes, jnp.int32)))
    with torch.no_grad():
        tq = tvq.get_code_emb_with_depth(torch.from_numpy(codes))
        np.testing.assert_array_equal(tq.numpy(), jq)
        assert not tq[0, 0, :3].any()
        img = tvq.decode(tq).numpy()
    ref = np.asarray(jvq.decode(jvars, jnp.asarray(jq)))
    assert img.shape == ref.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(img, ref, atol=ATOL, rtol=0)
