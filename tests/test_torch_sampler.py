"""The ported serving slice as a whole, against the JAX package at the tiny
stage-2 config: greedy `sample_from_scratch` must be token-exact with the
JAX sampler (float and int8 KV caches, both fine-position modes), the
decoded images must agree (f32, atol 1e-4), and `BatchingSampler` must
answer concurrent requests reproducibly.

Weights are made once in the port (seeded init, transformer perturbed from
a numpy seed so greedy choices are far from ties) and carried to the JAX
package by its own converters.
"""
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.serve import BatchingSampler
from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables


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
B = 3


@pytest.fixture(scope="module")
def state_dict():
    model, _ = load_model_and_variables(TINY, seed=0, device="cpu")
    r = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.transformer.parameters():
            p.add_(torch.from_numpy(r.normal(0.0, 0.1, tuple(p.shape)).astype(np.float32)))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _port(state_dict, kv_cache_dtype):
    model, _ = load_model_and_variables(TINY, device="cpu", kv_cache_dtype=kv_cache_dtype)
    model.load_state_dict(state_dict)
    return model


def _jax(state_dict, kv_cache_dtype):
    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload_config
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import (
        convert_dqvae_state_dict,
        convert_stackgpt_state_dict,
    )

    cfg = jload_config([TINY])
    cfg["model"]["params"]["transformer_config"]["params"]["kv_cache_dtype"] = kv_cache_dtype
    model = jinst(cfg["model"])
    sd = {k: v.numpy() for k, v in state_dict.items()}
    fs = {k[len("first_stage_model."):]: v for k, v in sd.items()
          if k.startswith("first_stage_model.")}
    fs["quantize.codebook.cluster_size_ema"] = np.zeros(fs["quantize.codebook.weight"].shape[0] - 1,
                                                       np.float32)
    fs["quantize.codebook.embed_ema"] = fs["quantize.codebook.weight"][:-1]
    variables = {"transformer": convert_stackgpt_state_dict(sd, prefix="transformer."),
                 "first_stage": convert_dqvae_state_dict(fs)}
    return model, variables


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_greedy_sampling_token_exact_and_images_match(state_dict, kv_cache_dtype):
    import jax
    import jax.numpy as jnp

    port = _port(state_dict, kv_cache_dtype)
    jmodel, jvars = _jax(state_dict, kv_cache_dtype)
    jc = jmodel.encode_to_c(jnp.zeros((B, 1)))
    for fix in (False, True):
        ref = jmodel.sample_from_scratch(jvars, *jc, rng=jax.random.PRNGKey(0), sample=False,
                                         fix_fine_position=fix)
        out = port.sample_from_scratch(*port.encode_to_c(B, "cpu"), sample=False,
                                       fix_fine_position=fix)
        for name, a, b in zip(("coarse_content", "fine_content", "coarse_position",
                               "fine_position"), out, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name} fix={fix}")
    # the sampled streams are not degenerate: several coarse and fine codes
    assert (np.asarray(ref[2]) < 16).sum() > B and (np.asarray(ref[3]) < 64).sum() > B

    img_ref = np.asarray(jmodel.decode_to_img(jvars, *ref))
    img = port.decode_to_img(*(torch.from_numpy(np.array(t)).long() for t in ref))
    assert img.shape == img_ref.shape == (B, 64, 64, 3)
    np.testing.assert_allclose(img.numpy(), img_ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.7), (10, 0.5)])
def test_sampling_filters_match_jax(top_k, top_p):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.models import sampling as js
    from dynamicvectorquantization_torch.models import sampling as ts

    logits = (np.random.default_rng(2).normal(size=(4, 50)) * 3).astype(np.float32)
    logits[0, :3] = logits[0].max() + 1.0  # a three-way tie at the top (kept by top-k)
    ref = js.top_p_probs(jax.nn.softmax(js.top_k_logits(jnp.asarray(logits), top_k)), top_p)
    probs = ts.top_p_probs(torch.softmax(ts.top_k_logits(torch.from_numpy(logits), top_k), -1),
                           top_p)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    greedy = ts.sample_from_logits(None, torch.from_numpy(logits), 1.0, top_k, top_p, False)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(js.sample_from_logits(
        jax.random.PRNGKey(0), jnp.asarray(logits), 1.0, top_k, top_p, False)))
    draws = ts.sample_from_logits(torch.Generator().manual_seed(0),
                                  torch.from_numpy(logits).repeat(64, 1), 1.0, top_k, top_p)
    assert (probs.repeat(64, 1).gather(1, draws[:, None]) > 0).all()  # only kept tokens


def _serve(model, requests):
    with BatchingSampler(model, max_batch=4, max_wait_ms=500.0, top_k=30,
                         top_k_pos=16) as engine:
        futures = [engine.submit(n, seed=s) for n, s in requests]
        outs = [f.result(timeout=300) for f in futures]
        return outs, engine.batches_run


def test_batching_sampler_concurrent_requests_reproducible(state_dict):
    model = _port(state_dict, "int8")
    requests = [(1, 11), (2, 12), (3, 13)]
    outs, batches = _serve(model, requests)
    assert [o.shape for o in outs] == [(n, 64, 64, 3) for n, _ in requests]
    assert all(np.isfinite(o).all() for o in outs)
    assert batches == 2  # (1 + 2) fill one batch; 3 does not fit beside them
    again, _ = _serve(model, requests)
    for a, b in zip(outs, again):
        np.testing.assert_array_equal(a, b)
    with BatchingSampler(model, max_batch=4) as engine:
        with pytest.raises(ValueError):
            engine.submit(5)
