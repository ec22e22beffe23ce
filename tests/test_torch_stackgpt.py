"""StackGPT decode in the PyTorch port against the JAX package: the same
weights (JAX init, perturbed from a numpy seed, converted by
`utils/weights.py`), the same teacher-forced token streams, 20 steps of
`embed_input_token` -> `position_step` -> `content_step`; position and
content logits must agree (f32; float caches atol 1e-5, int8 caches 1e-4).
"""
import os
from functools import partial

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.weights import stackgpt_state_dict_from_flax


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
STEPS = 20


def perturbed(tree, rng, std):
    """Replace every leaf by leaf + normal(0, std) noise (so zero-initialised
    tables such as `pos_emb` carry signal too)."""
    return {k: perturbed(v, rng, std) if isinstance(v, dict)
            else (np.asarray(v) + rng.normal(0.0, std, np.shape(v))).astype(np.float32)
            for k, v in tree.items()}


def transformer_config(kv_cache_dtype):
    cfg = load_config([TINY])["model"]["params"]["transformer_config"]
    cfg["params"]["kv_cache_dtype"] = kv_cache_dtype
    return cfg


@pytest.fixture(scope="module")
def flax_params():
    import jax

    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    z = lambda n: np.zeros((1, n), np.int32)  # noqa: E731
    params = jinst(transformer_config(None)).init(
        {"params": jax.random.PRNGKey(0)}, z(3), z(4), z(3), z(4), z(3), z(4) + 1)["params"]
    return perturbed(jax.device_get(params), np.random.default_rng(0), 0.05)


def _streams(p, b):
    r = np.random.default_rng(1)
    n = STEPS + 1
    return dict(
        content=r.integers(0, p["vocab_size"], (b, n)),
        coarse_pos=r.integers(0, p["coarse_position_size"], (b, n)),
        fine_pos=r.integers(0, p["fine_position_size"], (b, n)),
    )


@pytest.mark.parametrize("kv_cache_dtype,atol", [(None, 1e-5), ("int8", 1e-4)])
def test_decode_logits_match_jax(flax_params, kv_cache_dtype, atol):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    cfg = transformer_config(kv_cache_dtype)
    jgpt = jinst(cfg)
    tgpt = instantiate_from_config(cfg)
    tgpt.load_state_dict(stackgpt_state_dict_from_flax(flax_params))
    jvars = {"params": flax_params}
    b, lc = 2, 8  # steps < lc are coarse, the rest fine
    s = _streams(cfg["params"], b)

    embed = jax.jit(partial(jgpt.apply, method="embed_input_token"), static_argnums=5)
    pos_step = jax.jit(partial(jgpt.apply, method="position_step"))
    content_step = jax.jit(partial(jgpt.apply, method="content_step"), static_argnums=3)
    jpos, jcont = jgpt.apply(jvars, b, STEPS + 1, jnp.float32, method="make_caches")
    tpos, tcont = tgpt.make_caches(b, STEPS + 1, torch.float32, "cpu")
    for i in range(STEPS):
        fine, next_fine = i >= lc, i + 1 >= lc
        pos = s["fine_pos"] if fine else s["coarse_pos"]
        nxt = s["fine_pos"] if next_fine else s["coarse_pos"]
        seg = np.full((b,), int(fine))
        args = (s["content"][:, i], pos[:, i], seg)

        x = embed(jvars, *(jnp.asarray(a, jnp.int32) for a in args), jnp.int32(i), fine)
        hidden, jpl, jpos = pos_step(jvars, x, jpos, jnp.int32(i))
        jcl, jcont = content_step(jvars, hidden, jnp.asarray(nxt[:, i + 1], jnp.int32),
                                  next_fine, jcont, jnp.int32(i))

        with torch.no_grad():
            xt = tgpt.embed_input_token(*(torch.from_numpy(a).long() for a in args), i, fine)
            ht, tpl = tgpt.position_step(xt, tpos, i)
            tcl = tgpt.content_step(ht, torch.from_numpy(nxt[:, i + 1]).long(), next_fine,
                                    tcont, i)
        np.testing.assert_allclose(tpl.numpy(), np.asarray(jpl), atol=atol, rtol=0,
                                   err_msg=f"position logits, step {i}")
        np.testing.assert_allclose(tcl.numpy(), np.asarray(jcl), atol=atol, rtol=0,
                                   err_msg=f"content logits, step {i}")
