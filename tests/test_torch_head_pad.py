"""Head dimensions the attention kernels do not take, and the attention
decoder's dropout, against the JAX package (f32, CPU, tiny widths):

* a minGPT at hd 104 (taming's faces transformer's head: 1,664 over 16
  heads, here 208 over 2) forward, loss and gradients; on the card its
  attention is kernels #4 / #5 zero-padded per head to 128 with the real
  scale (`cuda` cases: the padded calls equal the plain versions at hd 104,
  with dropout, and the gradients cut back);
* a `MaskedSelfAttnBlock` at 640 channels (one head wider than any kernel's):
  the JAX module's einsum, chosen by shape;
* `AttnDecoder` dropout: at rate 0 in training the JAX module's output; at
  0.3 the draws come from the caller's generator (the same state, the same
  output; another, another) and drop about 30 % of the activations.

Tolerances: `tests/test_torch_legacy_modules.py`'s. JAX is imported inside
the tests.
"""
import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.ops.attention import (fused_attention_backward,
                                                           fused_attention_backward_plain,
                                                           fused_attention_forward,
                                                           fused_attention_forward_plain)

RTOL, ATOL = 1e-5, 2e-5
GRAD_REL = 1e-5
TOWER_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _port(cls, variables, **kw):
    from dynamicvectorquantization_torch.utils.weights import legacy_state_dict_from_flax

    module = cls(**kw)
    module.load_state_dict(legacy_state_dict_from_flax(variables), strict=True)
    return module.eval()


def test_gpt_at_head_dim_104_matches_jax():
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn.mingpt import GPT as J

    from dynamicvectorquantization_torch.nn.mingpt import GPT

    kw = dict(vocab_size=50, block_size=16, n_layer=2, n_head=2, n_embd=208)
    idx = np.random.default_rng(3).integers(0, 50, (2, 12)).astype(np.int32)
    jgpt = J(**kw)
    variables = jax.device_get(jgpt.init(jax.random.PRNGKey(0), jnp.asarray(idx)))
    gpt = _port(GPT, variables, **kw)

    def loss_fn(params):
        return jgpt.apply({**variables, "params": params}, jnp.asarray(idx),
                          targets=jnp.asarray(idx))[1]

    (jlogits, jloss) = jgpt.apply(variables, jnp.asarray(idx), targets=jnp.asarray(idx))
    jgrads = jax.grad(loss_fn)(variables["params"])
    logits, loss = gpt(torch.from_numpy(idx).long(), targets=torch.from_numpy(idx).long())
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL, atol=ATOL)
    loss.backward()
    from dynamicvectorquantization_torch.utils.weights import legacy_state_dict_from_flax

    ref = legacy_state_dict_from_flax({"params": jax.device_get(jgrads)})
    scale = max(float(v.abs().max()) for v in ref.values())
    for k, p in gpt.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(_np(g), _np(ref[k]), atol=GRAD_REL * scale, rtol=0,
                                   err_msg=f"d{k}")


def test_masked_self_attn_block_wider_than_512_matches_jax():
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn.attn_decoder import MaskedSelfAttnBlock as J

    from dynamicvectorquantization_torch.nn.attn_decoder import (KERNEL_MAX_CHANNELS,
                                                                 MaskedSelfAttnBlock)

    c = 640
    assert c > KERNEL_MAX_CHANNELS
    x = np.random.default_rng(61).normal(size=(2, 4, 4, c)).astype(np.float32)
    jblock = J(c)
    variables = jax.device_get(jblock.init(jax.random.PRNGKey(0), x))
    block = _port(MaskedSelfAttnBlock, variables, in_channels=c)
    ref = jblock.apply(variables, jnp.asarray(x))
    launches = fused_attention_forward.launches
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert fused_attention_forward.launches == launches  # no kernel, on any device


DECODER = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8,
               z_channels=4, token_n_layer=2, token_attn_type="bias-self-attn",
               resnet_kernel_size=3, fix_bug=True)


def test_attn_decoder_dropout_zero_in_training_matches_jax():
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn.attn_decoder import AttnDecoder as J

    from dynamicvectorquantization_torch.nn.attn_decoder import AttnDecoder

    z = np.random.default_rng(71).normal(size=(2, 4, 4, 4)).astype(np.float32)
    mask = np.random.default_rng(72).uniform(0.0, 1.0, (2, 16)).astype(np.float32)
    jdec = J(**DECODER)
    variables = jax.device_get(jdec.init(jax.random.PRNGKey(0), z, mask))
    ref = jdec.apply(variables, jnp.asarray(z), jnp.asarray(mask), deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(1)})
    dec = _port(AttnDecoder, variables, **DECODER).train()
    got = dec(torch.from_numpy(z).permute(0, 3, 1, 2), torch.from_numpy(mask),
              generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), np.asarray(ref), rtol=RTOL,
                               atol=TOWER_ATOL)


def test_attn_decoder_dropout_draws_from_the_generator():
    from dynamicvectorquantization_torch.nn.attn_decoder import AttnDecoder

    dec = AttnDecoder(**{**DECODER, "dropout": 0.3})
    dec.init_weights(torch.Generator().manual_seed(0))
    z = torch.from_numpy(np.random.default_rng(73).normal(size=(2, 4, 4, 4)).astype(np.float32))
    z = z.permute(0, 3, 1, 2)

    def run(seed, train=True):
        dec.train(train)
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return dec(z, generator=g)

    a, b, other = run(5), run(5), run(6)
    assert torch.equal(a, b) and not torch.equal(a, other)
    assert torch.equal(run(None, train=False), run(None, train=False))  # evaluation: no draw
    with pytest.raises(ValueError, match="Generator"):
        run(None)  # training with dropout needs the caller's generator
    # a block's keep share is 1 - rate
    from dynamicvectorquantization_torch.nn.blocks import DropoutMasks

    block = dec.mid.res_in
    keep = DropoutMasks(11).keep(block, (4096,), "cpu")
    assert block.dropout_key != 0 and abs(float(keep.float().mean()) - 0.7) < 0.03


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rate", [(torch.float32, 0.0), (torch.float32, 0.1),
                                        (torch.bfloat16, 0.1)], ids=["f32", "f32-r0.1", "bf16"])
def test_head_dim_104_pads_to_the_kernels_on_cuda(cuda, dtype, rate):
    """Forward (with lse) and backward at hd 104 through the kernels padded
    to hd 128 against the plain versions at hd 104, the same seed."""
    g = torch.Generator(device=cuda).manual_seed(104)
    b, t, n_head, seed = 2, 150, 2, 77
    q, k, v, dy = (torch.randn((b, t, n_head * 104), generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    padded = fused_attention_forward.padded_launches, fused_attention_backward.padded_launches
    y, lse = fused_attention_forward(q, k, v, n_head, None, True, rate, True, seed)
    grads = fused_attention_backward(q, k, v, y, lse, dy, n_head, rate=rate, seed=seed)
    assert (fused_attention_forward.padded_launches, fused_attention_backward.padded_launches) \
        == (padded[0] + 1, padded[1] + 1)
    cpu = [x.cpu() for x in (q, k, v, dy)]
    py, plse = fused_attention_forward_plain(*cpu[:3], n_head, None, True, True, rate, seed)
    pgrads = fused_attention_backward_plain(*cpu[:3], y.cpu(), lse.cpu(), cpu[3], n_head,
                                            rate=rate, seed=seed)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert y.shape == q.shape and all(gr.shape == q.shape for gr in grads)
    torch.testing.assert_close(y.cpu().float(), py.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse.cpu(), plse, atol=1e-4, rtol=0)
    for a, want in zip(grads, pgrads):
        torch.testing.assert_close(a.cpu().float(), want.float(), atol=5 * tol, rtol=0)
