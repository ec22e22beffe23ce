"""Fused attention in the PyTorch port (`dynamicvectorquantization_torch/
ops/attention.py`): the plain forward against the JAX package's Pallas
kernel `fused_causal_attention(..., interpret=True)` (f32, atol 2e-5), the
plain backward and the autograd Function against `jax.grad` of the same (dq,
dk, dv atol 5e-5), and, on a CUDA card, the CUDA kernels against the plain
versions.

JAX is imported inside the tests, so the CUDA cases also run where only
PyTorch is installed: `python -m pytest --noconftest -m cuda tests/test_torch_*.py`.
"""
import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.ops.attention import (
    fused_attention_backward,
    fused_attention_backward_plain,
    fused_attention_forward,
    fused_attention_forward_plain,
    fused_causal_attention,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, b, t, d):
    r = np.random.default_rng(seed)
    return [r.normal(size=(b, t, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t", [256, 300])
@pytest.mark.parametrize("n_head", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_pallas_interpret(t, n_head, causal):
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.attention_pallas import fused_causal_attention

    q, k, v = _qkv(0, 2, t, 128)
    ref = fused_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0, n_head,
                                 0.0, None, True, causal)
    out = fused_attention_forward(*(torch.from_numpy(a) for a in (q, k, v)), n_head,
                                  causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_dropout_waits_for_training_slice():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 16, 16))
    with pytest.raises(NotImplementedError):
        fused_attention_forward(q, k, v, 1, rate=0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fused_causal_attention(q, k, v, 1, rate=0.1)


@pytest.mark.parametrize("t", [256, 300])
@pytest.mark.parametrize("n_head", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_jax_grad_of_pallas_interpret(t, n_head, causal):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.attention_pallas import (
        fused_causal_attention as jax_attention,
    )

    q, k, v = _qkv(4, 2, t, 128)
    dy = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, 0, n_head, 0.0, None, True, causal),
                     *(jnp.asarray(a) for a in (q, k, v)))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dy))]

    tq, tk, tv, tdy = (torch.from_numpy(a) for a in (q, k, v, dy))
    y, lse = fused_attention_forward(tq, tk, tv, n_head, causal=causal, return_lse=True)
    assert lse.shape == (2, n_head, t) and lse.dtype == torch.float32
    for out, want in zip(fused_attention_backward_plain(tq, tk, tv, y, lse, tdy, n_head,
                                                        causal=causal), ref):
        np.testing.assert_allclose(out.numpy(), want, atol=5e-5, rtol=0)

    # the autograd Function, handed a non-contiguous dy
    leaves = [a.clone().requires_grad_() for a in (tq, tk, tv)]
    out = fused_causal_attention(*leaves, n_head, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), y.numpy(), atol=0, rtol=0)
    strided = tdy.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    for got, want in zip(torch.autograd.grad(out, leaves, strided), ref):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)


def test_backward_plain_equals_autograd_of_plain_forward():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(6, 2, 70, 64))
    dy = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 70, 64)).astype(np.float32))
    y, lse = fused_attention_forward_plain(q, k, v, 4, causal=True, return_lse=True)
    ref = torch.autograd.grad(y, (q, k, v), dy)
    with torch.no_grad():
        out = fused_attention_backward(q, k, v, y, lse, dy, 4, causal=True)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_attn_block_is_differentiable_and_matches_autograd_of_the_plain_forward():
    """The conv AttnBlock goes through `fused_causal_attention` (non-causal,
    one head of all channels): on the CPU its plain backward against
    autograd through the plain forward."""
    from dynamicvectorquantization_torch.nn import blocks

    torch.manual_seed(0)
    block = blocks.AttnBlock(32)
    x = torch.from_numpy(np.random.default_rng(12).normal(size=(2, 32, 6, 6)).astype(np.float32))
    x.requires_grad_()
    params = list(block.parameters())
    grads = torch.autograd.grad(block(x).square().sum(), [x, *params])

    def tokens(z):
        return z.flatten(2).transpose(1, 2).contiguous()

    h = block.norm(x)
    y = fused_attention_forward_plain(tokens(block.q(h)), tokens(block.k(h)), tokens(block.v(h)),
                                      1, 32 ** -0.5, False)
    out = x + block.proj_out(y.transpose(1, 2).reshape(2, 32, 6, 6))
    ref = torch.autograd.grad(out.square().sum(), [x, *params])
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        assert not block(x).requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n_head,causal", [
    ((2, 300, 256), 1, False),  # ragged last query/key tile
    ((2, 300, 256), 2, True),
    ((1, 128, 64), 4, True),  # hd = 16
    ((1, 200, 512), 2, False),  # hd = 256, as in the DQ-VAE decoder
    ((1, 200, 512), 1, False),  # hd = 512, as in the encoder's 16x16 AttnBlocks
])
def test_cuda_kernel_matches_plain(cuda_device, dtype, shape, n_head, causal):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype) for a in _qkv(2, *shape))
    before = fused_attention_forward.launches
    out = fused_attention_forward(q, k, v, n_head, causal=causal)
    torch.cuda.synchronize()
    assert fused_attention_forward.launches == before + 1
    ref = fused_attention_forward_plain(q, k, v, n_head, causal=causal)
    atol = 1e-5 if dtype == torch.float32 else 1.6e-2  # bf16: one output rounding
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n_head,causal", [
    ((2, 300, 256), 2, True),  # hd = 128, ragged last tiles
    ((2, 258, 256), 2, True),  # 257 + 1 tokens
    ((8, 805, 1024), 8, True),  # the p6c18 training shape
    ((2, 300, 64), 1, False),  # hd = 64, one non-causal head
    ((1, 128, 64), 4, True),  # hd = 16
    ((3, 70, 64), 2, True),  # hd = 32
    ((2, 1024, 256), 1, False),  # hd = 256: the DQ-VAE's 32x32 AttnBlocks (32-row tiles)
    ((2, 256, 512), 1, False),  # hd = 512: the encoder's 16x16 AttnBlocks (16-row tiles)
    ((2, 200, 512), 2, True),  # hd = 256, causal, ragged last tiles
    ((1, 77, 512), 1, True),  # hd = 512, causal, ragged last tiles
])
def test_cuda_backward_kernel_matches_plain(cuda_device, dtype, shape, n_head, causal):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype) for a in _qkv(8, *shape))
    dy = torch.from_numpy(np.random.default_rng(9).normal(size=shape).astype(np.float32)).to(
        cuda_device, dtype)
    y, lse = fused_attention_forward(q, k, v, n_head, causal=causal, return_lse=True)
    y_ref, lse_ref = fused_attention_forward_plain(q, k, v, n_head, causal=causal,
                                                   return_lse=True)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    before = fused_attention_backward.launches
    out = fused_attention_backward(q, k, v, y, lse, dy, n_head, causal=causal)
    torch.cuda.synchronize()
    assert fused_attention_backward.launches == before + 1
    ref = fused_attention_backward_plain(q, k, v, y_ref, lse_ref, dy, n_head, causal=causal)
    atol, rtol = (1e-4, 0) if dtype == torch.float32 else (2e-2, 2.0 ** -7)  # one bf16 ulp
    for a, b in zip(out, ref):
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)
    again = fused_attention_backward(q, k, v, y, lse, dy, n_head, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(out, again))  # no atomics


@pytest.mark.cuda
def test_cuda_autograd_function_runs_both_kernels(cuda_device):
    leaves = [torch.from_numpy(a).to(cuda_device).requires_grad_() for a in _qkv(10, 2, 300, 128)]
    dy = torch.from_numpy(_qkv(11, 2, 128, 300)[0]).to(cuda_device).transpose(1, 2)
    before = fused_attention_forward.launches, fused_attention_backward.launches
    grads = torch.autograd.grad(fused_causal_attention(*leaves, 2), leaves, dy)
    assert (fused_attention_forward.launches, fused_attention_backward.launches) == (
        before[0] + 1, before[1] + 1)
    ref = torch.autograd.grad(fused_attention_forward_plain(*leaves, 2, causal=True), leaves, dy)
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    # no gradient asked for: the forward alone, no log-sum-exp kept
    before = fused_attention_forward.launches, fused_attention_backward.launches
    with torch.no_grad():
        y = fused_causal_attention(*leaves, 2)
    assert not y.requires_grad
    assert (fused_attention_forward.launches, fused_attention_backward.launches) == (
        before[0] + 1, before[1])
    with pytest.raises(ValueError):  # hd = 1024 has no kernel
        wide = [torch.zeros((1, 64, 1024), device=cuda_device, requires_grad=True)
                for _ in range(3)]
        fused_causal_attention(*wide, 1).sum().backward()


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(3, 1, 64, 96))
    with pytest.raises(ValueError):
        fused_attention_forward(q, k, v, 1)  # hd = 96
    with pytest.raises(TypeError):
        fused_attention_forward(q.half(), k.half(), v.half(), 2)
    with pytest.raises(ValueError):
        fused_attention_forward(q[:, ::2], k[:, ::2], v[:, ::2], 2)  # not contiguous
