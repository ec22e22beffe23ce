"""Fused attention forward in the PyTorch port (`dynamicvectorquantization_
torch/ops/attention.py`): the plain version against the JAX package's
Pallas kernel `fused_causal_attention(..., interpret=True)` (f32, atol
2e-5), and, on a CUDA card, the CUDA kernel against the plain version.

JAX is imported inside the tests, so the CUDA cases also run where only
PyTorch is installed: `python -m pytest --noconftest -m cuda tests/test_torch_*.py`.
"""
import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.ops.attention import (
    fused_attention_forward,
    fused_attention_forward_plain,
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
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(3, 1, 64, 96))
    with pytest.raises(ValueError):
        fused_attention_forward(q, k, v, 1)  # hd = 96
    with pytest.raises(TypeError):
        fused_attention_forward(q.half(), k.half(), v.half(), 2)
    with pytest.raises(ValueError):
        fused_attention_forward(q[:, ::2], k[:, ::2], v[:, ::2], 2)  # not contiguous
