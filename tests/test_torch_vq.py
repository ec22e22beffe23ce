"""Nearest-code vector quantization in the PyTorch port
(`dynamicvectorquantization_torch/ops/vq.py`): the plain version against the
JAX package's `nearest_codes` (XLA path, and its Pallas kernel in interpret
mode) with codes and quantized rows exact, the quantizer's inference forward
against `VectorQuantizeEMA` at atol 1e-5, and, on a CUDA card, the CUDA
kernel against the plain version.

JAX is imported inside the tests, so the CUDA cases also run where only
PyTorch is installed: `python -m pytest --noconftest -m cuda tests/test_torch_*.py`.
"""
import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.ops.vq import (
    VectorQuantizeEMA,
    nearest_codes,
    nearest_codes_plain,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _x_cb(seed, n, k, d):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, d)).astype(np.float32), r.normal(size=(k, d)).astype(np.float32))


@pytest.mark.parametrize("n,k,d", [(512, 64, 32), (300, 128, 256)])
def test_plain_matches_jax_xla(n, k, d):
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.vq_pallas import nearest_codes_xla

    x, cb = _x_cb(0, n, k, d)
    idx_ref, xq_ref = nearest_codes_xla(jnp.asarray(x), jnp.asarray(cb))
    idx, xq = nearest_codes(torch.from_numpy(x), torch.from_numpy(cb))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_ref))


def test_plain_matches_jax_pallas_interpret():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from dynamicvectorquantization_tpu.ops.vq_pallas import nearest_codes as jax_nearest

    x, cb = _x_cb(1, 1024, 128, 256)
    with pltpu.force_tpu_interpret_mode():
        idx_ref, xq_ref = jax_nearest(jnp.asarray(x), jnp.asarray(cb), use_pallas=True)
    idx, xq = nearest_codes_plain(torch.from_numpy(x), torch.from_numpy(cb))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_ref))


def test_ties_go_to_the_lowest_index():
    cb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    x = torch.tensor([[1.0, 1.0], [0.0, 2.0]])
    idx, _ = nearest_codes(x, cb)
    assert idx.tolist() == [0, 1]


@pytest.mark.parametrize("with_mask", [True, False])
def test_quantizer_forward_matches_jax(with_mask):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.vq import VectorQuantizeEMA as JaxVQ

    k, d = 64, 32
    r = np.random.default_rng(2)
    x = r.normal(size=(2, 8, 8, d)).astype(np.float32)
    mask = np.where(r.uniform(size=(2, 8, 8, 1)) < 0.5, 0.25, 1.0).astype(np.float32)
    jvq = JaxVQ(codebook_size=k, codebook_dim=d, use_pallas=False)
    variables = jvq.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    cb = r.normal(size=(k + 1, d)).astype(np.float32)
    cb[k] = 0.0
    variables = {"ema": {**variables["ema"], "codebook": jnp.asarray(cb)}}
    jmask = jnp.asarray(mask) if with_mask else None
    xq_ref, loss_ref, (_, _, code_ref) = jvq.apply(variables, jnp.asarray(x), jmask)

    tvq = VectorQuantizeEMA(codebook_size=k, codebook_dim=d, use_pallas=False)
    tvq.codebook.weight.copy_(torch.from_numpy(cb))
    tmask = torch.from_numpy(mask) if with_mask else None
    xq, loss, (_, _, code) = tvq(torch.from_numpy(x), tmask)
    np.testing.assert_array_equal(code.numpy(), np.asarray(code_ref))
    np.testing.assert_allclose(xq.numpy(), np.asarray(xq_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(loss.item(), float(loss_ref), atol=1e-5, rtol=0)
    # the training search quantizes with the codebook from before its update
    xq_t, loss_t, (_, _, code_t) = tvq(torch.from_numpy(x), tmask, train=True, commit=False)
    np.testing.assert_array_equal(code_t.numpy(), code.numpy())
    np.testing.assert_array_equal(xq_t.numpy(), xq.numpy())
    np.testing.assert_array_equal(tvq.codebook.weight.numpy(), cb)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(8192, 1024, 256), (300, 100, 32)])
def test_cuda_kernel_matches_plain(cuda_device, n, k, d):
    x, cb = (torch.from_numpy(a).to(cuda_device) for a in _x_cb(3, n, k, d))
    before = nearest_codes.launches
    idx, xq = nearest_codes(x, cb)
    torch.cuda.synchronize()
    assert nearest_codes.launches == before + 1
    ref, _ = nearest_codes_plain(x, cb)
    scores = (cb * cb).sum(1)[None] - 2.0 * x @ cb.t()
    rows = torch.arange(n, device=cuda_device)
    gap = (scores[rows, idx] - scores[rows, ref]).abs()
    # a differing code must be a near tie: f32 rounding of two D-long dots
    bound = 4 * d * 2.0 ** -24 * (x.norm(dim=1) * cb.norm(dim=1).max() + cb.norm(dim=1).max() ** 2)
    assert bool(((idx == ref) | (gap <= bound)).all())
    assert int((idx != ref).sum()) <= max(1, n // 1000)
    torch.testing.assert_close(xq, cb[idx], atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    x, cb = (torch.from_numpy(a).to(cuda_device) for a in _x_cb(4, 16, 8, 30))
    with pytest.raises(ValueError):
        nearest_codes(x, cb)  # D % 4 != 0
    with pytest.raises(TypeError):
        nearest_codes(x[:, :28].to(torch.bfloat16), cb[:, :28].to(torch.bfloat16))
