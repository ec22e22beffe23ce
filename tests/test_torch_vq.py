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
    # bf16 rows and codebooks are searched as their f32 casts; float16 raises
    x16, cb16 = x[:, :28].to(torch.bfloat16), cb[:, :28].to(torch.bfloat16)
    before = nearest_codes.launches
    idx, xq = nearest_codes(x16, cb16)
    torch.cuda.synchronize()
    assert nearest_codes.launches == before + 1
    ref, ref_xq = nearest_codes_plain(x16, cb16)
    assert torch.equal(idx, ref) and torch.equal(xq, ref_xq)
    with pytest.raises(TypeError):
        nearest_codes(x[:, :28].half(), cb[:, :28].half())


def _fma_codes(x, cb):
    """The FMA search (`csrc/vq_nearest.cu`), whose order the tensor-core
    search rescores near-tie rows in, through its own C entry."""
    from dynamicvectorquantization_torch.ops import cuda_lib

    n, d = x.shape
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    err = cuda_lib.lib().dqvq_vq_nearest_fma(
        x.data_ptr(), cb.data_ptr(), (cb * cb).sum(1).data_ptr(), idx.data_ptr(), None, n,
        cb.shape[0], d, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, "dqvq_vq_nearest_fma")
    return idx.long()


def _adversarial(name, n, k, d, device):
    g = torch.Generator(device=device).manual_seed(5)
    cb = torch.randn((k, d), generator=g, device=device)
    x = torch.randn((n, d), generator=g, device=device)
    if name == "duplicate_codes":
        cb[1::2] = cb[0::2][: k // 2].clone()
    elif name == "codes_one_ulp_apart":
        cb[1::2] = torch.nextafter(cb[0::2][: k // 2], torch.full_like(cb[1::2], 1e30))
    elif name == "rows_equidistant_from_two_codes":
        pair = torch.randint(0, k // 2, (n,), generator=g, device=device) * 2
        x = 0.5 * (cb[pair] + cb[pair + 1])
    elif name == "init_codebook":
        cb = (torch.rand((k, d), generator=g, device=device) * 2 - 1) / k
    elif name == "one_code_owns_every_row":
        x = cb[3:4] + 0.01 * torch.randn((n, d), generator=g, device=device)
    return x.contiguous(), cb.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(300, 100, 36), (2048, 1024, 256)])
@pytest.mark.parametrize("name", ["duplicate_codes", "codes_one_ulp_apart",
                                  "rows_equidistant_from_two_codes", "init_codebook",
                                  "one_code_owns_every_row"])
def test_cuda_adversarial_sets_equal_the_fma_kernel(cuda_device, name, n, k, d):
    x, cb = _adversarial(name, n, k, d, cuda_device)
    before = nearest_codes.launches
    idx, xq = nearest_codes(x, cb)
    again, _ = nearest_codes(x, cb)
    assert nearest_codes.launches == before + 2
    assert torch.equal(idx, _fma_codes(x, cb))  # bit for bit, ties to the lowest index
    assert torch.equal(idx, again)
    assert torch.equal(xq, cb[idx])
    if name in ("duplicate_codes", "rows_equidistant_from_two_codes"):
        assert int(nearest_codes.last_rescored) > n // 2  # ties take the exact rescore


@pytest.mark.cuda
def test_cuda_search_limits(cuda_device):
    from dynamicvectorquantization_torch.ops.vq import MAX_DIM

    x, cb = (torch.from_numpy(a).to(cuda_device) for a in _x_cb(6, 64, 16, MAX_DIM + 4))
    with pytest.raises(ValueError):
        nearest_codes(x, cb)  # D past the search's shared memory
    x, cb = x[:, :MAX_DIM].contiguous(), cb[:, :MAX_DIM].contiguous()
    idx, _ = nearest_codes(x, cb)  # the largest D it takes
    assert torch.equal(idx, _fma_codes(x, cb))
