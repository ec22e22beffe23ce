"""int8 KV cache in the PyTorch port (`dynamicvectorquantization_torch/ops/
kv_int8.py`) against the JAX package's `ops/kv_int8.py`: the quantizer
bit for bit, the plain decode attention against `_decode_attention_int8_ref`
(f32, atol 1e-5), and, on a CUDA card, the CUDA kernel against the plain
version.

JAX is imported inside the tests, so the CUDA cases also run where only
PyTorch is installed: `python -m pytest --noconftest -m cuda tests/test_torch_*.py`.
"""
import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.ops.kv_int8 import (
    CHUNK,
    decode_attention_int8,
    decode_attention_int8_plain,
    quantize_kv,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, b, h, t, hd):
    r = np.random.default_rng(seed)
    k = (r.normal(size=(b, h, t, hd)) * 2.0).astype(np.float32)
    v = r.normal(size=(b, h, t, hd)).astype(np.float32)
    q = r.normal(size=(b, h, 1, hd)).astype(np.float32)
    return q, k, v


def test_quantize_kv_matches_jax():
    from dynamicvectorquantization_tpu.ops import kv_int8 as jkv

    r = np.random.default_rng(0)
    x = (r.normal(size=(2, 3, 40, 16)) * 4.0).astype(np.float32)
    x[0, 0, 0] = 0.0  # all-zero row: the eps floor
    x[1, 2, 3, :4] = [0.5, -0.5, 1.5, 127.0]  # exact halves: round half to even
    qj, sj = jkv.quantize_kv(x)
    qt, st = quantize_kv(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-7, atol=0)


@pytest.mark.parametrize("n_valid", [1, CHUNK, CHUNK + 1, CHUNK + 37, 2 * CHUNK])
def test_plain_decode_attention_matches_jax_ref(n_valid):
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops import kv_int8 as jkv

    q, k, v = _inputs(1, 2, 3, 2 * CHUNK, 32)
    kq, ks = jkv.quantize_kv(k)
    vq, vs = jkv.quantize_kv(v)
    ref = jkv._decode_attention_int8_ref(jnp.asarray(q), kq, vq, ks, vs, jnp.int32(n_valid - 1))
    out = decode_attention_int8_plain(
        torch.from_numpy(q), *(torch.from_numpy(np.array(a)) for a in (kq, vq, ks, vs)),
        n_valid - 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_wrapper_takes_plain_path_for_cpu_tensors():
    q, k, v = _inputs(2, 1, 2, CHUNK, 16)
    kq, ks = quantize_kv(torch.from_numpy(k))
    vq, vs = quantize_kv(torch.from_numpy(v))
    before = decode_attention_int8.launches
    out = decode_attention_int8(torch.from_numpy(q), kq, vq, ks, vs, 100)
    ref = decode_attention_int8_plain(torch.from_numpy(q), kq, vq, ks, vs, 100)
    assert torch.equal(out, ref)
    assert decode_attention_int8.launches == before  # no kernel launch on the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 128])
def test_cuda_kernel_matches_plain(cuda_device, dtype, hd):
    q, k, v = _inputs(3, 2, 3, 2 * CHUNK, hd)
    q = torch.from_numpy(q).to(cuda_device, dtype)
    kq, ks = quantize_kv(torch.from_numpy(k).to(cuda_device))
    vq, vs = quantize_kv(torch.from_numpy(v).to(cuda_device))
    atol = 1e-5 if dtype == torch.float32 else 1.6e-2  # bf16: one output rounding
    for idx in (0, CHUNK - 1, CHUNK, 2 * CHUNK - 1):
        before = decode_attention_int8.launches
        out = decode_attention_int8(q, kq, vq, ks, vs, idx)
        torch.cuda.synchronize()
        assert decode_attention_int8.launches == before + 1
        ref = decode_attention_int8_plain(q, kq, vq, ks, vs, idx)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    q, k, v = _inputs(4, 1, 2, CHUNK, 16)
    q = torch.from_numpy(q).to(cuda_device)
    kq, ks = quantize_kv(torch.from_numpy(k).to(cuda_device))
    vq, vs = quantize_kv(torch.from_numpy(v).to(cuda_device))
    with pytest.raises(ValueError):
        decode_attention_int8(q, kq, vq, ks, vs, CHUNK)  # past the cache
    with pytest.raises(ValueError):
        decode_attention_int8(q.cpu(), kq, vq, ks, vs, 0)  # mixed devices
    with pytest.raises(TypeError):
        decode_attention_int8(q.half(), kq, vq, ks, vs, 0)
