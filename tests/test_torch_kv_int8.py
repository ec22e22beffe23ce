"""int8 KV cache in the PyTorch port (`dynamicvectorquantization_torch/ops/
kv_int8.py`) against the JAX package's `ops/kv_int8.py`: the quantizer
bit for bit, the plain decode attention against `_decode_attention_int8_ref`
(f32, atol 1e-5), with `cache_index` as an int or as an int32 tensor, and, on
a CUDA card, the CUDA kernel against the plain version (every head dim, both
dtypes, indices on and off the span edges, one key dominating the last span),
bit-reproducible, its device-index entry equal to its by-value entry.

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


@pytest.mark.parametrize("n_valid", [1, CHUNK, CHUNK + 1, CHUNK + 37, 2 * CHUNK])
def test_tensor_index_equals_int_index_and_jax_ref(n_valid):
    """`cache_index` as a 0-d or one-element int32 tensor gives the int form's
    output bit for bit, in the wrapper and the plain version, and both agree
    with the JAX package's `_decode_attention_int8_ref`."""
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops import kv_int8 as jkv

    q, k, v = _inputs(5, 2, 3, 2 * CHUNK, 32)
    kq, ks = jkv.quantize_kv(k)
    vq, vs = jkv.quantize_kv(v)
    ref = jkv._decode_attention_int8_ref(jnp.asarray(q), kq, vq, ks, vs, jnp.int32(n_valid - 1))
    args = (torch.from_numpy(q), *(torch.from_numpy(np.array(a)) for a in (kq, vq, ks, vs)))
    by_int = decode_attention_int8_plain(*args, n_valid - 1)
    for idx in (torch.tensor(n_valid - 1, dtype=torch.int32),
                torch.tensor([n_valid - 1], dtype=torch.int32)):
        for fn in (decode_attention_int8, decode_attention_int8_plain):
            assert torch.equal(fn(*args, idx), by_int)
    np.testing.assert_allclose(by_int.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_tensor_index_of_wrong_dtype_or_size_raises():
    q, k, v = _inputs(6, 1, 2, CHUNK, 16)
    kq, ks = quantize_kv(torch.from_numpy(k))
    vq, vs = quantize_kv(torch.from_numpy(v))
    q = torch.from_numpy(q)
    with pytest.raises(TypeError):
        decode_attention_int8(q, kq, vq, ks, vs, torch.tensor(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        decode_attention_int8(q, kq, vq, ks, vs, torch.tensor([3, 4], dtype=torch.int32))


def test_wrapper_takes_plain_path_for_cpu_tensors():
    q, k, v = _inputs(2, 1, 2, CHUNK, 16)
    kq, ks = quantize_kv(torch.from_numpy(k))
    vq, vs = quantize_kv(torch.from_numpy(v))
    before = decode_attention_int8.launches
    out = decode_attention_int8(torch.from_numpy(q), kq, vq, ks, vs, 100)
    ref = decode_attention_int8_plain(torch.from_numpy(q), kq, vq, ks, vs, 100)
    assert torch.equal(out, ref)
    assert decode_attention_int8.launches == before  # no kernel launch on the CPU


T_MAX = 6 * CHUNK  # holds the serving path's index 1283
INDICES = (0, 1, 63, 64, CHUNK - 1, CHUNK, CHUNK + 1, 1283, T_MAX - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_cuda_kernel_matches_plain(cuda_device, dtype, hd):
    """Every head dim and dtype at indices on and off the chunk edges; at
    1283 also with one key dominating the softmax, in the last chunk; on a
    second cache the indices round the kernel's switch to long chunks (each
    block of its cluster of 8 takes chunks of 4096 / hd positions, twice that
    once it would get more than three); each output bit-reproducible and
    equal to the device-index entry's."""
    q, k, v = _inputs(3, 2, 3, T_MAX, hd)
    q = torch.from_numpy(q).to(cuda_device, dtype)
    k = torch.from_numpy(k).to(cuda_device)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(torch.from_numpy(v).to(cuda_device))
    # the key at 1283 along q, 8x the keys' mean length: its weight is ~1 in every (b, h)
    kd = k.clone()
    qn = q[:, :, 0].float()
    kd[:, :, 1283] = 8.0 * k.norm(dim=-1).mean() * qn / qn.norm(dim=-1, keepdim=True)
    kdq, kds = quantize_kv(kd)
    switch = 3 * 8 * (4096 // hd)
    t2 = (switch // CHUNK + 2) * CHUNK
    q2, k2, v2 = _inputs(8, 1, 2, t2, hd)
    q2 = torch.from_numpy(q2).to(cuda_device, dtype)
    k2, k2s = quantize_kv(torch.from_numpy(k2).to(cuda_device))
    v2, v2s = quantize_kv(torch.from_numpy(v2).to(cuda_device))
    atol = 1e-5 if dtype == torch.float32 else 1.6e-2  # bf16: one output rounding
    cases = ([(idx, (q, kq, vq, ks, vs)) for idx in INDICES] + [(1283, (q, kdq, vq, kds, vs))]
             + [(idx, (q2, k2, v2, k2s, v2s)) for idx in (switch - 1, switch, t2 - 1)])
    for idx, args in cases:
        before = decode_attention_int8.launches
        out = decode_attention_int8(*args, idx)
        again = decode_attention_int8(*args, idx)
        on_device = decode_attention_int8(  # 0-d, and one-element on the second cache
            *args, torch.tensor([idx] if args[0] is q2 else idx, dtype=torch.int32,
                                device=cuda_device))
        torch.cuda.synchronize()
        assert decode_attention_int8.launches == before + 3
        ref = decode_attention_int8_plain(*args, idx)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
        assert torch.equal(out, again)  # no float atomics
        assert torch.equal(out, on_device)


@pytest.mark.cuda
def test_cuda_device_index_replays_in_a_cuda_graph(cuda_device):
    """The device-index launch, captured once, follows the index as it moves:
    each replay equals the by-value call at the new index bit for bit."""
    q, k, v = _inputs(7, 2, 3, T_MAX, 128)
    q = torch.from_numpy(q).to(cuda_device, torch.bfloat16)
    kq, ks = quantize_kv(torch.from_numpy(k).to(cuda_device))
    vq, vs = quantize_kv(torch.from_numpy(v).to(cuda_device))
    idx = torch.zeros((), dtype=torch.int32, device=cuda_device)
    decode_attention_int8(q, kq, vq, ks, vs, idx)  # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_int8(q, kq, vq, ks, vs, idx)
    for i in (0, 31, 255, 256, 1283, T_MAX - 1):
        idx.fill_(i)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, decode_attention_int8(q, kq, vq, ks, vs, i))


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
    with pytest.raises(TypeError):  # the device index must be int32
        decode_attention_int8(q, kq, vq, ks, vs, torch.tensor(0, device=cuda_device))
    with pytest.raises(ValueError):  # ... and on q's device
        decode_attention_int8(q, kq, vq, ks, vs, torch.tensor(0, dtype=torch.int32))
