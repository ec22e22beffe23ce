"""Fused attention in the PyTorch port (`dynamicvectorquantization_torch/
ops/attention.py`): the plain forward against the JAX package's Pallas
kernel `fused_causal_attention(..., interpret=True)` (f32, atol 2e-5), the
plain backward and the autograd Function against `jax.grad` of the same (dq,
dk, dv atol 5e-5), and, on a CUDA card, the CUDA kernels against the plain
versions (among them the register-blocked f32 backward at hd 256 / 512, its
outputs, reproducibility and dropout masks). Attention-probability dropout: the Philox4x32-10 generator against
the published known-answer vectors and an independent Python-int
implementation, the keep mask's statistics and layout, the plain forward and
backward at rate 0.1 / 0.5 against `jax.grad` of the TPU kernel's own math
written in `jnp` with the port's mask injected (atol 5e-5), and the JAX
package's own dropout-semantics test mirrored. The head offset (a
tensor-parallel rank's heads `head0 ..` of a model of `n_head_total`): the
plain mask and the plain forward and backward of a slice of the heads equal
the matching heads of the call over every head, bit for bit; on the card,
every family's entries with an offset (seed by value and on the device)
equal the slice of the full call.

JAX is imported inside the tests, so the CUDA cases also run where only
PyTorch is installed: `python -m pytest --noconftest -m cuda tests/test_torch_*.py`.
"""
import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.ops.attention import (
    attention_seed,
    dropout_keep_mask,
    dropout_threshold,
    fused_attention_backward,
    fused_attention_backward_plain,
    fused_attention_forward,
    fused_attention_forward_plain,
    fused_causal_attention,
    mix_seed,
    philox4x32_10,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# Philox4x32-10 known answers (Random123's kat_vectors): counter, key -> output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


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


def _philox_ints(ctr, key):
    """Philox4x32-10 in Python integers, written from the paper."""
    c, k = list(ctr), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
        k = [(k[0] + 0x9E3779B9) & 0xFFFFFFFF, (k[1] + 0xBB67AE85) & 0xFFFFFFFF]
    return tuple(c)


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answer_vectors(ctr, key, want):
    assert _philox_ints(ctr, key) == want
    out = philox4x32_10(tuple(torch.tensor(c, dtype=torch.int64) for c in ctr), key)
    assert tuple(int(w) for w in out) == want


def test_philox_tensor_version_equals_python_ints_on_random_counters():
    r = np.random.default_rng(0)
    ctr = r.integers(0, 2 ** 32, size=(4, 64), dtype=np.int64)
    ctr[:, :4] = [[0xFFFFFFFF] * 4, [0] * 4, [0xFFFF0000] * 4, [0x0000FFFF] * 4]  # limb edges
    key = (0xDEADBEEF, 0x01234567)
    out = philox4x32_10(tuple(torch.from_numpy(c) for c in ctr), key)
    for i in range(64):
        assert tuple(int(w[i]) for w in out) == _philox_ints(ctr[:, i].tolist(), key), i


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_mask_statistics_and_layout(rate):
    b, h, t = 2, 3, 301
    mask = dropout_keep_mask(77, b, h, t, rate)
    assert mask.shape == (b, h, t, t) and mask.dtype == torch.bool
    n = mask.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(mask.float().mean().item() - (1 - rate)) < 3 * sigma
    # element (b, h, row, col) is word col % 4 of counter (col // 4, row, b * H + h, 0)
    seed = 77
    thr = dropout_threshold(rate)
    assert thr == int(rate * 4294967295.0)
    for bi, hi, row, col in ((0, 0, 0, 0), (1, 2, 300, 299), (0, 1, 17, 130), (1, 0, 64, 63)):
        words = _philox_ints((col // 4, row, bi * h + hi, 0), (seed & 0xFFFFFFFF, seed >> 32))
        word = words[col % 4]
        assert bool(mask[bi, hi, row, col]) == (word >= thr)
    # a function of global coordinates: a shorter sequence is the corner of a longer one
    assert torch.equal(dropout_keep_mask(77, b, h, 70, rate), mask[:, :, :70, :70])
    assert not torch.equal(dropout_keep_mask(78, b, h, t, rate), mask)
    assert dropout_keep_mask(2 ** 63 + 5, 1, 1, 9, rate).shape == (1, 1, 9, 9)  # 64-bit seeds


@pytest.mark.parametrize("head0,n_local", [(0, 2), (2, 2), (6, 2), (1, 3)])
def test_dropout_keep_mask_with_a_head_offset_is_the_slice_of_the_full_mask(head0, n_local):
    full = dropout_keep_mask(99, 3, 8, 37, 0.25)
    part = dropout_keep_mask(99, 3, n_local, 37, 0.25, head0=head0, n_head_total=8)
    assert torch.equal(part, full[:, head0:head0 + n_local])
    # an offset of 0 over every head is the call without one
    assert torch.equal(dropout_keep_mask(99, 3, 8, 37, 0.25, head0=0, n_head_total=8), full)
    with pytest.raises(ValueError, match="do not lie"):
        dropout_keep_mask(99, 3, n_local, 37, 0.25, head0=8 - n_local + 1, n_head_total=8)


def _head_slice(x, head0, n, hd):
    return x[..., head0 * hd:(head0 + n) * hd].contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_attention_with_a_head_offset_equals_the_heads_of_the_full_call(dtype):
    b, t, n_head, hd, rate, seed = 2, 40, 4, 16, 0.3, 4321
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(40, b, t, n_head * hd))
    dy = torch.from_numpy(_qkv(41, b, t, n_head * hd)[0]).to(dtype)
    y, lse = fused_attention_forward(q, k, v, n_head, None, True, rate, True, seed)
    grads = fused_attention_backward(q, k, v, y, lse, dy, n_head, None, True, rate, seed)
    head0, n = 2, 2
    part = [_head_slice(z, head0, n, hd) for z in (q, k, v, y, dy)]
    y_p, lse_p = fused_attention_forward(*part[:3], n, None, True, rate, True, seed,
                                         head0=head0, n_head_total=n_head)
    assert torch.equal(y_p, part[3]) and torch.equal(lse_p, lse[:, head0:head0 + n])
    got = fused_attention_backward(*part[:3], y_p, lse_p, part[4], n, None, True, rate, seed,
                                   head0=head0, n_head_total=n_head)
    for g, full in zip(got, grads):
        assert torch.equal(g, _head_slice(full, head0, n, hd))
    # without the offset the slice draws rank 0's masks: another output
    y_0 = fused_attention_forward(*part[:3], n, None, True, rate, seed=seed)
    assert not torch.equal(y_0, y_p)


def test_seed_mix_is_a_fixed_function_of_its_integers():
    assert mix_seed(1, 2, 3) == mix_seed(1, 2, 3) and 0 <= mix_seed(1, 2, 3) < 2 ** 64
    seeds = {attention_seed(base, step, micro) for base in (0, 1) for step in range(4)
             for micro in range(3)}
    seeds |= {mix_seed(attention_seed(0, 0, 0), layer) for layer in range(24)}
    assert len(seeds) == 2 * 4 * 3 + 24
    assert attention_seed(5, 7) == attention_seed(5, 7, 0) != attention_seed(7, 5)


def _jnp_attention_with_mask(n_head, causal, rate, mask):
    """The TPU kernel's math (`_fwd_kernel`) in jnp with the keep mask given."""
    import jax
    import jax.numpy as jnp

    def fn(q, k, v):
        b, t, d = q.shape
        hd = d // n_head
        heads = lambda z: z.reshape(b, t, n_head, hd).transpose(0, 2, 1, 3)  # noqa: E731
        s = jnp.einsum("bhqd,bhkd->bhqk", heads(q), heads(k),
                       precision=jax.lax.Precision.HIGHEST) / np.sqrt(hd)
        if causal:
            s = jnp.where(jnp.tril(jnp.ones((t, t), bool)), s, -jnp.inf)
        p = jnp.exp(s - s.max(-1, keepdims=True))
        l = p.sum(-1, keepdims=True)
        p = jnp.where(mask, p / (1.0 - rate), 0.0)
        y = jnp.einsum("bhqk,bhkd->bhqd", p, heads(v), precision=jax.lax.Precision.HIGHEST) / l
        return y.transpose(0, 2, 1, 3).reshape(b, t, d)

    return fn


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_dropout_forward_and_backward_match_jax_grad_of_the_kernel_math(rate, causal):
    import jax
    import jax.numpy as jnp

    b, t, d, n_head, seed = 2, 300, 128, 2, 4242
    q, k, v = _qkv(20, b, t, d)
    dy = np.random.default_rng(21).normal(size=q.shape).astype(np.float32)
    mask = dropout_keep_mask(seed, b, n_head, t, rate)
    fn = _jnp_attention_with_mask(n_head, causal, rate, jnp.asarray(mask.numpy()))
    y_ref, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dy))]

    tq, tk, tv, tdy = (torch.from_numpy(a) for a in (q, k, v, dy))
    y, lse = fused_attention_forward(tq, tk, tv, n_head, causal=causal, rate=rate,
                                     return_lse=True, seed=seed)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=5e-5, rtol=0)
    # the log-sum-exp is of the undropped scores
    lse0 = fused_attention_forward(tq, tk, tv, n_head, causal=causal, return_lse=True)[1]
    assert torch.equal(lse, lse0)
    out = fused_attention_backward(tq, tk, tv, y, lse, tdy, n_head, causal=causal, rate=rate,
                                   seed=seed)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
    # the autograd Function carries rate and seed to its backward
    leaves = [a.clone().requires_grad_() for a in (tq, tk, tv)]
    yf = fused_causal_attention(*leaves, n_head, causal=causal, rate=rate, seed=seed)
    assert torch.equal(yf.detach(), y)
    for got, want in zip(torch.autograd.grad(yf, leaves, tdy), ref):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)


def test_dropout_semantics_mirror_the_jax_package():
    """The JAX package's `test_fused_attention_dropout_semantics` at its shape
    and rate 0.5: same seed equal, seeds differ, the mean over 40 seeds within
    0.15 (mean relative error) of the deterministic output, gradients finite."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 256, 128))
    run = lambda seed, rate=0.5: fused_attention_forward(  # noqa: E731
        q, k, v, 4, causal=True, rate=rate, seed=seed)
    y1 = run(123)
    assert torch.equal(y1, run(123))
    assert not torch.allclose(y1, run(124))
    det = fused_attention_forward(q, k, v, 4, causal=True)
    assert not torch.allclose(y1, det)
    mean = torch.stack([run(s) for s in range(40)]).mean(0)
    err = float((mean - det).abs().mean() / det.abs().mean())
    assert err < 0.15, err
    leaf = q.clone().requires_grad_()
    (g,) = torch.autograd.grad(
        fused_causal_attention(leaf, k, v, 4, causal=True, rate=0.1, seed=7).sum(), leaf)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def test_rate_zero_is_bit_equal_to_the_rate_free_call_and_reads_no_seed():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 70, 64))
    dy = torch.from_numpy(_qkv(4, 2, 70, 64)[0])
    y0, lse0 = fused_attention_forward_plain(q, k, v, 4, causal=True, return_lse=True)
    y, lse = fused_attention_forward(q, k, v, 4, causal=True, rate=0.0, return_lse=True, seed=9)
    assert torch.equal(y, y0) and torch.equal(lse, lse0)
    a = fused_attention_backward(q, k, v, y, lse, dy, 4, causal=True, rate=0.0, seed=9)
    b = fused_attention_backward_plain(q, k, v, y, lse, dy, 4, causal=True)
    assert all(torch.equal(x, z) for x, z in zip(a, b))


def test_dropout_needs_a_seed_and_a_rate_below_one():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 16, 16))
    with pytest.raises(ValueError, match="seed"):
        fused_attention_forward(q, k, v, 1, rate=0.1)
    with pytest.raises(ValueError, match="seed"):
        fused_causal_attention(q.requires_grad_(), k, v, 1, rate=0.1)
    with pytest.raises(ValueError):
        fused_attention_forward(q, k, v, 1, rate=1.0, seed=0)
    with pytest.raises(ValueError):
        dropout_keep_mask(0, 1, 1, 4, -0.1)


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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_head", [2, 4])
def test_backward_at_heads_of_32_and_16_matches_jax_grad_of_pallas_interpret(n_head, causal):
    """The square tiles' route, f32 at hd 32 / 16 (`chip_smoke.py` holds the
    kernel to the plain version at two heads of 32 over T = 300): the plain
    backward, fed the forward's lse, against the gradient of the JAX package's
    Pallas kernel in interpret mode."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.attention_pallas import (
        fused_causal_attention as jax_attention,
    )

    q, k, v = _qkv(6, 2, 300, 64)
    dy = np.random.default_rng(7).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, 0, n_head, 0.0, None, True, causal),
                     *(jnp.asarray(a) for a in (q, k, v)))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    tq, tk, tv, tdy = (torch.from_numpy(a) for a in (q, k, v, dy))
    y, lse = fused_attention_forward(tq, tk, tv, n_head, causal=causal, return_lse=True)
    for out, want in zip(fused_attention_backward_plain(tq, tk, tv, y, lse, tdy, n_head,
                                                        causal=causal), ref):
        np.testing.assert_allclose(out.numpy(), want, atol=5e-5, rtol=0)


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
    wide = torch.zeros((1, 64, 1024), device=cuda_device)
    with pytest.raises(ValueError):  # hd 1024: no kernel takes it, none to pad it to
        fused_attention_forward(wide, wide, wide, 1)
    with pytest.raises(TypeError):
        fused_attention_forward(q.half(), k.half(), v.half(), 2)
    with pytest.raises(ValueError):
        fused_attention_forward(q[:, ::2], k[:, ::2], v[:, ::2], 2)  # not contiguous


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("shape,n_head,causal,dtype", [
    ((2, 300, 64), 1, False, torch.float32),  # hd 64, partial tiles
    ((2, 805, 1024), 8, True, torch.float32),  # hd 128, T = 805
    ((8, 805, 1024), 8, True, torch.bfloat16),  # the p6c18 training shape
    ((2, 300, 512), 2, True, torch.float32),  # hd 256: 64-row forward, 32-row backward tiles
    ((2, 300, 512), 1, False, torch.float32),  # hd 512: 32-row forward, 16-row backward tiles
    ((1, 805, 256), 1, True, torch.float32),  # hd 256 at T = 805
])
def test_cuda_dropout_kernels_match_plain(cuda_device, rate, shape, n_head, causal, dtype):
    seed = 1234567890123
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype) for a in _qkv(30, *shape))
    dy = torch.from_numpy(_qkv(31, *shape)[0]).to(cuda_device, dtype)
    y, lse = fused_attention_forward(q, k, v, n_head, None, causal, rate, True, seed)
    y_ref, lse_ref = fused_attention_forward_plain(q, k, v, n_head, None, causal, True, rate, seed)
    atol, rtol = (1e-4, 0) if dtype == torch.float32 else (2e-2, 2.0 ** -7)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    out = fused_attention_backward(q, k, v, y, lse, dy, n_head, None, causal, rate, seed)
    ref = fused_attention_backward_plain(q, k, v, y_ref, lse_ref, dy, n_head, None, causal,
                                         rate, seed)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)
    again = fused_attention_backward(q, k, v, y, lse, dy, n_head, None, causal, rate, seed)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    y2 = fused_attention_forward(q, k, v, n_head, None, causal, rate, seed=seed + 1)
    assert not torch.equal(y2, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [
    (torch.float32, 16), (torch.float32, 128), (torch.float32, 256),  # square tiles, 3xTF32, wide
    (torch.bfloat16, 32), (torch.bfloat16, 128), (torch.bfloat16, 512),  # square, tc, tc wide
])
@pytest.mark.parametrize("device_seed", [False, True])
def test_cuda_head_offset_entries_equal_the_slice_of_the_full_call(cuda_device, dtype, hd,
                                                                    device_seed):
    """Every family, forward and backward, with dropout: heads 2 .. 3 of 4
    run alone with the offset give the full call's outputs of those heads
    bit for bit (log-sum-exp and dQ, dK, dV included)."""
    b, t, n_head, rate = 2, 200, 4, 0.2
    seed = 987654321
    if device_seed:
        seed = torch.tensor([seed], dtype=torch.int64, device=cuda_device)
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype) for a in _qkv(42, b, t, n_head * hd))
    dy = torch.from_numpy(_qkv(43, b, t, n_head * hd)[0]).to(cuda_device, dtype)
    y, lse = fused_attention_forward(q, k, v, n_head, None, True, rate, True, seed)
    grads = fused_attention_backward(q, k, v, y, lse, dy, n_head, None, True, rate, seed)
    head0, n = 2, 2
    part = [_head_slice(z, head0, n, hd) for z in (q, k, v, y, dy)]
    y_p, lse_p = fused_attention_forward(*part[:3], n, None, True, rate, True, seed,
                                         head0=head0, n_head_total=n_head)
    got = fused_attention_backward(*part[:3], part[3], lse[:, head0:head0 + n].contiguous(),
                                   part[4], n, None, True, rate, seed, head0=head0,
                                   n_head_total=n_head)
    torch.cuda.synchronize()
    assert torch.equal(y_p, part[3]) and torch.equal(lse_p, lse[:, head0:head0 + n])
    for g, full in zip(got, grads):
        assert torch.equal(g, _head_slice(full, head0, n, hd))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,t", [(64, 64), (128, 100), (256, 200), (512, 300)])
def test_cuda_kernel_mask_equals_dropout_keep_mask(cuda_device, hd, t):
    """Uniform probabilities and V rows that are unit vectors: output column
    c of row r is nonzero iff probability (r, c) was kept."""
    b, n_head, rate, seed = 2, 2, 0.3, 77
    q = torch.zeros((b, t, n_head * hd), device=cuda_device)
    mask = dropout_keep_mask(seed, b, n_head, t, rate, cuda_device)
    for c0 in range(0, t, hd):  # hd columns of the mask per probe
        v = torch.zeros((b, t, n_head, hd), device=cuda_device)
        n = min(hd, t - c0)
        v[:, c0 + torch.arange(n), :, torch.arange(n)] = 1.0
        y = fused_attention_forward(q, q, v.reshape(b, t, -1).contiguous(), n_head, None, False,
                                    rate, seed=seed)
        got = y.view(b, t, n_head, hd).transpose(1, 2)[..., :n] > 0
        assert torch.equal(got, mask[..., c0:c0 + n])


def _bf16_from(arrays):
    """numpy f32 arrays rounded to bf16, as torch tensors and as jnp arrays."""
    import jax.numpy as jnp

    tensors = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return tensors, [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in tensors]


@pytest.mark.parametrize("t", [256, 300])
@pytest.mark.parametrize("n_head", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_plain_matches_jax_pallas_interpret_in_bf16(t, n_head, causal):
    """The bf16 plain versions round where the TPU kernel rounds (P before P
    V; D and dS before their products). The forward agrees with the Pallas
    kernel run in bf16 to one bf16 ulp of the value (2^-7 relative, plus 2^-9
    absolute where one probability's rounding flips). The gradients agree to
    that plus 2^-6 absolute: each side is up to ~0.01 off the f32 result of
    the same bf16 inputs (dS = P (dP - delta) cancels before it is rounded to
    bf16 and summed over up to 300 keys; delta comes from the bf16 output
    here and from the f32 probabilities there), in its own places."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.attention_pallas import (
        fused_causal_attention as jax_attention,
    )

    arrays = _qkv(40, 2, t, 128) + [np.random.default_rng(41).normal(size=(2, t, 128))
                                     .astype(np.float32)]
    (tq, tk, tv, tdy), (jq, jk, jv, jdy) = _bf16_from(arrays)
    y_ref, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, 0, n_head, 0.0, None, True,
                                                       causal), jq, jk, jv)
    grads_ref = vjp(jdy)
    y, lse = fused_attention_forward(tq, tk, tv, n_head, causal=causal, return_lse=True)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_ref.astype(jnp.float32)),
                               atol=2.0 ** -9, rtol=2.0 ** -7)
    out = fused_attention_backward(tq, tk, tv, y, lse, tdy, n_head, causal=causal)
    for got, want in zip(out, grads_ref):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=2.0 ** -6, rtol=2.0 ** -7)


def test_f32_plain_is_untouched_by_the_bf16_roundings():
    """The f32 plain versions keep every probability in f32: their result
    differs from the same inputs' bf16 path (which rounds P, D and dS)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float() for a in _qkv(42, 1, 96, 128))
    dy = torch.from_numpy(_qkv(43, 1, 96, 128)[0])
    y32, lse32 = fused_attention_forward_plain(q, k, v, 2, causal=True, return_lse=True)
    s = torch.matmul(q.view(1, 96, 2, 64).transpose(1, 2),
                     k.view(1, 96, 2, 64).transpose(1, 2).transpose(-1, -2)) / 8.0
    s = torch.where(torch.ones(96, 96, dtype=torch.bool).tril(), s, float("-inf"))
    want = torch.matmul(torch.softmax(s, -1), v.view(1, 96, 2, 64).transpose(1, 2))
    torch.testing.assert_close(y32, want.transpose(1, 2).reshape(1, 96, 128), atol=2e-6, rtol=0)
    y16 = fused_attention_forward_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), 2,
                                        causal=True).float()
    assert not torch.equal(y16, y32.bfloat16().float())  # P rounded before P V
    g32 = fused_attention_backward_plain(q, k, v, y32, lse32, dy, 2, causal=True)
    torch.testing.assert_close(g32[2], torch.matmul(
        torch.softmax(s, -1).transpose(-1, -2), dy.view(1, 96, 2, 64).transpose(1, 2))
        .transpose(1, 2).reshape(1, 96, 128), atol=2e-6, rtol=0)


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_family_by_dtype_and_head_dim(dtype, hd):
    """The family a call takes is decided from dtype and head dim before any
    launch, so CPU tensors show it: bf16 at hd 64, 128, 256 and 512 -> the
    tensor cores; f32 at every head dim and bf16 at hd 16 / 32 -> the FMA
    units."""
    from dynamicvectorquantization_torch.ops.attention import _tensor_cores

    x = torch.zeros((2, 8, 2 * hd), dtype=dtype)
    assert x.data_ptr() % 16 == 0
    assert _tensor_cores((x, x, x), 2) == (dtype == torch.bfloat16 and hd >= 64)


def test_misaligned_bf16_at_hd_256_raises_instead_of_taking_the_fma_family():
    """No fallback: a bf16 tensor at a tensor-core head dim that does not
    start on a 16-byte boundary is refused, not sent to the FMA family."""
    from dynamicvectorquantization_torch.ops.attention import _tensor_cores

    aligned = torch.zeros((1, 8, 256), dtype=torch.bfloat16)
    misaligned = torch.zeros(1 + 8 * 256, dtype=torch.bfloat16)[1:].view(1, 8, 256)
    assert misaligned.data_ptr() % 16
    with pytest.raises(ValueError, match="hd 256 must start on a 16-byte boundary"):
        _tensor_cores((aligned, aligned, misaligned), 1)


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_f32_backward_by_dtype_and_head_dim(dtype, hd):
    """f32 at hd 256 / 512 -> the register-blocked backward
    (`csrc/fused_attention_bwd_wide.cu`, counted with the FMA family); no
    call is sent to both it and the tensor cores."""
    from dynamicvectorquantization_torch.ops.attention import _tensor_cores, _wide_f32

    x = torch.zeros((2, 8, 2 * hd), dtype=dtype)
    wide = _wide_f32((x, x, x), 2)
    assert wide == (dtype == torch.float32 and hd >= 256)
    assert not (wide and _tensor_cores((x, x, x), 2))


def test_misaligned_f32_at_hd_512_raises_instead_of_taking_another_kernel():
    """No fallback: an f32 tensor at hd 256 / 512 that does not start on a
    16-byte boundary is refused, not sent to the square-tile kernels."""
    from dynamicvectorquantization_torch.ops.attention import _wide_f32

    aligned = torch.zeros((1, 8, 512))
    misaligned = torch.zeros(1 + 8 * 512)[1:].view(1, 8, 512)
    assert misaligned.data_ptr() % 16
    with pytest.raises(ValueError, match="hd 512 must start on a 16-byte boundary"):
        _wide_f32((aligned, misaligned, aligned), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [64, 100, 300, 805])
@pytest.mark.parametrize("hd", [64, 128, 256, 512])
def test_cuda_tensor_core_family_matches_plain(cuda_device, hd, t, causal, rate):
    """bf16 at hd 64 / 128 / 256 / 512 runs on the tensor cores; it and the bf16 plain
    versions round at the same places and differ in the order of summation:
    one bf16 ulp of the value plus 2e-2, as every bf16 attention comparison.
    The backward is bit-reproducible (no atomics)."""
    b, n_head, seed = 2, 2, 987654321
    shape = (b, t, n_head * hd)
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16) for a in _qkv(50, *shape))
    dy = torch.from_numpy(_qkv(51, *shape)[0]).to(cuda_device, torch.bfloat16)
    before = (fused_attention_forward.tc_launches, fused_attention_backward.tc_launches)
    y, lse = fused_attention_forward(q, k, v, n_head, None, causal, rate, True, seed)
    out = fused_attention_backward(q, k, v, y, lse, dy, n_head, None, causal, rate, seed)
    again = fused_attention_backward(q, k, v, y, lse, dy, n_head, None, causal, rate, seed)
    torch.cuda.synchronize()
    assert (fused_attention_forward.tc_launches, fused_attention_backward.tc_launches) == (
        before[0] + 1, before[1] + 2)
    y_ref, lse_ref = fused_attention_forward_plain(q, k, v, n_head, None, causal, True, rate, seed)
    ref = fused_attention_backward_plain(q, k, v, y_ref, lse_ref, dy, n_head, None, causal, rate,
                                         seed)
    tol = dict(atol=2e-2, rtol=2.0 ** -7)
    torch.testing.assert_close(y.float(), y_ref.float(), **tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    for a, r in zip(out, ref):
        torch.testing.assert_close(a.float(), r.float(), **tol)
    assert all(torch.equal(a, r) for a, r in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,t", [(64, 300), (128, 805), (256, 300), (512, 300)])
def test_cuda_tensor_core_masks_equal_dropout_keep_mask(cuda_device, hd, t):
    """Uniform probabilities and unit-vector V rows (exact in bf16): output
    column c of row r is nonzero iff probability (r, c) was kept, and dV with
    dY = V's unit vectors shows the backward's mask transposed."""
    b, n_head, rate, seed = 2, 2, 0.3, 78
    q = torch.zeros((b, t, n_head * hd), device=cuda_device, dtype=torch.bfloat16)
    mask = dropout_keep_mask(seed, b, n_head, t, rate, cuda_device)
    before = fused_attention_forward.tc_launches
    for c0 in range(0, t, hd):
        n = min(hd, t - c0)
        v = torch.zeros((b, t, n_head, hd), device=cuda_device, dtype=torch.bfloat16)
        v[:, c0 + torch.arange(n), :, torch.arange(n)] = 1.0
        v = v.reshape(b, t, -1).contiguous()
        y, lse = fused_attention_forward(q, q, v, n_head, None, False, rate, True, seed)
        got = y.view(b, t, n_head, hd).transpose(1, 2)[..., :n] > 0
        assert torch.equal(got, mask[..., c0:c0 + n])
        _, _, dv = fused_attention_backward(q, q, v, y, lse, v, n_head, None, False, rate, seed)
        got = dv.view(b, t, n_head, hd).transpose(1, 2)[..., :n] > 0
        assert torch.equal(got, mask[..., c0:c0 + n, :].transpose(-1, -2))
    assert fused_attention_forward.tc_launches > before


@pytest.mark.cuda
def test_cuda_each_family_counts_only_its_own_shapes(cuda_device):
    """bf16 at hd 64, 128, 256, 512 -> tensor cores; f32 at any hd and bf16
    at hd 16, 32 -> FMA units, except f32 at hd 64 / 128, whose forward and
    backward run the 3xTF32 kernels (`f32_tc_launches`, in neither family)."""
    cases = [(torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
             (torch.float32, 64, False), (torch.float32, 128, False),
             (torch.bfloat16, 16, False), (torch.bfloat16, 32, False),
             (torch.bfloat16, 256, True), (torch.bfloat16, 512, True),
             (torch.float32, 256, False), (torch.float32, 512, False),
             (torch.float32, 16, False), (torch.float32, 32, False)]
    for dtype, hd, tc in cases:
        q, k, v, dy = (torch.randn((1, 70, 2 * hd), device=cuda_device).to(dtype)
                       for _ in range(4))
        f32tc = dtype == torch.float32 and hd in (64, 128)
        fwd = (fused_attention_forward.tc_launches, fused_attention_forward.fma_launches,
               fused_attention_forward.f32_tc_launches)
        bwd = (fused_attention_backward.tc_launches, fused_attention_backward.fma_launches,
               fused_attention_backward.f32_tc_launches)
        y, lse = fused_attention_forward(q, k, v, 2, causal=True, return_lse=True)
        fused_attention_backward(q, k, v, y, lse, dy, 2, causal=True)
        want = (0, 0, 1) if f32tc else (1, 0, 0) if tc else (0, 1, 0)
        assert (fused_attention_forward.tc_launches - fwd[0],
                fused_attention_forward.fma_launches - fwd[1],
                fused_attention_forward.f32_tc_launches - fwd[2]) == want, (dtype, hd)
        assert (fused_attention_backward.tc_launches - bwd[0],
                fused_attention_backward.fma_launches - bwd[1],
                fused_attention_backward.f32_tc_launches - bwd[2]) == want, (dtype, hd)
    misaligned = torch.zeros(1 + 70 * 128, device=cuda_device, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        fused_attention_forward(*(misaligned.view(1, 70, 128),) * 3, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd,t", [(256, 300), (256, 1024), (512, 300), (512, 256)])
def test_cuda_f32_wide_backward_matches_plain(cuda_device, hd, t, causal, rate):
    """f32 at hd 256 / 512 runs the register-blocked backward on the FMA units
    (`fma_launches`): within the f32 backward tolerance of the plain version
    (f32 sums in another order), and bit-reproducible (no atomics)."""
    b, n_head, seed = 2, 2 if hd == 256 else 1, 24680
    shape = (b, t, n_head * hd)
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(60, *shape))
    dy = torch.from_numpy(_qkv(61, *shape)[0]).to(cuda_device)
    y, lse = fused_attention_forward(q, k, v, n_head, None, causal, rate, True, seed)
    before = (fused_attention_backward.fma_launches, fused_attention_backward.tc_launches)
    out = fused_attention_backward(q, k, v, y, lse, dy, n_head, None, causal, rate, seed)
    again = fused_attention_backward(q, k, v, y, lse, dy, n_head, None, causal, rate, seed)
    torch.cuda.synchronize()
    assert (fused_attention_backward.fma_launches, fused_attention_backward.tc_launches) == (
        before[0] + 2, before[1])
    y_ref, lse_ref = fused_attention_forward_plain(q, k, v, n_head, None, causal, True, rate, seed)
    ref = fused_attention_backward_plain(q, k, v, y_ref, lse_ref, dy, n_head, None, causal, rate,
                                         seed)
    for a, r in zip(out, ref):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=0)
    assert all(torch.equal(a, r) for a, r in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,t", [(256, 300), (512, 300)])
def test_cuda_f32_wide_backward_masks_equal_dropout_keep_mask(cuda_device, hd, t):
    """Uniform probabilities and unit-vector rows as V and as dY: column c of
    dV's key row r is nonzero iff the probability (query c0 + c, key r) was
    kept, so dV shows the register-blocked backward's mask transposed."""
    b, n_head, rate, seed = 2, 2, 0.3, 79
    q = torch.zeros((b, t, n_head * hd), device=cuda_device)
    mask = dropout_keep_mask(seed, b, n_head, t, rate, cuda_device)
    before = fused_attention_backward.fma_launches
    for c0 in range(0, t, hd):
        n = min(hd, t - c0)
        v = torch.zeros((b, t, n_head, hd), device=cuda_device)
        v[:, c0 + torch.arange(n), :, torch.arange(n)] = 1.0
        v = v.reshape(b, t, -1).contiguous()
        y, lse = fused_attention_forward(q, q, v, n_head, None, False, rate, True, seed)
        _, _, dv = fused_attention_backward(q, q, v, y, lse, v, n_head, None, False, rate, seed)
        got = dv.view(b, t, n_head, hd).transpose(1, 2)[..., :n] > 0
        assert torch.equal(got, mask[..., c0:c0 + n, :].transpose(-1, -2))
    assert fused_attention_backward.fma_launches > before


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_by_dtype_and_head_dim(dtype, hd):
    """The forward picks its kernel by `_route`: bf16 at hd 64 - 512 -> the
    tensor cores; f32 at hd 256 / 512 -> the register-blocked f32 kernel; f32
    at hd 64 / 128 -> the 3xTF32 kernel (`csrc/fused_attention_f32_tc.cu`);
    the rest (f32 and bf16 at hd 16 / 32) -> the square tiles."""
    from dynamicvectorquantization_torch.ops.attention import _route

    x = torch.zeros((2, 8, 2 * hd), dtype=dtype)
    if dtype == torch.bfloat16 and hd >= 64:
        want = "tensor cores"
    elif dtype == torch.float32 and hd >= 256:
        want = "wide f32"
    elif dtype == torch.float32 and hd >= 64:
        want = "f32 tensor cores"
    else:
        want = "square tiles"
    assert _route((x, x, x, x), 2, "fused_attention_forward") == want


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_route_by_dtype_and_head_dim(dtype, hd):
    """The backward's `_route`: bf16 at hd 64 - 512 -> the tensor cores, f32
    at hd 256 / 512 -> the register-blocked backward, f32 at hd 64 / 128 ->
    the 3xTF32 backward (`csrc/fused_attention_bwd_f32_tc.cu`), the rest (f32
    and bf16 at hd 16 / 32) -> the square tiles."""
    from dynamicvectorquantization_torch.ops.attention import _route

    x = torch.zeros((2, 8, 2 * hd), dtype=dtype)
    if dtype == torch.bfloat16 and hd >= 64:
        want = "tensor cores"
    elif dtype == torch.float32 and hd >= 256:
        want = "wide f32"
    elif dtype == torch.float32 and hd >= 64:
        want = "f32 tensor cores"
    else:
        want = "square tiles"
    assert _route((x, x, x, x, x, x, x, x), 2, "fused_attention_backward") == want


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_and_backward_routes_agree(dtype, hd):
    """Every (dtype, head dim) runs its forward and its backward on the same
    kernel family: the backward of a forward is never left on another route."""
    from dynamicvectorquantization_torch.ops.attention import _route

    x = torch.zeros((2, 8, 2 * hd), dtype=dtype)
    assert _route((x,) * 4, 2, "fused_attention_forward") == _route(
        (x,) * 8, 2, "fused_attention_backward")


@pytest.mark.parametrize("hd", [64, 128])
def test_misaligned_f32_forward_at_hd_64_128_raises_instead_of_taking_the_square_tiles(hd):
    """No fallback: an f32 input or output at hd 64 / 128 off a 16-byte
    boundary is refused by the forward's route and by the backward's, each
    naming its own wrapper."""
    from dynamicvectorquantization_torch.ops.attention import _route

    aligned = torch.zeros((1, 8, 2 * hd))
    misaligned = torch.zeros(1 + 8 * 2 * hd)[1:].view(1, 8, 2 * hd)
    assert misaligned.data_ptr() % 16
    for name, n in (("fused_attention_forward", 4), ("fused_attention_backward", 8)):
        with pytest.raises(ValueError, match=f"{name}: f32 tensors at hd {hd} "
                                             "must start on a 16-byte boundary"):
            _route((aligned, misaligned) + (aligned,) * (n - 2), 2, name)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_at_two_heads_of_128_with_lse_and_dropout_matches_the_jax_kernel(causal):
    """The shape of the existing 1e-5 card test, 2 heads of 128 over T = 300:
    at rate 0 the plain forward against the JAX package's Pallas kernel in
    interpret mode (atol 2e-5) and its lse against the log-sum-exp of the
    same scaled scores in JAX (atol 1e-5); at rate 0.1 against the Pallas
    kernel's math with the port's keep mask (the Pallas kernel draws its mask
    from the TPU's generator, which the port does not reproduce; atol 5e-5),
    with the lse of the undropped scores."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.attention_pallas import fused_causal_attention as jfa

    b, t, d, n_head, rate, seed = 2, 300, 256, 2, 0.1, 97
    q, k, v = _qkv(40, b, t, d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = np.asarray(jfa(jq, jk, jv, 0, n_head, 0.0, None, True, causal))
    heads = lambda z: z.reshape(b, t, n_head, d // n_head).transpose(0, 2, 1, 3)  # noqa: E731
    s = jnp.einsum("bhqd,bhkd->bhqk", heads(jq), heads(jk),
                   precision=jax.lax.Precision.HIGHEST) / np.sqrt(d // n_head)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((t, t), bool)), s, -jnp.inf)
    lse_ref = np.asarray(jax.nn.logsumexp(s, axis=-1))

    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    y, lse = fused_attention_forward(tq, tk, tv, n_head, causal=causal, return_lse=True)
    np.testing.assert_allclose(y.numpy(), ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5, rtol=0)

    mask = dropout_keep_mask(seed, b, n_head, t, rate)
    fn = _jnp_attention_with_mask(n_head, causal, rate, jnp.asarray(mask.numpy()))
    yd, lsed = fused_attention_forward(tq, tk, tv, n_head, causal=causal, rate=rate,
                                       return_lse=True, seed=seed)
    np.testing.assert_allclose(yd.numpy(), np.asarray(fn(jq, jk, jv)), atol=5e-5, rtol=0)
    assert torch.equal(lsed, lse)


@pytest.mark.parametrize("hd", [256, 512])
def test_misaligned_f32_forward_output_raises_instead_of_taking_the_square_tiles(hd):
    """No fallback: the forward's f32 output (or any input) at hd 256 / 512 off
    a 16-byte boundary is refused, naming the forward."""
    from dynamicvectorquantization_torch.ops.attention import _route

    aligned = torch.zeros((1, 8, hd))
    misaligned = torch.zeros(1 + 8 * hd)[1:].view(1, 8, hd)
    assert misaligned.data_ptr() % 16
    with pytest.raises(ValueError, match=f"fused_attention_forward: f32 tensors at hd {hd} "
                                         "must start on a 16-byte boundary"):
        _route((aligned, aligned, aligned, misaligned), 1, "fused_attention_forward")


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [64, 100, 300, 1024])
@pytest.mark.parametrize("hd", [256, 512])
def test_cuda_f32_wide_forward_matches_plain(cuda_device, hd, t, causal, rate):
    """f32 at hd 256 / 512 runs the register-blocked forward
    (`wide_f32_launches`, counted in the FMA family): output and lse within
    the f32 forward tolerance of the plain version (f32 sums in another
    order), and bit-reproducible (no atomics)."""
    b, n_head, seed = 2, 2 if hd == 256 else 1, 13579
    shape = (b, t, n_head * hd)
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(62, *shape))
    before = (fused_attention_forward.wide_f32_launches, fused_attention_forward.fma_launches,
              fused_attention_forward.tc_launches)
    y, lse = fused_attention_forward(q, k, v, n_head, None, causal, rate, True, seed)
    y2, lse2 = fused_attention_forward(q, k, v, n_head, None, causal, rate, True, seed)
    torch.cuda.synchronize()
    assert (fused_attention_forward.wide_f32_launches, fused_attention_forward.fma_launches,
            fused_attention_forward.tc_launches) == (before[0] + 2, before[1] + 2, before[2])
    y_ref, lse_ref = fused_attention_forward_plain(q, k, v, n_head, None, causal, True, rate, seed)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    assert torch.equal(y, y2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,t", [(256, 300), (512, 300), (512, 64)])
def test_cuda_f32_wide_forward_masks_equal_dropout_keep_mask(cuda_device, hd, t):
    """Uniform probabilities and unit-vector V rows: output column c of row r
    of the register-blocked forward is nonzero iff probability (r, c) was
    kept."""
    b, n_head, rate, seed = 2, 2, 0.3, 81
    q = torch.zeros((b, t, n_head * hd), device=cuda_device)
    mask = dropout_keep_mask(seed, b, n_head, t, rate, cuda_device)
    before = fused_attention_forward.wide_f32_launches
    for c0 in range(0, t, hd):
        n = min(hd, t - c0)
        v = torch.zeros((b, t, n_head, hd), device=cuda_device)
        v[:, c0 + torch.arange(n), :, torch.arange(n)] = 1.0
        y = fused_attention_forward(q, q, v.reshape(b, t, -1).contiguous(), n_head, None, False,
                                    rate, seed=seed)
        got = y.view(b, t, n_head, hd).transpose(1, 2)[..., :n] > 0
        assert torch.equal(got, mask[..., c0:c0 + n])
    assert fused_attention_forward.wide_f32_launches == before + -(-t // hd)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,t,rate", [(256, 1024, 0.0), (512, 256, 0.1)])
def test_cuda_autograd_through_the_wide_f32_forward_and_backward(cuda_device, hd, t, rate):
    """`fused_causal_attention` on f32 at hd 256 / 512: one launch of each
    register-blocked kernel, and its gradients within the f32 backward
    tolerance of autograd through the plain forward."""
    b, seed = 2, 97531
    arrays = _qkv(63, b, t, hd)
    leaves = [torch.from_numpy(a).to(cuda_device).requires_grad_() for a in arrays]
    ref_leaves = [torch.from_numpy(a).to(cuda_device).requires_grad_() for a in arrays]
    dy = torch.from_numpy(_qkv(64, b, t, hd)[0]).to(cuda_device)
    before = (fused_attention_forward.wide_f32_launches, fused_attention_backward.wide_f32_launches)
    y = fused_causal_attention(*leaves, 1, None, False, rate, seed)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (fused_attention_forward.wide_f32_launches,
            fused_attention_backward.wide_f32_launches) == (before[0] + 1, before[1] + 1)
    y_ref = fused_attention_forward_plain(*ref_leaves, 1, None, False, False, rate, seed)
    ref = torch.autograd.grad(y_ref, ref_leaves, dy)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=0)
    for a, r in zip(grads, ref):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape,n_head,causal", [
    ((2, 300, 256), 2, True),  # 2 heads of 128, ragged last tiles
    ((2, 300, 256), 2, False),
    ((2, 805, 1024), 8, True),  # the StackGPT's heads at T = 805, batch 2
    ((2, 300, 128), 2, True),  # hd 64
    ((3, 77, 64), 1, False),  # hd 64, one partial tile
])
def test_cuda_f32_tc_forward_matches_plain(cuda_device, shape, n_head, causal, rate, lse):
    """f32 at hd 64 / 128 runs the 3xTF32 forward (`f32_tc_launches`, in
    neither family): output within 1e-5 of the plain version (three TF32
    products a product, each 8-deep step summed fresh and added in f32) and
    lse within 1e-4, as the FMA kernels' f32 forwards."""
    seed = 112233
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(70, *shape))
    before = (fused_attention_forward.f32_tc_launches, fused_attention_forward.fma_launches,
              fused_attention_forward.tc_launches)
    out = fused_attention_forward(q, k, v, n_head, None, causal, rate, lse, seed)
    torch.cuda.synchronize()
    assert (fused_attention_forward.f32_tc_launches, fused_attention_forward.fma_launches,
            fused_attention_forward.tc_launches) == (before[0] + 1, before[1], before[2])
    ref = fused_attention_forward_plain(q, k, v, n_head, None, causal, lse, rate, seed)
    if lse:
        torch.testing.assert_close(out[1], ref[1], atol=1e-4, rtol=0)
        out, ref = out[0], ref[0]
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("hd,t", [(64, 300), (128, 805)])
def test_cuda_f32_tc_forward_is_bit_reproducible(cuda_device, hd, t, rate):
    """Two calls of the 3xTF32 forward give the same bits (no atomics; every
    output summed by one thread in a fixed order), output and lse."""
    b, n_head = 2, 2
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(71, b, t, n_head * hd))
    y, lse = fused_attention_forward(q, k, v, n_head, None, True, rate, True, 445566)
    y2, lse2 = fused_attention_forward(q, k, v, n_head, None, True, rate, True, 445566)
    assert torch.equal(y, y2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,t", [(64, 300), (128, 805)])
def test_cuda_f32_tc_forward_masks_equal_dropout_keep_mask(cuda_device, hd, t):
    """Uniform probabilities and unit-vector V rows, causal: output column c
    of row r of the 3xTF32 forward is nonzero iff probability (r, c) was kept
    and c <= r, though the kernel takes each 8-key tile's keys in the order
    0 4 1 5 2 6 3 7."""
    b, n_head, rate, seed = 2, 2, 0.3, 82
    q = torch.zeros((b, t, n_head * hd), device=cuda_device)
    mask = dropout_keep_mask(seed, b, n_head, t, rate, cuda_device)
    before = fused_attention_forward.f32_tc_launches
    for c0 in range(0, t, hd):
        n = min(hd, t - c0)
        v = torch.zeros((b, t, n_head, hd), device=cuda_device)
        v[:, c0 + torch.arange(n), :, torch.arange(n)] = 1.0
        y = fused_attention_forward(q, q, v.reshape(b, t, -1).contiguous(), n_head, None, True,
                                    rate, seed=seed)
        got = y.view(b, t, n_head, hd).transpose(1, 2)[..., :n] > 0
        below = torch.ones((t, n), dtype=torch.bool, device=cuda_device).tril(-c0)  # key <= row
        assert torch.equal(got, mask[..., c0:c0 + n] & below)
    assert fused_attention_forward.f32_tc_launches == before + -(-t // hd)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_autograd_through_the_f32_tc_forward_and_backward(cuda_device, rate):
    """`fused_causal_attention` in f32 at hd 128 (the StackGPT's heads): the
    3xTF32 forward and the 3xTF32 backward, which rebuilds P from the
    forward's lse, one launch each and none on the FMA units; gradients
    within the f32 backward tolerance of autograd through the plain forward."""
    b, t, d, n_head, seed = 2, 300, 256, 2, 67890
    arrays = _qkv(72, b, t, d)
    leaves = [torch.from_numpy(a).to(cuda_device).requires_grad_() for a in arrays]
    ref_leaves = [torch.from_numpy(a).to(cuda_device).requires_grad_() for a in arrays]
    dy = torch.from_numpy(_qkv(73, b, t, d)[0]).to(cuda_device)
    before = (fused_attention_forward.f32_tc_launches, fused_attention_backward.f32_tc_launches,
              fused_attention_backward.fma_launches)
    y = fused_causal_attention(*leaves, n_head, None, True, rate, seed)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (fused_attention_forward.f32_tc_launches, fused_attention_backward.f32_tc_launches,
            fused_attention_backward.fma_launches) == (before[0] + 1, before[1] + 1, before[2])
    y_ref = fused_attention_forward_plain(*ref_leaves, n_head, None, True, False, rate, seed)
    ref = torch.autograd.grad(y_ref, ref_leaves, dy)
    torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=0)
    for a, r in zip(grads, ref):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("shape,n_head,causal", [
    ((2, 300, 256), 2, True),  # 2 heads of 128, ragged last tiles
    ((2, 258, 256), 2, True),  # 257 + 1 tokens
    ((8, 805, 1024), 8, True),  # the f32 stage-2 training shape
    ((2, 300, 64), 1, False),  # hd 64, one non-causal head
    ((3, 100, 128), 2, True),  # hd 64, every tile ragged
])
def test_cuda_f32_tc_backward_matches_plain(cuda_device, shape, n_head, causal, rate):
    """f32 at hd 64 / 128 runs the 3xTF32 backward (`f32_tc_launches`, in
    neither family), fed the 3xTF32 forward's lse: dq, dk, dv within 1e-4 of
    the plain version (three TF32 products a product, each tile's sum started
    afresh and added in f32), as every f32 backward; bit-reproducible."""
    seed = 314159
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(90, *shape))
    dy = torch.from_numpy(_qkv(91, *shape)[0]).to(cuda_device)
    y, lse = fused_attention_forward(q, k, v, n_head, None, causal, rate, True, seed)
    before = (fused_attention_backward.f32_tc_launches, fused_attention_backward.fma_launches,
              fused_attention_backward.tc_launches)
    out = fused_attention_backward(q, k, v, y, lse, dy, n_head, None, causal, rate, seed)
    again = fused_attention_backward(q, k, v, y, lse, dy, n_head, None, causal, rate, seed)
    torch.cuda.synchronize()
    assert (fused_attention_backward.f32_tc_launches, fused_attention_backward.fma_launches,
            fused_attention_backward.tc_launches) == (before[0] + 2, before[1], before[2])
    y_ref, lse_ref = fused_attention_forward_plain(q, k, v, n_head, None, causal, True, rate, seed)
    ref = fused_attention_backward_plain(q, k, v, y_ref, lse_ref, dy, n_head, None, causal, rate,
                                         seed)
    for a, r in zip(out, ref):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=0)
    assert all(torch.equal(a, r) for a, r in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,t", [(64, 300), (128, 805)])
def test_cuda_f32_tc_backward_masks_equal_dropout_keep_mask(cuda_device, hd, t):
    """Uniform probabilities and unit-vector rows as V and as dY: column c of
    dV's key row r is nonzero iff the probability (query c0 + c, key r) was
    kept, so dV shows the 3xTF32 backward's mask transposed, though it takes
    each 8-query tile in the order 0 4 1 5 2 6 3 7."""
    b, n_head, rate, seed = 2, 2, 0.3, 83
    q = torch.zeros((b, t, n_head * hd), device=cuda_device)
    mask = dropout_keep_mask(seed, b, n_head, t, rate, cuda_device)
    before = fused_attention_backward.f32_tc_launches
    for c0 in range(0, t, hd):
        n = min(hd, t - c0)
        v = torch.zeros((b, t, n_head, hd), device=cuda_device)
        v[:, c0 + torch.arange(n), :, torch.arange(n)] = 1.0
        v = v.reshape(b, t, -1).contiguous()
        y, lse = fused_attention_forward(q, q, v, n_head, None, False, rate, True, seed)
        _, _, dv = fused_attention_backward(q, q, v, y, lse, v, n_head, None, False, rate, seed)
        got = dv.view(b, t, n_head, hd).transpose(1, 2)[..., :n] > 0
        assert torch.equal(got, mask[..., c0:c0 + n, :].transpose(-1, -2))
    assert fused_attention_backward.f32_tc_launches == before + -(-t // hd)

