"""The port's kernels in bf16, the dtype of the first stage's bf16 modes,
against the JAX package:

  * kernel #10 (`ops/downsample.py`): the bf16 plain version against the TPU
    kernel `_downsample_pallas` run in interpret mode (C = 128, H = W = 32,
    the smallest input that interpret mode takes: the kernel wants C % 128
    == 0 and H >= 32). Both sum the products of the bf16 inputs in f32 and
    round once, in another order: at least 99.5 % of the outputs equal, the
    rest one bf16 ulp apart. The operands the tensor-core kernel reads (the
    weights packed by `pack_weight`, the padded input unfolded tap by tap)
    give the same outputs as an implicit GEMM in plain torch, against both;
    where that GEMM's rounded output lies more than one ulp from the plain
    version's, its terms cancel below the bound at which the kernel sums an
    output again in the plain version's order (`CANCELLATION`); the route a
    call takes is decided from dtype and channel count. The autograd Function's backward on bf16 inputs equals autograd of the plain
    version's, up to bf16's rounding of the gradient.
  * kernel #3 (`ops/entropy.py`) on bf16 images: the gray image bit-equal to
    the JAX function's, jitted on the CPU as the JAX trainers run it, the
    entropy within 2e-6 (f32 sums in another order).
  * the VQ search on bf16 rows and codebooks: the f32 casts', exactly.

On a CUDA card: #10 (its tensor-core kernel at the encoder's four levels and
at ragged shapes that reach every tile configuration, its FMA kernel where C
is not a multiple of 8: at least 99 % of the outputs equal, every one within
one bf16 ulp; its weight pack equal to the plain one), #3 and the VQ search
in bf16 against their plain versions, and the tensor-core attention family
(#4, #5) in bf16 at hd 256 / 512, the DQ-VAE's AttnBlocks, and at hd 128 causal, the StackGPT's heads,
which rounds P (relative to the row's final max), D and dS to bf16 where the
plain versions and the TPU kernel round them: its outputs may differ from
the plain version's in the order of summation only, so at most 5 % of them
differ, where the plain math without those roundings differs in about 40 %.

JAX is imported inside the tests, so the CUDA cases also run where only
PyTorch is installed: `python -m pytest --noconftest -m cuda tests/test_torch_*.py`.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dynamicvectorquantization_torch.ops.downsample import (
    CANCELLATION,
    pack_weight,
    pack_weight_plain,
    strided_conv3x3_down,
    strided_conv3x3_down_plain,
    uses_tensor_cores,
)
from dynamicvectorquantization_torch.ops.entropy import (
    gray_image,
    patch_entropy,
    patch_entropy_plain,
)
from dynamicvectorquantization_torch.ops.vq import (
    nearest_codes,
    nearest_codes_plain,
    nearest_codes_with_stats,
    nearest_codes_with_stats_plain,
)

BF16 = torch.bfloat16
F9_MISMATCH_SHARE = 0.05  # see the module docstring
# f32 sums of 256 kernel values and 32 p log p terms in XLA's order and in
# ours: a few f32 ulps of entropies up to ~3.5
ENTROPY_ATOL = 2e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _conv_case(seed, shape, k):
    """bf16 x (B, C, H, W), weight (K, C, 3, 3) and bias (K,)."""
    r = np.random.default_rng(seed)
    c = shape[1]
    x = r.normal(size=shape).astype(np.float32)
    w = (r.uniform(-1, 1, size=(k, c, 3, 3)) / (9 * c) ** 0.5).astype(np.float32)
    b = r.uniform(-0.5, 0.5, size=(k,)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(BF16) for a in (x, w, b))


def _ulps_apart(a, b):
    """|a - b| in bf16 ulps of the larger magnitude (f32 tensors of bf16 values)."""
    ulp = torch.ldexp(torch.ones_like(a), torch.frexp(torch.maximum(a.abs(), b.abs()))[1] - 8)
    return (a - b).abs() / ulp


# ------------------------------------------------------------- kernel #10
def test_downsample_bf16_plain_matches_the_tpu_kernel_in_interpret_mode():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from dynamicvectorquantization_tpu.ops.downsample_pallas import _downsample_pallas

    x, w, b = _conv_case(0, (2, 128, 32, 32), 128)
    with pltpu.force_tpu_interpret_mode():
        ref = _downsample_pallas(
            jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()).astype(jnp.bfloat16),
            jnp.asarray(w.float().permute(2, 3, 1, 0).numpy()), jnp.asarray(b.float().numpy()))
    ref = torch.from_numpy(np.asarray(ref.astype(jnp.float32))).permute(0, 3, 1, 2)
    out = strided_conv3x3_down_plain(x, w, b)
    assert out.dtype == BF16 and out.shape == ref.shape == (2, 128, 16, 16)
    out = out.float()
    assert float((out == ref).float().mean()) >= 0.995
    assert float(_ulps_apart(out, ref).max()) <= 1.0


def _implicit_gemm(x, packed, bias):
    """The product the tensor-core kernel forms, in plain torch on its
    operands: the padded input unfolded tap-major (row tap * C + c, one column
    per output pixel) times the repacked weights (row k, column tap * C + c),
    summed in f32, the bias added, one rounding to bf16 (an f32 sum in
    another order than the plain version's)."""
    b, c, h, w = x.shape
    k = packed.shape[1]
    ho, wo = (h - 2) // 2 + 1, (w - 2) // 2 + 1
    cols = F.unfold(F.pad(x.float(), (0, 1, 0, 1)), 3, stride=2)  # row c * 9 + tap
    cols = cols.view(b, c, 9, ho * wo).transpose(1, 2).reshape(b, 9 * c, ho * wo)
    wmat = packed.float().transpose(0, 1).reshape(k, 9 * c)
    return (wmat @ cols + bias.float()[:, None]).to(BF16).view(b, k, ho, wo)


def _one_rounding_apart(out, ref, equal_share):
    assert out.dtype == ref.dtype == BF16 and out.shape == ref.shape
    out, ref = out.float(), ref.float()
    assert float((out == ref).float().mean()) >= equal_share
    assert float(_ulps_apart(out, ref).max()) <= 1.0


def test_downsample_repacked_operands_give_the_tpu_kernel_and_the_plain_version():
    """The layout the tensor-core kernel reads, held before any card time: an
    implicit GEMM over the repacked weights equals the TPU kernel in
    interpret mode and the plain version, up to one rounding of an f32 sum
    taken in another order."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from dynamicvectorquantization_tpu.ops.downsample_pallas import _downsample_pallas

    x, w, b = _conv_case(0, (2, 128, 32, 32), 128)
    packed, sq = pack_weight_plain(w)
    assert packed.shape == (9, 128, 128) and packed.is_contiguous() and sq.shape == (128,)
    out = _implicit_gemm(x, packed, b)
    with pltpu.force_tpu_interpret_mode():
        ref = _downsample_pallas(
            jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()).astype(jnp.bfloat16),
            jnp.asarray(w.float().permute(2, 3, 1, 0).numpy()), jnp.asarray(b.float().numpy()))
    ref = torch.from_numpy(np.asarray(ref.astype(jnp.float32))).permute(0, 3, 1, 2).to(BF16)
    _one_rounding_apart(out, ref, 0.995)
    _one_rounding_apart(out, strided_conv3x3_down_plain(x, w, b), 0.995)


@pytest.mark.parametrize("shape,k", [((2, 24, 33, 20), 40), ((1, 8, 17, 35), 130),
                                     ((1, 16, 4, 3), 16)])
def test_downsample_repacked_operands_at_ragged_shapes(shape, k):
    """Tap 3 u + v, output channel k and input channel c of the packed
    weights are w[k, c, u, v], and the squares' sums are each output
    channel's; odd H / W, a C of 8 or 24 (a half chunk) and K past a tile
    give the plain version's outputs through the implicit GEMM."""
    x, w, b = _conv_case(7, shape, k)
    packed, sq = pack_weight(w)
    for u in range(3):
        for v in range(3):
            assert torch.equal(packed[3 * u + v], w[:, :, u, v])
    assert torch.allclose(sq.double(), (w.double() ** 2).sum(dim=(1, 2, 3)), rtol=1e-6, atol=0)
    _one_rounding_apart(_implicit_gemm(x, packed, b), strided_conv3x3_down_plain(x, w, b), 0.99)


def _cancelling(x, w, y):
    """Which outputs y the tensor-core kernel sums again in the plain
    version's order: |y| < CANCELLATION * ||w_k|| ||x window||, the norms
    from f32 sums of squares as the kernel takes them."""
    c = x.shape[1]
    window = F.conv2d(F.pad(x.float() ** 2, (0, 1, 0, 1)), torch.ones((1, c, 3, 3)), stride=2)
    sq = pack_weight_plain(w)[1]
    return y.float().abs() < CANCELLATION * (sq[None, :, None, None] * window).sqrt()


@pytest.mark.parametrize("shape,k,seed", [((4, 128, 64, 64), 128, 4), ((1, 256, 16, 16), 64, 2),
                                          ((2, 24, 33, 20), 40, 3)])
def test_downsample_outputs_past_one_ulp_lie_below_the_cancellation_bound(shape, k, seed):
    """Three sums of the same terms, each rounded once to bf16: the plain
    version's f32 sum, the implicit GEMM's f32 sum in another order, and the
    exact sum (f64). Where another lies more than one ulp from the plain
    version's, the output is below the kernel's cancellation bound, which it
    sums again in the plain version's order. The bound takes about 1 % of the
    outputs, every zero output with nonzero terms, and none where the terms
    are all zero."""
    x, w, b = _conv_case(seed, shape, k)
    ref = strided_conv3x3_down_plain(x, w, b).float()
    out = _implicit_gemm(x, pack_weight_plain(w)[0], b)
    exact = F.conv2d(F.pad(x.double(), (0, 1, 0, 1)), w.double(), b.double(), stride=2).to(BF16)
    listed = _cancelling(x, w, out)
    for other in (out, exact):
        assert bool(listed[_ulps_apart(other.float(), ref) > 1].all())
    assert 0.0 < float(listed.float().mean()) < 0.03
    assert bool(_cancelling(x, w, torch.zeros_like(out)).all())
    assert not bool(_cancelling(torch.zeros_like(x), w, out).any())


@pytest.mark.parametrize("dtype,c,tc", [(BF16, 128, True), (BF16, 8, True), (BF16, 24, True),
                                        (BF16, 12, False), (BF16, 3, False),
                                        (torch.float32, 128, False)])
def test_downsample_route_by_dtype_and_channels(dtype, c, tc):
    """bf16 with C a multiple of 8 -> the tensor-core kernel; f32, and bf16
    with another C -> the FMA kernel. Decided before any launch, so CPU
    tensors show it."""
    assert uses_tensor_cores(torch.zeros((1, c, 4, 4), dtype=dtype)) == tc


def test_downsample_bf16_plain_rounds_once_where_the_xla_route_rounds_twice():
    """The port follows the kernel: conv + bias summed in f32, one rounding.
    The JAX package's XLA route (`_native_strided_conv`) rounds the
    convolution to bf16 and then the bias add."""
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.downsample_pallas import _native_strided_conv

    x, w, b = _conv_case(1, (2, 16, 18, 18), 24)
    xla = _native_strided_conv(
        jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()).astype(jnp.bfloat16),
        jnp.asarray(w.float().permute(2, 3, 1, 0).numpy()), jnp.asarray(b.float().numpy()))
    xla = torch.from_numpy(np.asarray(xla.astype(jnp.float32))).permute(0, 3, 1, 2)
    twice = strided_conv3x3_down_plain(x, w, torch.zeros_like(b)) + b[:, None, None]
    out = strided_conv3x3_down_plain(x, w, b)
    # the XLA route's two roundings, reproduced up to summation order
    assert float((twice.float() == xla).float().mean()) >= 0.99
    assert float((out.float() == xla).float().mean()) < 0.9


def test_downsample_function_backward_in_bf16(monkeypatch):
    """The autograd Function's backward (the library's bf16 convolution
    gradients) with its CUDA forward replaced by the plain version, against
    autograd of the plain version (f32 gradients of the casts, rounded once)."""
    from dynamicvectorquantization_torch.ops import downsample

    monkeypatch.setattr(downsample, "_launch", strided_conv3x3_down_plain)
    x, w, b = (t.requires_grad_() for t in _conv_case(2, (2, 8, 9, 12), 6))
    dy = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 6, 4, 6)).astype(np.float32))
    dy = dy.to(BF16)
    out = downsample._StridedConvDown.apply(x, w, b)
    assert torch.equal(out, strided_conv3x3_down_plain(x, w, b))
    grads = torch.autograd.grad(out, (x, w, b), dy)
    ref = torch.autograd.grad(strided_conv3x3_down_plain(x, w, b), (x, w, b), dy)
    for g, r in zip(grads, ref):
        assert g.dtype == r.dtype == BF16 and g.shape == r.shape
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2, rtol=2.0 ** -7)


# -------------------------------------------------------------- kernel #3
def _smooth_and_noisy(seed, shape=(2, 64, 128, 3)):
    r = np.random.default_rng(seed)
    x = r.uniform(-1, 1, size=shape).astype(np.float32)
    x[:, :, : shape[2] // 2] = np.float32(0.3) + np.float32(0.01) * x[:, :, : shape[2] // 2]
    return x


@pytest.mark.parametrize("patch_size", [16, 8])
def test_patch_entropy_on_bf16_images_matches_jax(patch_size):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.entropy import _GRAY
    from dynamicvectorquantization_tpu.ops.entropy import patch_entropy as jax_entropy

    xb = jnp.asarray(_smooth_and_noisy(4)).astype(jnp.bfloat16)
    x = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(BF16)

    def jgray(a):  # `patch_entropy`'s own expression
        return (_GRAY[0] * a[..., 0] + _GRAY[1] * a[..., 1] + _GRAY[2] * a[..., 2]).astype(
            jnp.float32)

    np.testing.assert_array_equal(gray_image(x).numpy(), np.asarray(jax.jit(jgray)(xb)))
    # op by op JAX rounds the last sum to bf16 too
    assert not np.array_equal(gray_image(x).numpy(), np.asarray(jgray(xb)))
    ref = np.asarray(jax.jit(lambda a: jax_entropy(a, patch_size, use_pallas=False))(xb))
    out = patch_entropy(x, patch_size)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ENTROPY_ATOL, rtol=0)
    # the bf16 gray is not the f32 gray of the same values rounded once
    f32 = patch_entropy_plain(x.float(), patch_size).numpy()
    assert np.abs(f32 - ref).max() > 1e-3


# -------------------------------------------------------------- VQ search
def test_vq_search_on_bf16_is_the_search_on_the_f32_casts():
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.normal(size=(300, 32)).astype(np.float32)).to(BF16)
    cb = torch.from_numpy(r.normal(size=(64, 32)).astype(np.float32)).to(BF16)
    for bf16_codebook in (True, False):
        c = cb if bf16_codebook else cb.float()
        idx, xq = nearest_codes(x, c)
        ref_idx, ref_xq = nearest_codes_plain(x.float(), cb.float())
        assert xq.dtype == torch.float32
        assert torch.equal(idx, ref_idx) and torch.equal(xq, ref_xq)
        stats = nearest_codes_with_stats(x, c)
        ref = nearest_codes_with_stats_plain(x.float(), cb.float())
        for a, b in zip(stats, ref):
            assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------------------- cuda
@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [
    # the encoder's four levels: 128-channel tiles of 8 x 16 pixels at the first three,
    # 64-channel tiles of 2 x 16 pixels at the last
    ((8, 128, 256, 256), 128), ((8, 128, 128, 128), 128), ((8, 256, 64, 64), 256),
    ((8, 256, 32, 32), 256),
    ((2, 16, 33, 20), 16),  # odd H, ragged tiles
    ((1, 64, 300, 301), 72),  # batch 1, 8 x 16 tiles with ragged rows, columns and channels
    ((1, 24, 18, 40), 40),  # batch 1, a half chunk of channels, K short of a tile
    ((2, 8, 17, 35), 130),  # C = 8, odd H and W, K over three channel tiles
    ((1, 12, 20, 21), 16),  # C not a multiple of 8: the FMA kernel
    ((2, 3, 9, 9), 5),  # the same, C = 3
])
def test_cuda_bf16_downsample_kernel_matches_plain(cuda_device, shape, k):
    x, w, b = (t.to(cuda_device) for t in _conv_case(6, shape, k))
    tc = shape[1] % 8 == 0
    before = (strided_conv3x3_down.launches, strided_conv3x3_down.bf16_launches,
              strided_conv3x3_down.tc_launches)
    out = strided_conv3x3_down(x, w, b)
    torch.cuda.synchronize()
    assert (strided_conv3x3_down.launches, strided_conv3x3_down.bf16_launches,
            strided_conv3x3_down.tc_launches) == (before[0] + 1, before[1] + 1, before[2] + tc)
    ref = strided_conv3x3_down_plain(x, w, b)
    assert out.dtype == BF16
    # both round the f32 sum once: outputs equal or one ulp apart (summation order)
    assert float(_ulps_apart(out.float(), ref.float()).max()) <= 1.0
    assert float((out == ref).float().mean()) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("k,c", [(128, 128), (256, 256), (130, 8), (3, 300)])
def test_cuda_weight_pack_matches_plain(cuda_device, k, c):
    w = _conv_case(8, (1, c, 2, 2), k)[1]
    before = strided_conv3x3_down.launches
    packed, sq = pack_weight(w.to(cuda_device))
    torch.cuda.synchronize()
    ref_packed, ref_sq = pack_weight_plain(w)
    assert torch.equal(packed.cpu(), ref_packed)
    # f32 sums of 9 C squares in another order
    assert torch.allclose(sq.cpu(), ref_sq, rtol=1e-5, atol=0)
    assert strided_conv3x3_down.launches == before


@pytest.mark.cuda
def test_cuda_bf16_patch_entropy_matches_plain(cuda_device):
    x = torch.from_numpy(_smooth_and_noisy(7, (8, 256, 256, 3))).to(cuda_device, BF16)
    before = (patch_entropy.launches, patch_entropy.bf16_launches)
    out = patch_entropy(x)
    torch.cuda.synchronize()
    assert (patch_entropy.launches, patch_entropy.bf16_launches) == (before[0] + 1,
                                                                     before[1] + 1)
    torch.testing.assert_close(out, patch_entropy_plain(x), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_cuda_vq_search_on_bf16(cuda_device):
    r = np.random.default_rng(8)
    x = torch.from_numpy(r.normal(size=(4096, 256)).astype(np.float32)).to(cuda_device, BF16)
    cb = torch.from_numpy(r.normal(size=(1024, 256)).astype(np.float32)).to(cuda_device, BF16)
    idx, xq = nearest_codes(x, cb)
    ref, _ = nearest_codes_plain(x, cb)
    assert int((idx != ref).sum()) <= 4  # f32 near-ties of the casts
    assert torch.equal(xq, cb.float()[idx])
    with pytest.raises(TypeError):
        nearest_codes(x.half(), cb.half())


def _mismatch_share(a, b):
    return float((a.float() != b.float()).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_head,causal", [
    ((8, 1024, 256), 1, False),  # (a) the decoder's 32x32 AttnBlock, hd 256
    ((8, 256, 512), 1, False),  # (b) the encoder's 16x16 AttnBlock, hd 512
    ((8, 808, 1024), 8, True),  # the StackGPT's heads, hd 128 (F10)
])
def test_cuda_tensor_core_attention_rounds_where_the_tpu_kernel_rounds(cuda_device, shape,
                                                                        n_head, causal):
    """F9 / F10: the tensor-core family in bf16 (hd 256 / 512, the DQ-VAE's
    AttnBlocks; hd 128 causal, the StackGPT's) against the bf16 plain
    version, which rounds P (relative to the row's final max), D and dS; the
    same plain math without those roundings (the f32 plain version on the
    f32 casts) fails the same bound."""
    from dynamicvectorquantization_torch.ops.attention import (
        fused_attention_backward,
        fused_attention_backward_plain,
        fused_attention_forward,
        fused_attention_forward_plain,
    )

    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v, dy = (torch.randn(shape, generator=g, device=cuda_device).to(BF16)
                   for _ in range(4))
    before = (fused_attention_forward.tc_launches, fused_attention_backward.tc_launches)
    y, lse = fused_attention_forward(q, k, v, n_head, None, causal, return_lse=True)
    grads = fused_attention_backward(q, k, v, y, lse, dy, n_head, None, causal)
    torch.cuda.synchronize()
    assert (fused_attention_forward.tc_launches, fused_attention_backward.tc_launches) == (
        before[0] + 1, before[1] + 1)
    y_ref, lse_ref = fused_attention_forward_plain(q, k, v, n_head, None, causal, True)
    ref = fused_attention_backward_plain(q, k, v, y_ref, lse_ref, dy, n_head, None, causal)
    y_un, lse_un = fused_attention_forward_plain(q.float(), k.float(), v.float(), n_head, None,
                                                 causal, True)
    ref_un = fused_attention_backward_plain(q.float(), k.float(), v.float(), y_un, lse_un,
                                            dy.float(), n_head, None, causal)
    assert _mismatch_share(y, y_ref) <= F9_MISMATCH_SHARE < _mismatch_share(y_un.to(BF16), y_ref)
    for got, want, unrounded in zip(grads, ref, ref_un):
        assert _mismatch_share(got, want) <= F9_MISMATCH_SHARE < _mismatch_share(
            unrounded.to(BF16), want)
