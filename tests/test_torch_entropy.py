"""Patch entropy in the PyTorch port (`dynamicvectorquantization_torch/ops/
entropy.py`): the plain version against the JAX package's `patch_entropy`
(XLA path, and its Pallas kernel in interpret mode) at atol 1e-5, and, on a
CUDA card, the CUDA kernel against the plain version. The kernel evaluates a
pixel's kernel values only in a window of bins round its nearest bin: a CPU
test sweeps gray values densely and shows every value outside the window is
exactly +0 in f32, and the card tests put pixels on and between the window's
edges.

JAX is imported inside the tests, so the CUDA cases also run where only
PyTorch is installed: `python -m pytest --noconftest -m cuda tests/test_torch_*.py`.
"""
import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.ops.entropy import (
    WINDOW_CUTOFF,
    bin_centres,
    gray_image,
    patch_entropy,
    patch_entropy_plain,
    window_half_width,
    window_of,
)

ATOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _images(seed, shape=(2, 64, 128, 3)):
    """Half smooth, half noisy, so patches span low and high entropy."""
    r = np.random.default_rng(seed)
    x = r.uniform(-1, 1, size=shape).astype(np.float32)
    x[:, :, : shape[2] // 2] = np.float32(0.3) + np.float32(0.01) * x[:, :, : shape[2] // 2]
    return x


@pytest.mark.parametrize("patch_size", [16, 8])
@pytest.mark.parametrize("bin_range", [(-1.0, 1.0), (0.0, 1.0)])
def test_plain_matches_jax(patch_size, bin_range):
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.entropy import patch_entropy as jax_entropy

    x = _images(0)
    ref = np.asarray(jax_entropy(jnp.asarray(x), patch_size, bin_range=bin_range,
                                 use_pallas=False))
    out = patch_entropy(torch.from_numpy(x), patch_size, bin_range=bin_range).numpy()
    assert out.shape == ref.shape == (2, 64 // patch_size, 128 // patch_size)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert out.min() < 0.5 < 2.0 < out.max()  # both kinds of patches occur


@pytest.mark.parametrize("patch_size", [16, 8])
@pytest.mark.parametrize("bin_range", [(-1.0, 1.0), (0.0, 1.0)])
def test_plain_matches_jax_pallas_interpret(patch_size, bin_range):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from dynamicvectorquantization_tpu.ops.entropy import patch_entropy as jax_entropy

    x = _images(1)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_entropy(jnp.asarray(x), patch_size, bin_range=bin_range,
                                     use_pallas=True))
    out = patch_entropy_plain(torch.from_numpy(x), patch_size, bin_range=bin_range).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    x = torch.from_numpy(_images(2, (1, 32, 32, 3)))
    before = patch_entropy.launches
    for use_pallas in (None, True, False):
        torch.testing.assert_close(patch_entropy(x, use_pallas=use_pallas),
                                   patch_entropy_plain(x), atol=0, rtol=0)
    assert patch_entropy.launches == before
    with pytest.raises(ValueError):
        patch_entropy(x[:, :30])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,patch_size,bin_range", [
    ((8, 256, 256, 3), 16, (-1.0, 1.0)),  # the encoder's batch
    ((2, 64, 128, 3), 8, (0.0, 1.0)),
])
def test_cuda_kernel_matches_plain(cuda_device, shape, patch_size, bin_range):
    x = torch.from_numpy(_images(3, shape)).to(cuda_device)
    before = patch_entropy.launches
    out = patch_entropy(x, patch_size, bin_range=bin_range)
    torch.cuda.synchronize()
    assert patch_entropy.launches == before + 1
    ref = patch_entropy_plain(x, patch_size, bin_range=bin_range)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    """bf16 images are the kernel's now (a bf16 case against the plain
    version); float16 still raises."""
    x = torch.from_numpy(_images(4, (1, 32, 32, 3))).to(cuda_device)
    x16 = x.to(torch.bfloat16)
    before = patch_entropy.bf16_launches
    out = patch_entropy(x16)
    torch.cuda.synchronize()
    assert patch_entropy.bf16_launches == before + 1
    torch.testing.assert_close(out, patch_entropy_plain(x16), atol=ATOL, rtol=0)
    with pytest.raises(TypeError):
        patch_entropy(x.half())
    with pytest.raises(ValueError):
        patch_entropy(x, num_bins=64)


def _edge_grays(bin_range, nb=32, sigma=0.01):
    """f32 gray values on and next to the window's edges (where a pixel's
    nearest bin changes: u = (g - lo) * inv_delta at half-integers, a few
    ulps either side), on the bin centres, and a dense uniform sweep past both
    ends of the range."""
    lo, hi = bin_range
    step = (hi - lo) / (nb - 1)
    halves = lo + (np.arange(-8, nb + 8) + 0.5) * step
    centres = lo + np.arange(nb) * step
    near = np.concatenate([halves, centres]).astype(np.float32)
    ulps = np.arange(-4, 5, dtype=np.float32)
    near = near[:, None] + ulps * np.spacing(np.abs(near))[:, None]
    sweep = np.linspace(-1.25, 1.25, 400_001, dtype=np.float32)
    return np.concatenate([near.ravel(), sweep]).astype(np.float32)


@pytest.mark.parametrize("bin_range", [(-1.0, 1.0), (0.0, 1.0)])
def test_window_holds_every_nonzero_kernel_value(bin_range):
    """The kernel's window rule (`window_of` with W = `window_half_width`, in
    the kernel's f32 arithmetic): over a dense sweep of gray values and values
    a few ulps from every window edge, every kernel value exp(-0.5 r^2) of a
    bin outside the window is exactly +0 in f32, as the plain version computes
    it, and such a bin lies at least WINDOW_CUTOFF = 15 sigma from the gray
    value, past the 14.43 sigma where the values turn +0: the margin. The
    window holds 2 W + 1 = 5 bins over (-1, 1) and 11 over (0, 1), of 32."""
    nb, sigma = 32, 0.01
    half = window_half_width(nb, sigma, bin_range)
    assert 2 * half + 1 == {(-1.0, 1.0): 5, (0.0, 1.0): 11}[bin_range]
    gray = torch.from_numpy(_edge_grays(bin_range))
    first, last = window_of(gray, nb, bin_range, half)
    j = torch.arange(nb, dtype=torch.float32)
    outside = (j < first[:, None]) | (j > last[:, None])
    r = (gray[:, None] - bin_centres(nb, *bin_range)) * (1.0 / sigma)
    values = torch.exp(-0.5 * r * r)
    assert int(outside.sum()) > 0.8 * outside.numel()
    assert bool((values[outside] == 0).all())
    assert float(r[outside].abs().min()) >= WINDOW_CUTOFF - 1e-3
    nonzero = values > 0  # the values that are not +0 lie within 14.43 sigma
    assert float(r[nonzero].abs().max()) < 14.43
    # a window of every bin where the bins do not rise from lo to hi
    assert window_half_width(nb, sigma, (1.0, -1.0)) == nb - 1


def _edge_images(dtype, bin_range, shape=(2, 128, 128, 3)):
    """Images whose gray values sit on and between the window's edges: R = G =
    B = x with x / 0.9999 near the edge grays (f32), or every bf16 value in
    [-1.25, 1.25] in turn (bf16), the rest a uniform sweep; shuffled with a
    fixed seed so every patch mixes them."""
    n = shape[0] * shape[1] * shape[2]
    if dtype == torch.bfloat16:
        bits = np.arange(1 << 16, dtype=np.uint32) << 16
        vals = bits.view(np.float32)
        vals = vals[np.isfinite(vals) & (np.abs(vals) <= 1.25)]
    else:
        vals = _edge_grays(bin_range) / np.float32(0.9999)
    vals = np.resize(vals, n)
    np.random.default_rng(5).shuffle(vals)
    x = np.repeat(vals.reshape(*shape[:3], 1), 3, axis=3)
    return torch.from_numpy(x).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bin_range", [(-1.0, 1.0), (0.0, 1.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_on_window_edges_matches_plain(cuda_device, dtype, bin_range):
    """Pixels on and between the window's edges, in both dtypes: the windowed
    kernel within 1e-5 of the plain version (which evaluates all 32 values),
    bit-reproducible, one launch each."""
    x = _edge_images(dtype, bin_range).to(cuda_device)
    before = patch_entropy.launches
    out = patch_entropy(x, 16, bin_range=bin_range)
    again = patch_entropy(x, 16, bin_range=bin_range)
    torch.cuda.synchronize()
    assert patch_entropy.launches == before + 2
    ref = patch_entropy_plain(x, 16, bin_range=bin_range)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
    assert torch.equal(out, again)
    gray = gray_image(x).reshape(-1)
    first, last = window_of(gray, 32, bin_range, window_half_width(32, 0.01, bin_range))
    assert bool(((last - first) < 31).any())  # the windows do leave bins out


@pytest.mark.cuda
@pytest.mark.parametrize("patch_size,num_bins,sigma,bin_range", [
    (6, 16, 0.05, (-1.0, 1.0)),  # W = 6, walked in a loop; pixels one at a time (p % 4 != 0)
    (16, 32, 0.01, (1.0, -1.0)),  # bins falling from lo to hi: every bin a pixel's window
    (8, 32, 0.01, (0.0, 1.0)),  # W = 5, compiled; 4-pixel groups over 8 x 8 patches
])
def test_cuda_kernel_window_paths_match_plain(cuda_device, patch_size, num_bins, sigma, bin_range):
    """The kernel's other window paths against the plain version (1e-5),
    both dtypes, bit-reproducible: a half-width known only at run time, the
    window of every bin, and a compiled one on smaller patches."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(_images(6, (2, 48, 96, 3))).to(cuda_device, dtype)
        out = patch_entropy(x, patch_size, num_bins, sigma, bin_range)
        again = patch_entropy(x, patch_size, num_bins, sigma, bin_range)
        ref = patch_entropy_plain(x, patch_size, num_bins, sigma, bin_range)
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
        assert torch.equal(out, again)
