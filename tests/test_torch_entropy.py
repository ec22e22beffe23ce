"""Patch entropy in the PyTorch port (`dynamicvectorquantization_torch/ops/
entropy.py`): the plain version against the JAX package's `patch_entropy`
(XLA path, and its Pallas kernel in interpret mode) at atol 1e-5, and, on a
CUDA card, the CUDA kernel against the plain version.

JAX is imported inside the tests, so the CUDA cases also run where only
PyTorch is installed: `python -m pytest --noconftest -m cuda tests/test_torch_*.py`.
"""
import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.ops.entropy import patch_entropy, patch_entropy_plain

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
