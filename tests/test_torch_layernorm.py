"""LayerNorm in the PyTorch port (`dynamicvectorquantization_torch/ops/
layernorm.py`, `nn/norm.py`): the plain versions and the autograd Function
against the JAX package's Pallas kernels `fused_layernorm(..., interpret=True)`
and their `jax.grad` (f32: y atol 1e-5; dx, dgamma, dbeta atol 1e-4, at row
counts that are no multiple of the TPU kernel's 256-row block), and, on a CUDA
card, the CUDA kernels against the plain versions.

JAX is imported inside the tests, so the CUDA cases also run where only
PyTorch is installed: `python -m pytest --noconftest -m cuda tests/test_torch_*.py`.
"""
import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.nn.norm import MIN_ROWS, LayerNorm
from dynamicvectorquantization_torch.ops.layernorm import (
    fused_layernorm,
    fused_layernorm_plain,
    layernorm_backward,
    layernorm_backward_plain,
    layernorm_forward,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, shape):
    r = np.random.default_rng(seed)
    d = shape[-1]
    x = (r.normal(size=shape) * 1.5 + 0.3).astype(np.float32)
    gamma = (1 + 0.1 * r.normal(size=d)).astype(np.float32)
    beta = (0.1 * r.normal(size=d)).astype(np.float32)
    dy = r.normal(size=shape).astype(np.float32)
    return x, gamma, beta, dy


def _jax_reference(x, gamma, beta, dy):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.layernorm_pallas import fused_layernorm as jln

    f = lambda a, g, b: jln(a, g, b, 1e-5, True)  # noqa: E731
    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    return [np.asarray(a) for a in (y, *vjp(jnp.asarray(dy)))]


@pytest.mark.parametrize("shape", [(2, 300, 128), (3, 101, 256), (1, 7, 128)])
def test_plain_and_function_match_jax_pallas_interpret(shape):
    x, gamma, beta, dy = _inputs(0, shape)
    y_ref, dx_ref, dg_ref, db_ref = _jax_reference(x, gamma, beta, dy)
    tx, tg, tb, tdy = (torch.from_numpy(a) for a in (x, gamma, beta, dy))

    np.testing.assert_allclose(layernorm_forward(tx, tg, tb).numpy(), y_ref, atol=1e-5, rtol=0)
    for out, ref in zip(layernorm_backward(tx, tg, tdy), (dx_ref, dg_ref, db_ref)):
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)

    # the autograd Function (explicit backward) and autograd through the plain math
    for fn in (fused_layernorm, fused_layernorm_plain):
        leaves = [t.clone().requires_grad_() for t in (tx, tg, tb)]
        y = fn(*leaves, 1e-5)
        grads = torch.autograd.grad(y, leaves, tdy)
        np.testing.assert_allclose(y.detach().numpy(), y_ref, atol=1e-5, rtol=0)
        for out, ref in zip(grads, (dx_ref, dg_ref, db_ref)):
            np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_module_dispatch_and_non_contiguous_grad():
    """`nn.norm.LayerNorm`: 256 rows or more go through the Function, fewer
    through the plain math; both give the same values and gradients, also when
    autograd hands the backward a non-contiguous dy."""
    d = 64
    ln = LayerNorm(d)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(_inputs(1, (1, d))[1]))
        ln.bias.copy_(torch.from_numpy(_inputs(1, (1, d))[2]))
    x = torch.from_numpy(_inputs(2, (2, MIN_ROWS, d))[0]).requires_grad_()
    y = ln(x)
    assert y.grad_fn is not None and "FusedLayerNorm" in type(y.grad_fn).__name__
    small = ln(x[:, :4])
    assert "FusedLayerNorm" not in type(small.grad_fn).__name__
    torch.testing.assert_close(small, y[:, :4], atol=1e-6, rtol=0)
    dy = torch.from_numpy(_inputs(3, (2, d, MIN_ROWS))[0]).transpose(1, 2)  # not contiguous
    got = torch.autograd.grad(y, (x, ln.weight, ln.bias), dy)
    ref = torch.autograd.grad(fused_layernorm_plain(x, ln.weight, ln.bias), (x, ln.weight, ln.bias),
                              dy)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def test_bf16_output_dtypes():
    x, gamma, beta, dy = (torch.from_numpy(a) for a in _inputs(4, (2, 130, 128)))
    y = layernorm_forward(x.bfloat16(), gamma, beta)
    dx, dg, db = layernorm_backward(x.bfloat16(), gamma.bfloat16(), dy.bfloat16())
    assert y.dtype == torch.bfloat16 and dx.dtype == torch.bfloat16
    assert dg.dtype == torch.float32 and db.dtype == torch.float32
    ref = layernorm_backward_plain(x.bfloat16().float(), gamma.bfloat16().float(),
                                   dy.bfloat16().float())
    torch.testing.assert_close(dg, ref[1], atol=1e-4, rtol=0)
    torch.testing.assert_close(dx.float(), ref[0], atol=4e-2, rtol=0)  # one bf16 rounding, |dx| < 8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("shape", [(8, 805, 1024), (3, 101, 32), (1, 2050, 2048), (5, 64)])
def test_cuda_kernels_match_plain(cuda_device, dtype, wdtype, shape):
    x, gamma, beta, dy = (torch.from_numpy(a).to(cuda_device) for a in _inputs(5, shape))
    x, dy, gamma, beta = x.to(dtype), dy.to(dtype), gamma.to(wdtype), beta.to(wdtype)
    before = layernorm_forward.launches, layernorm_backward.launches
    y = layernorm_forward(x, gamma, beta)
    dx, dg, db = layernorm_backward(x, gamma, dy)
    torch.cuda.synchronize()
    assert (layernorm_forward.launches, layernorm_backward.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    y_ref = fused_layernorm_plain(x, gamma, beta)
    dx_ref, dg_ref, db_ref = layernorm_backward_plain(x, gamma, dy)
    atol, rtol = (1e-5, 0) if dtype == torch.float32 else (2e-2, 2.0 ** -7)  # one bf16 ulp
    torch.testing.assert_close(y.float(), y_ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(dx.float(), dx_ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(dg, dg_ref, atol=2e-3, rtol=1e-5)  # f32 sums in another order
    torch.testing.assert_close(db, db_ref, atol=2e-3, rtol=1e-5)
    again = layernorm_backward(x, gamma, dy)
    assert all(torch.equal(a, b) for a, b in zip((dx, dg, db), again))  # no atomics


@pytest.mark.cuda
def test_cuda_autograd_function_runs_both_kernels(cuda_device):
    x, gamma, beta, dy = (torch.from_numpy(a).to(cuda_device) for a in _inputs(6, (2, 300, 128)))
    leaves = [t.requires_grad_() for t in (x, gamma, beta)]
    before = layernorm_forward.launches, layernorm_backward.launches
    grads = torch.autograd.grad(fused_layernorm(*leaves), leaves, dy.transpose(0, 1).contiguous()
                                .transpose(0, 1))
    assert (layernorm_forward.launches, layernorm_backward.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    ref = torch.autograd.grad(fused_layernorm_plain(*leaves), leaves, dy)
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    x = torch.zeros((4, 30), device=cuda_device)
    with pytest.raises(ValueError):
        layernorm_forward(x, torch.ones(30, device=cuda_device), torch.zeros(30, device=cuda_device))
    x = torch.zeros((4, 4096), device=cuda_device)
    with pytest.raises(ValueError):
        layernorm_forward(x, torch.ones(4096, device=cuda_device),
                          torch.zeros(4096, device=cuda_device))
    x = torch.zeros((4, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        layernorm_forward(x, torch.ones(64, device=cuda_device), torch.zeros(64, device=cuda_device))
