"""The quantizer's training half in the PyTorch port
(`dynamicvectorquantization_torch/ops/vq.py`) against the JAX package:
`nearest_codes_with_stats` against the XLA path and against the Pallas
`_vq_kernel_train` in interpret mode (codes and counts exact, sums atol
1e-6 x the largest sum: f32 additions in another order), `_ema_update` with
and without restart and in the fewer-rows-than-codes branch with the
permutation and the jitter shared between the two sides, the commitment
loss's gradient and the straight-through estimator, and the padding row. On
a CUDA card, the CUDA kernels against the plain version.

JAX is imported inside the tests, so the CUDA cases also run where only
PyTorch is installed: `python -m pytest --noconftest -m cuda tests/test_torch_*.py`.
"""
import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.ops.vq import (
    VectorQuantizeEMA,
    nearest_codes_with_stats,
    nearest_codes_with_stats_plain,
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


def _assert_stats(ours, ref):
    idx, xq, esum, csize = (t.numpy() for t in ours)
    idx_r, xq_r, esum_r, csize_r = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(idx, idx_r)
    np.testing.assert_array_equal(xq, xq_r)
    np.testing.assert_array_equal(csize, csize_r)
    np.testing.assert_allclose(esum, esum_r, atol=1e-6 * np.abs(esum_r).max(), rtol=0)


@pytest.mark.parametrize("n,k,d", [(512, 64, 32), (300, 128, 256), (40, 64, 32)])
def test_stats_plain_matches_jax_xla(n, k, d):
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.vq_pallas import nearest_codes_with_stats as jstats

    x, cb = _x_cb(0, n, k, d)
    ref = jstats(jnp.asarray(x), jnp.asarray(cb), use_pallas=False)
    _assert_stats(nearest_codes_with_stats(torch.from_numpy(x), torch.from_numpy(cb)), ref)


@pytest.mark.parametrize("n", [512, 300])  # 300: the TPU kernel pads to its 256-row tile
def test_stats_plain_matches_jax_pallas_interpret(n):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from dynamicvectorquantization_tpu.ops.vq_pallas import nearest_codes_with_stats as jstats

    x, cb = _x_cb(1, n, 128, 256)
    with pltpu.force_tpu_interpret_mode():
        ref = jstats(jnp.asarray(x), jnp.asarray(cb), use_pallas=True)
    _assert_stats(nearest_codes_with_stats_plain(torch.from_numpy(x), torch.from_numpy(cb)), ref)


def _shared_draw(pool_rows, noise_shape):
    """The restart draw both sides are given: a permutation that depends on
    the pool size only, and jitter in [0, 1) of the pool's shape."""
    perm = np.random.default_rng(pool_rows).permutation(pool_rows)
    noise = (None if noise_shape is None else
             np.random.default_rng(7).uniform(size=noise_shape).astype(np.float32))
    return noise, perm


def _patch_jax_draws(monkeypatch):
    import jax
    import jax.numpy as jnp

    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n: jnp.asarray(_shared_draw(n, None)[1]))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(_shared_draw(1, shape)[0]))


def _patch_port_draws(tvq):
    def draw(pool_rows, noise_shape, generator, device):
        noise, perm = _shared_draw(pool_rows, noise_shape)
        return (None if noise is None else torch.from_numpy(noise)), torch.from_numpy(perm)

    tvq._draw_restart = draw


def _pair(k, d, restart, x):
    """(JAX module, its variables, the port's module) with one codebook and
    non-trivial EMA statistics."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.vq import VectorQuantizeEMA as JaxVQ

    r = np.random.default_rng(3)
    jvq = JaxVQ(codebook_size=k, codebook_dim=d, restart_unused_codes=restart, use_pallas=False)
    jvq.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    cb = r.normal(size=(k + 1, d)).astype(np.float32)
    cb[k] = 0.0
    csize = r.uniform(0.0, 3.0, size=(k,)).astype(np.float32)  # some below 1: they restart
    embed = (cb[:k] * csize[:, None]).astype(np.float32)
    variables = {"ema": {"codebook": jnp.asarray(cb), "cluster_size_ema": jnp.asarray(csize),
                         "embed_ema": jnp.asarray(embed)}}
    tvq = VectorQuantizeEMA(codebook_size=k, codebook_dim=d, restart_unused_codes=restart,
                            use_pallas=False)
    tvq.codebook.weight.copy_(torch.from_numpy(cb))
    tvq.codebook.cluster_size_ema.copy_(torch.from_numpy(csize))
    tvq.codebook.embed_ema.copy_(torch.from_numpy(embed))
    return jvq, variables, tvq


@pytest.mark.parametrize("restart,b", [(False, 2), (True, 2), (True, 1)],
                         ids=["no-restart", "restart", "restart-fewer-rows-than-codes"])
def test_ema_update_matches_jax(monkeypatch, restart, b):
    import jax
    import jax.numpy as jnp

    k, d = 48, 16
    r = np.random.default_rng(4)
    x = r.normal(size=(b, 5, 5, d)).astype(np.float32)  # 50 rows, or 25 < 48 codes
    mask = np.where(r.uniform(size=(b, 5, 5, 1)) < 0.5, 0.25, 1.0).astype(np.float32)
    jvq, variables, tvq = _pair(k, d, restart, x)
    _patch_jax_draws(monkeypatch)
    _patch_port_draws(tvq)
    (xq_r, loss_r, (_, _, code_r)), mut = jvq.apply(
        variables, jnp.asarray(x), jnp.asarray(mask), train=True, mutable=["ema"],
        rngs={"vq": jax.random.PRNGKey(5)})
    before = tvq.codebook.weight.clone()
    xq, loss, (_, _, code) = tvq(torch.from_numpy(x), torch.from_numpy(mask), train=True)

    np.testing.assert_array_equal(code.numpy(), np.asarray(code_r))
    # the batch is quantized with the codebook from before the update
    # (x + (x_q - x) rounds in the last bit)
    np.testing.assert_allclose(xq.numpy(), before[code].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(xq.numpy(), np.asarray(xq_r), atol=1e-6, rtol=0)
    np.testing.assert_allclose(loss.item(), float(loss_r), atol=0, rtol=1e-6)
    ema = mut["ema"]
    cb = tvq.codebook
    np.testing.assert_allclose(cb.cluster_size_ema.numpy(), np.asarray(ema["cluster_size_ema"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(cb.embed_ema.numpy(), np.asarray(ema["embed_ema"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(cb.weight.numpy(), np.asarray(ema["codebook"]), atol=1e-5,
                               rtol=1e-5)
    assert not torch.equal(cb.weight[:k], before[:k])
    assert torch.equal(cb.weight[k], torch.zeros(d))  # the padding row is never touched
    if restart:
        restarted = np.asarray(ema["cluster_size_ema"]) == 1.0
        assert restarted.any() and not restarted.all()


def test_commit_false_leaves_the_buffers_alone():
    k, d = 48, 16
    x = np.random.default_rng(5).normal(size=(2, 5, 5, d)).astype(np.float32)
    _, _, tvq = _pair(k, d, True, x)
    before = {n: b.clone() for n, b in tvq.codebook.named_buffers()}
    g = torch.Generator().manual_seed(0)
    out = tvq(torch.from_numpy(x), train=True, generator=g, commit=False)
    for n, b in tvq.codebook.named_buffers():
        assert torch.equal(b, before[n]), n
    again = tvq(torch.from_numpy(x), train=True, generator=g)
    assert torch.equal(out[0], again[0]) and torch.equal(out[2][2], again[2][2])
    assert not torch.equal(tvq.codebook.weight, before["weight"])


def test_restart_draws_come_from_the_generator():
    k, d = 48, 16
    x = np.random.default_rng(6).normal(size=(1, 5, 5, d)).astype(np.float32)
    outs = []
    for seed in (0, 0, 1):
        _, _, tvq = _pair(k, d, True, x)
        tvq(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(seed))
        outs.append(tvq.codebook.weight.clone())
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("with_mask", [True, False])
def test_commitment_gradient_and_straight_through_match_jax(with_mask):
    import jax
    import jax.numpy as jnp

    k, d = 48, 16
    r = np.random.default_rng(8)
    x = r.normal(size=(2, 5, 5, d)).astype(np.float32)
    mask = np.where(r.uniform(size=(2, 5, 5, 1)) < 0.5, 0.25, 1.0).astype(np.float32)
    w = r.normal(size=x.shape).astype(np.float32)  # weights of a downstream loss on x_q
    jvq, variables, tvq = _pair(k, d, False, x)
    jmask = jnp.asarray(mask) if with_mask else None

    def total(xj):
        (xq, loss, _), _ = jvq.apply(variables, xj, jmask, train=True, mutable=["ema"])
        return loss + jnp.sum(xq * jnp.asarray(w))

    grad_ref = jax.grad(total)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    xq, loss, _ = tvq(xt, torch.from_numpy(mask) if with_mask else None, train=True)
    (grad,) = torch.autograd.grad(loss + (xq * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_ref), atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(8192, 1024, 256), (100, 1024, 256), (1237, 300, 36)])
def test_cuda_kernel_matches_plain(cuda_device, n, k, d):
    x, cb = _x_cb(9, n, k, d)
    x, cb = torch.from_numpy(x).to(cuda_device), torch.from_numpy(cb).to(cuda_device)
    before = nearest_codes_with_stats.launches
    idx, xq, esum, csize = nearest_codes_with_stats(x, cb)
    again = nearest_codes_with_stats(x, cb)
    assert nearest_codes_with_stats.launches == before + 2
    ref = nearest_codes_with_stats_plain(x, cb)
    assert torch.equal(idx, ref[0])  # N(0, 1) codes: no f32 near-ties at these seeds
    assert torch.equal(xq, cb[idx])
    assert torch.equal(csize, ref[3])
    assert float((esum - ref[2]).abs().max()) <= 1e-5 * float(ref[2].abs().max())
    for a, b in zip((idx, xq, esum, csize), again):
        assert torch.equal(a, b)  # no atomics: bit-identical from run to run


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros((8, 32), device=cuda_device)
    with pytest.raises(TypeError):
        nearest_codes_with_stats(x.double(), torch.zeros((4, 32), device=cuda_device).double())
    with pytest.raises(ValueError):
        nearest_codes_with_stats(x, torch.zeros((4, 32)))
    with pytest.raises(ValueError):
        nearest_codes_with_stats(torch.zeros((8, 30), device=cuda_device),
                                 torch.zeros((4, 30), device=cuda_device))
