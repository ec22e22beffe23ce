"""Fused AdamW and the LR schedules in the PyTorch port
(`dynamicvectorquantization_torch/ops/fused_adamw.py`, `train/schedules.py`)
against the JAX package: the plain update against `fused_adamw_apply(...,
interpret=True)` with the same mask, three steps from identical numpy state
(p, m, v atol 1e-7 + rtol 1e-6, the bf16 copy bit-equal); every schedule at a
range of steps (rtol 1e-6); the optimizer-state converter; and, on a CUDA
card, the CUDA kernel against the plain version.

JAX is imported inside the tests, so the CUDA cases also run where only
PyTorch is installed: `python -m pytest --noconftest -m cuda tests/test_torch_*.py`.
"""
import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.ops.fused_adamw import (
    adamw_scalars,
    fused_adamw_step,
    fused_adamw_step_plain,
)
from dynamicvectorquantization_torch.train import schedules


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_SHAPES = {"dense": {"kernel": (48, 40), "bias": (40,)}, "table": {"embedding": (7, 24)},
           "odd": {"kernel": (5, 3)}}


def _tree(r, scale):
    return {k: {n: (scale * r.normal(size=s)).astype(np.float32) for n, s in v.items()}
            for k, v in _SHAPES.items()}


def _bf16_bits(a):
    """The bf16 rounding of an f32 array, as raw 16-bit patterns."""
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16).view(torch.int16).numpy()


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_fused_adamw_interpret(grad_dtype):
    import jax
    import jax.numpy as jnp
    import optax

    from dynamicvectorquantization_tpu.ops.fused_adamw import fused_adamw_apply
    from dynamicvectorquantization_tpu.train.schedules import warmup_cosine as jax_warmup_cosine
    from dynamicvectorquantization_tpu.train.stage2 import _decay_mask

    r = np.random.default_rng(0)
    params = _tree(r, 0.05)
    wd, lr, warmup, total = 0.01, 1e-3, 2, 10
    jsched = jax_warmup_cosine(lr, warmup, total, 0.0)
    tx = optax.adamw(jsched, b1=0.9, b2=0.95, weight_decay=wd, mask=_decay_mask)
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = tx.init(jparams)

    sched = schedules.warmup_cosine(lr, warmup, total, 0.0)
    flat = {(k, n): torch.from_numpy(a.copy()) for k, v in params.items() for n, a in v.items()}
    m = {key: torch.zeros_like(p) for key, p in flat.items()}
    v = {key: torch.zeros_like(p) for key, p in flat.items()}
    copies = {key: torch.empty_like(p, dtype=torch.bfloat16) for key, p in flat.items()}

    for count in range(3):
        grads = _tree(r, 1e-2)
        tgrads = {(k, n): torch.from_numpy(a).to(getattr(torch, grad_dtype))
                  for k, sub in grads.items() for n, a in sub.items()}
        jgrads = {k: {n: jnp.asarray(tgrads[(k, n)].float().numpy()).astype(grad_dtype)
                      for n in sub} for k, sub in grads.items()}
        jparams, jcopy, jopt = fused_adamw_apply(
            jgrads, jopt, jparams, jsched, b1=0.9, b2=0.95, weight_decay=wd, mask=_decay_mask,
            interpret=True, param_copy_dtype="bfloat16")
        scal = adamw_scalars(count, sched)
        for key, p in flat.items():
            fused_adamw_step(tgrads[key], p, m[key], v[key], *scal,
                             wd=wd if key[1] == "kernel" else 0.0, copy=copies[key])
        for (k, n), p in flat.items():
            for got, want in ((p, jparams[k][n]), (m[(k, n)], jopt[0].mu[k][n]),
                              (v[(k, n)], jopt[0].nu[k][n])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7, rtol=1e-6,
                                           err_msg=f"{k}/{n} step {count}")
            # the copy is the bf16 rounding of this side's own p'; where the two
            # p' agree to the bit, so do the copies
            np.testing.assert_array_equal(copies[(k, n)].view(torch.int16).numpy(), _bf16_bits(p))
            same = p.numpy() == np.asarray(jparams[k][n])
            np.testing.assert_array_equal(
                copies[(k, n)].view(torch.int16).numpy()[same],
                _bf16_bits(np.asarray(jcopy[k][n].astype(jnp.float32)))[same])
            assert same.mean() > 0.5
    assert int(jopt[0].count) == 3


def test_scalars_and_in_place_update():
    lr, c1, c2 = adamw_scalars(0, 1e-3)
    np.testing.assert_allclose([lr, c1, c2], [1e-3, 10.0, 20.0], rtol=1e-6)
    p = torch.full((5,), 0.5)
    m, v = torch.zeros(5), torch.zeros(5)
    g = torch.tensor([1e-3, -1e-3, 0.0, 2.0, -2.0])
    out = fused_adamw_step_plain(g, p, m, v, lr, c1, c2, wd=0.0)
    assert out[0] is p and out[1] is m and out[2] is v
    # after one step u = g / (|g| + eps): a unit step against the gradient's sign
    np.testing.assert_allclose(p.numpy(), 0.5 - 1e-3 * np.sign(g.numpy()), atol=1e-7)


_STEPS = (0, 1, 2, 5, 9, 10, 11, 50, 99, 100, 150)


@pytest.mark.parametrize("name,args", [
    ("linear_warmup", (5e-4, 10)),
    ("linear_warmup", (5e-4, 0)),
    ("warmup_cosine", (5e-4, 10, 200, 0.1)),
    ("warmup_cosine", (1e-3, 0, 120, 0.0)),
    ("lambda_warmup_cosine", (10, 0.05, 1.0, 0.0, 200)),
    ("gradual_warmup", (5e-4, 10, 5, 2.0, 100, 1e-5)),
    ("gradual_warmup", (5e-4, 10, 0, 1.5, 100, 0.0, False)),
])
def test_schedules_match_jax(name, args):
    from dynamicvectorquantization_tpu.train import schedules as jax_schedules

    ours, ref = getattr(schedules, name)(*args), getattr(jax_schedules, name)(*args)
    for step in _STEPS:
        assert isinstance(ours(step), float)
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"{name}{args} at step {step}")


@pytest.mark.parametrize("kind", ["linear-warmup", "linear-warmup_cosine-decay",
                                  "lambda-warmup-cosine", "gradual-warmup"])
def test_make_schedule_matches_jax(kind):
    from dynamicvectorquantization_tpu.train import schedules as jax_schedules

    ours = schedules.make_schedule(kind, 5e-4, 10, 200, 1e-5)
    ref = jax_schedules.make_schedule(kind, 5e-4, 10, 200, 1e-5)
    for step in _STEPS:
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, atol=1e-12)
    with pytest.raises(NotImplementedError):
        schedules.make_schedule("no-such-schedule", 1e-3, 0, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 1024), (1027,), (3, 5, 7), (1,)])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_cuda_kernel_matches_plain(cuda_device, grad_dtype, shape, wd):
    r = np.random.default_rng(1)
    p0 = torch.from_numpy((0.02 * r.normal(size=shape)).astype(np.float32)).to(cuda_device)
    state = [[p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0),
              torch.empty_like(p0, dtype=torch.bfloat16)] for _ in range(2)]
    before = fused_adamw_step.launches
    for count in range(3):
        g = torch.from_numpy((1e-3 * r.normal(size=shape)).astype(np.float32)).to(
            cuda_device, grad_dtype)
        scal = adamw_scalars(count, 5e-4)
        fused_adamw_step(g, *state[0][:3], *scal, wd=wd, copy=state[0][3])
        fused_adamw_step_plain(g, *state[1][:3], *scal, wd=wd, copy=state[1][3])
        torch.cuda.synchronize()
        for a, b in zip(state[0][:3], state[1][:3]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
        assert torch.equal(state[0][3], state[0][0].to(torch.bfloat16))
    assert fused_adamw_step.launches == before + 3


@pytest.mark.cuda
def test_cuda_kernel_takes_unaligned_views_and_rejects_the_rest(cuda_device):
    flat = [torch.zeros(1030, device=cuda_device) for _ in range(4)]
    flat[0].normal_(generator=torch.Generator(device=cuda_device).manual_seed(0))
    views = [t[1:1028] for t in flat]  # 4-byte aligned only: the scalar path
    ref = [v.clone() for v in views]
    scal = adamw_scalars(0, 1e-3)
    fused_adamw_step(*views, *scal)
    fused_adamw_step_plain(*ref, *scal)
    for a, b in zip(views[1:], ref[1:]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    with pytest.raises(TypeError):
        fused_adamw_step(views[0].half(), *views[1:], *scal)
    with pytest.raises(ValueError):
        fused_adamw_step(flat[0][::2], flat[1][::2], flat[2][::2], flat[3][::2], *scal)
