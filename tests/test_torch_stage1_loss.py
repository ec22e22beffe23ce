"""The stage-1 GAN objective in the PyTorch port against the JAX package on
converted weights and the same numpy inputs, f32, tolerance 1e-5 (absolute
and relative): LPIPS, the PatchGAN discriminator in evaluation and in
training (its BatchNorm `batch_stats` after one call included), the budget
loss with the reference bug and with the fix, the hinge / vanilla / bce
losses, and `nll`, `g_loss`, `d_loss`, `budget` of `VQLPIPSWithDiscriminator`.

JAX is imported inside the tests.
"""
import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.losses import vqperceptual as tl
from dynamicvectorquantization_torch.models.budget import BudgetConstraintRatioMSEDualGrain
from dynamicvectorquantization_torch.nn.discriminator import BatchNorm2d, NLayerDiscriminator
from dynamicvectorquantization_torch.nn.lpips import LPIPS, load_bundled_lin_heads
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.weights import (
    discriminator_state_dict_from_flax,
    lpips_state_dict_from_flax,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_CONFIG = {
    "target": "modules.losses.vqperceptual_multidisc.VQLPIPSWithDiscriminator",
    "params": {
        "disc_start": 2,
        "disc_config": {
            "target": "modules.discriminator.model.NLayerDiscriminator",
            "params": {"input_nc": 3, "ndf": 8, "n_layers": 2, "use_actnorm": False},
        },
        "disc_weight_max": 0.75,
        "budget_loss_config": {
            "target": "modules.dynamic_modules.budget.BudgetConstraint_RatioMSE_DualGrain",
            "params": {"target_ratio": 0.5, "gamma": 1.0, "min_grain_size": 2,
                       "max_grain_size": 4},
        },
    },
}


def _images(seed, b=2, size=32):
    r = np.random.default_rng(seed)
    return (r.uniform(-1, 1, size=(b, size, size, 3)).astype(np.float32),
            r.uniform(-1, 1, size=(b, size, size, 3)).astype(np.float32))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _perturbed(tree, seed, scale=0.05):
    """Every leaf plus seeded noise, so scales, biases and statistics are not
    at their trivial initial values."""
    import jax

    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * r.normal(size=np.shape(a)).astype(np.float32), tree)


# ------------------------------------------------------------------ LPIPS
def test_lpips_matches_jax():
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn.lpips import LPIPS as JLPIPS
    from dynamicvectorquantization_tpu.nn.lpips import load_bundled_lin_heads as jheads

    x, y = _images(0)
    jl = JLPIPS()
    params = jax.device_get(jl.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y)))["params"]
    params = {**params, **jax.device_get(jheads())}
    ref = jl.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))

    lp = LPIPS()
    missing = lp.load_state_dict(lpips_state_dict_from_flax(params), strict=False)
    assert sorted(missing.missing_keys) == ["scaling_layer.scale", "scaling_layer.shift"]
    assert not missing.unexpected_keys
    out = lp(_nchw(x), _nchw(y))
    assert out.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(out.numpy().reshape(-1), np.asarray(ref).reshape(-1), **TOL)
    assert not any(p.requires_grad for p in lp.parameters())


def test_bundled_lin_heads_equal_the_jax_package_s():
    import jax

    from dynamicvectorquantization_tpu.nn.lpips import load_bundled_lin_heads as jheads

    ours = load_bundled_lin_heads()
    ref = lpips_state_dict_from_flax(jax.device_get(jheads()))
    assert sorted(ours) == sorted(ref) and len(ours) == 5
    for k in ours:
        assert torch.equal(ours[k], ref[k]), k
    lp = LPIPS()
    lp.init_weights(torch.Generator().manual_seed(0))
    for k, v in ours.items():
        assert torch.equal(lp.state_dict()[k], v)


def test_lpips_passes_gradients_to_the_reconstruction_only():
    lp = LPIPS()
    lp.init_weights(torch.Generator().manual_seed(0))
    x, y = _images(1)
    yt = _nchw(y).requires_grad_()
    lp(_nchw(x), yt).sum().backward()
    assert yt.grad is not None and float(yt.grad.abs().max()) > 0
    assert all(p.grad is None for p in lp.parameters())


# ---------------------------------------------------------- discriminator
def _disc_pair(n_layers=2, ndf=8):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn.discriminator import NLayerDiscriminator as JDisc

    jd = JDisc(input_nc=3, ndf=ndf, n_layers=n_layers)
    variables = jax.device_get(jd.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    params = _perturbed(variables["params"], 2)
    stats = _perturbed(variables["batch_stats"], 3)
    stats = jax.tree.map(np.abs, stats)  # variances stay positive
    td = NLayerDiscriminator(input_nc=3, ndf=ndf, n_layers=n_layers)
    td.load_state_dict(discriminator_state_dict_from_flax(params, stats), strict=True)
    return jd, params, stats, td


@pytest.mark.parametrize("n_layers", [2, 3])
def test_discriminator_eval_matches_jax(n_layers):
    import jax.numpy as jnp

    jd, params, stats, td = _disc_pair(n_layers)
    x, _ = _images(4)
    ref = jd.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    before = {k: v.clone() for k, v in td.state_dict().items()}
    out = td(_nchw(x), train=False)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), np.asarray(ref), **TOL)
    for k, v in td.state_dict().items():
        assert torch.equal(v, before[k]), k  # evaluation moves no statistic


def test_discriminator_train_matches_jax_with_batch_stats():
    import jax.numpy as jnp

    jd, params, stats, td = _disc_pair()
    x, _ = _images(5)
    ref, mut = jd.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    out = td(_nchw(x), train=True)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), np.asarray(ref), **TOL)
    after = discriminator_state_dict_from_flax(params, mut["batch_stats"])
    sd = td.state_dict()
    moved = 0
    for k, v in after.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-6, err_msg=k)
            moved += 1
    assert moved == 4


def test_batchnorm_running_variance_is_the_biased_one():
    """Unlike `torch.nn.BatchNorm2d`, as flax's BatchNorm."""
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 4, 3, 3)).astype(np.float32))
    ours, theirs = BatchNorm2d(4, eps=1e-5, momentum=0.1), torch.nn.BatchNorm2d(4, eps=1e-5)
    y = ours(x, train=True)
    theirs.train()
    np.testing.assert_allclose(y.detach().numpy(), theirs(x).detach().numpy(), atol=1e-6)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(ours.running_var.numpy(), (0.9 + 0.1 * biased).numpy(), atol=1e-7)
    n = x.numel() / 4
    np.testing.assert_allclose(theirs.running_var.numpy(),
                               (0.9 + 0.1 * biased * n / (n - 1)).numpy(), atol=1e-6)
    np.testing.assert_allclose(ours.running_mean.numpy(), theirs.running_mean.numpy(), atol=1e-7)


def test_discriminator_init_and_unported_options():
    td = NLayerDiscriminator(ndf=8, n_layers=2)
    td.init_weights(torch.Generator().manual_seed(0))
    w = td.main[0].weight.detach()
    assert abs(float(w.std()) - 0.02) < 0.005 and float(td.main[0].bias.abs().max()) == 0.0
    assert torch.equal(td.main[3].weight, torch.ones(16))
    # ActNorm and the conditional discriminator are ported (held to JAX in
    # tests/test_torch_stage1_options.py): ActNorm's convs take a bias and its
    # loc / scale wait for data
    ta = NLayerDiscriminator(ndf=8, n_layers=2, use_actnorm=True)
    ta.init_weights(torch.Generator().manual_seed(0))
    assert ta.main[2].bias is not None and not ta.actnorm_initialized()
    ta.init_actnorm(torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(1)))
    assert ta.actnorm_initialized() and not torch.equal(ta.main[3].scale, torch.ones(1, 16, 1, 1))
    disc = dict(LOSS_CONFIG["params"]["disc_config"])
    disc["params"] = dict(disc["params"], input_nc=4)
    cond = tl.VQLPIPSWithDiscriminator(disc_config=disc, disc_conditional=True)
    y = torch.zeros(2, 32, 32, 3)
    with torch.no_grad():
        assert cond.g_loss(y, torch.ones(2, 32, 32, 1)).shape == ()


# ------------------------------------------------------------ budget, GAN
@pytest.mark.parametrize("fix", [False, True], ids=["reference-bug", "fixed"])
@pytest.mark.parametrize("calculate_all", [True, False])
def test_budget_loss_matches_jax(fix, calculate_all):
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.models.budget import (
        BudgetConstraintRatioMSEDualGrain as JBudget,
    )

    gate = np.random.default_rng(7).uniform(size=(2, 4, 4, 2)).astype(np.float32)
    kwargs = dict(target_ratio=0.4, gamma=2.0, min_grain_size=2, max_grain_size=4,
                  calculate_all=calculate_all, fix_reference_bug=fix)
    ref = JBudget(**kwargs)(jnp.asarray(gate))
    out = BudgetConstraintRatioMSEDualGrain(**kwargs)(torch.from_numpy(gate))
    np.testing.assert_allclose(float(out), float(ref), **TOL)
    hard = torch.stack([1 - (torch.from_numpy(gate)[..., 0] > 0.5).long(),
                        (torch.from_numpy(gate)[..., 0] > 0.5).long()], dim=-1)
    ref_hard = JBudget(**kwargs)(jnp.asarray(hard.numpy()))
    np.testing.assert_allclose(float(BudgetConstraintRatioMSEDualGrain(**kwargs)(hard)),
                               float(ref_hard), **TOL)


@pytest.mark.parametrize("name", ["hinge", "vanilla", "bce"])
def test_gan_losses_match_jax(name):
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.losses import vqperceptual as jl

    r = np.random.default_rng(8)
    real, fake = (3 * r.normal(size=(2, 6, 6, 1)).astype(np.float32) for _ in range(2))
    d_ref = getattr(jl, f"{name}_d_loss")(jnp.asarray(real), jnp.asarray(fake))
    d = getattr(tl, f"{name}_d_loss")(torch.from_numpy(real), torch.from_numpy(fake))
    np.testing.assert_allclose(float(d), float(d_ref), **TOL)
    g_name = "bce_g_loss" if name == "bce" else "hinge_g_loss"
    np.testing.assert_allclose(float(getattr(tl, g_name)(torch.from_numpy(fake))),
                               float(getattr(jl, g_name)(jnp.asarray(fake))), **TOL)
    assert tl._G_LOSSES[name] is getattr(tl, g_name)


def test_adopt_weight():
    assert tl.adopt_weight(1.0, 1, threshold=2) == 0.0
    assert tl.adopt_weight(1.0, 2, threshold=2) == 1.0


# ----------------------------------------------------- the whole objective
@pytest.fixture(scope="module")
def loss_pair():
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn.lpips import load_bundled_lin_heads as jheads
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    jloss = jinst(LOSS_CONFIG)
    x, _ = _images(9)
    variables = jax.device_get(jloss.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                                          jnp.asarray(x), train=False))
    params = dict(variables["params"])
    params["perceptual_loss"] = {**params["perceptual_loss"], **jax.device_get(jheads())}
    params["discriminator"] = _perturbed(params["discriminator"], 10)
    stats = {"discriminator": jax.tree.map(
        np.abs, _perturbed(variables["batch_stats"]["discriminator"], 11))}
    tloss = instantiate_from_config(LOSS_CONFIG)
    tloss.perceptual_loss.load_state_dict(
        lpips_state_dict_from_flax(params["perceptual_loss"]), strict=False)
    tloss.discriminator.load_state_dict(discriminator_state_dict_from_flax(
        params["discriminator"], stats["discriminator"]), strict=True)
    return jloss, {"params": params, "batch_stats": stats}, tloss


def test_nll_matches_jax(loss_pair):
    import jax.numpy as jnp

    jloss, variables, tloss = loss_pair
    x, y = _images(12)
    ref = jloss.apply(variables, jnp.asarray(x), jnp.asarray(y), method="nll")
    out = tloss.nll(torch.from_numpy(x), torch.from_numpy(y))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(float(a), float(b), **TOL)
    assert float(out[0]) == float(out[1])  # the same mean twice, as the JAX package logs it


@pytest.mark.parametrize("train", [False, True])
def test_g_loss_and_nll_and_g_match_jax(loss_pair, train):
    import jax.numpy as jnp

    jloss, variables, tloss = loss_pair
    x, y = _images(13)
    saved = {k: v.clone() for k, v in tloss.state_dict().items()}
    ref, _ = jloss.apply(variables, jnp.asarray(y), train=train, method="g_loss",
                         mutable=["batch_stats"])
    out = tloss.g_loss(torch.from_numpy(y), train=train)
    np.testing.assert_allclose(float(out), float(ref), **TOL)
    tloss.load_state_dict(saved)
    nll_ref, g_ref = jloss.apply(variables, jnp.asarray(x), jnp.asarray(y), method="nll_and_g")
    nll, g = tloss.nll_and_g(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(nll), float(nll_ref), **TOL)
    np.testing.assert_allclose(float(g), float(g_ref), **TOL)


@pytest.mark.parametrize("step", [1, 2], ids=["before-disc_start", "from-disc_start"])
def test_d_loss_matches_jax_with_batch_stats(loss_pair, step):
    import jax.numpy as jnp

    jloss, variables, tloss = loss_pair
    x, y = _images(14)
    saved = {k: v.clone() for k, v in tloss.state_dict().items()}
    (d_ref, log_ref), mut = jloss.apply(variables, jnp.asarray(x), jnp.asarray(y), step,
                                        train=True, method="d_loss", mutable=["batch_stats"])
    d, log = tloss.d_loss(torch.from_numpy(x), torch.from_numpy(y), step, train=True)
    np.testing.assert_allclose(float(d), float(d_ref), **TOL)
    assert (float(d) == 0.0) == (step < 2)
    for k in log_ref:
        np.testing.assert_allclose(float(log[k]), float(log_ref[k]), err_msg=k, **TOL)
    # real first, then fake: the statistics after both calls
    after = discriminator_state_dict_from_flax(variables["params"]["discriminator"],
                                               mut["batch_stats"]["discriminator"])
    sd = tloss.discriminator.state_dict()
    for k, v in after.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-6, err_msg=k)
    tloss.load_state_dict(saved)


def test_budget_through_the_loss_module(loss_pair):
    import jax.numpy as jnp

    jloss, variables, tloss = loss_pair
    gate = np.random.default_rng(15).uniform(size=(2, 4, 4, 2)).astype(np.float32)
    ref = jloss.apply(variables, jnp.asarray(gate), method="budget")
    np.testing.assert_allclose(float(tloss.budget(torch.from_numpy(gate))), float(ref), **TOL)
    no_budget = dict(LOSS_CONFIG["params"], budget_loss_config=None)
    assert float(tl.VQLPIPSWithDiscriminator(**no_budget).budget(torch.from_numpy(gate))) == 0.0
