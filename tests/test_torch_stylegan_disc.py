"""The two StyleGAN discriminators of the port (`nn/stylegan_discriminator.py`)
against the JAX package's, f32 on the CPU at tiny sizes: the port's
converters (`utils.weights.stylegan2_disc_state_dict_from_flax`,
`lucidrains_disc_state_dict_from_flax`) carry the JAX parameters in, the
JAX package's own (`utils/torch_ckpt.py` `convert_stylegan2_disc_state_dict`,
`convert_lucidrains_disc_state_dict`) carry them back to the same tree;
logits and input gradients 1e-5 relative + 1e-5 absolute. Each is then the
`disc_config` of a stage-1 step of the port (finite logs, the
discriminator's parameters moved). JAX is imported inside the tests; no jit.
"""
import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = {
    "stylegan2": ("StyleGAN2Discriminator", "stylegan2_disc_state_dict_from_flax",
                  "convert_stylegan2_disc_state_dict",
                  {"image_size": 32, "network_capacity": 2, "attn_layers": (1, 3)}),
    "lucidrains": ("LucidrainsDiscriminator", "lucidrains_disc_state_dict_from_flax",
                   "convert_lucidrains_disc_state_dict",
                   {"dim": 8, "discr_layers": 3, "groups": 4}),
}


def _images(seed, b=2):
    return np.random.default_rng(seed).uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_discriminator_matches_jax_and_converters_go_both_ways(case):
    import jax
    import jax.numpy as jnp

    import dynamicvectorquantization_tpu.nn.stylegan_discriminator as J
    from dynamicvectorquantization_tpu.utils import torch_ckpt
    from dynamicvectorquantization_torch.nn import stylegan_discriminator as P
    from dynamicvectorquantization_torch.utils import weights

    cls, to_port, to_jax, kw = CASES[case]
    jm = getattr(J, cls)(**kw)
    x = _images(0)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), x))
    sd = getattr(weights, to_port)(variables)
    pm = getattr(P, cls)(**kw)
    pm.load_state_dict(sd, strict=True)

    ref, pull = jax.vjp(lambda x: jm.apply(variables, x), jnp.asarray(x))
    (gx,) = pull(jnp.ones_like(ref))
    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    out = pm(xt, train=True)
    out.sum().backward()
    want = np.asarray(ref)
    if case == "lucidrains":  # NHWC (B, h, w, 1) against NCHW (B, 1, h, w)
        want = np.transpose(want, (0, 3, 1, 2))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx),
                               rtol=RTOL, atol=ATOL)

    back = getattr(torch_ckpt, to_jax)({k: v.numpy() for k, v in pm.state_dict().items()})
    a, b = _flat(back["params"]), _flat(variables["params"])
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))


@pytest.mark.parametrize("case", sorted(CASES))
def test_discriminator_trains_as_a_stage1_disc_config(case):
    """A fixed-length VQGAN's stage-1 step with the discriminator as its GAN
    loss's `disc_config` (no ActNorm, no batch statistics): finite logs, and
    the discriminator's parameters updated; seeded by flax's defaults."""
    from dynamicvectorquantization_torch.models.vqgan import VQModel
    from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer

    cls, _, _, kw = CASES[case]
    dd = {"z_channels": 8, "resolution": 32, "in_channels": 3, "out_ch": 3, "ch": 8,
          "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [16], "dropout": 0.0}
    module = "stylegan" if case == "stylegan2" else "stylegan_lucidrains"
    loss = {"target": "modules.losses.vqperceptual.VQLPIPSWithDiscriminator",
            "params": {"disc_start": 0, "disc_config": {
                "target": f"modules.discriminator.{module}.Discriminator", "params": kw}}}
    trainer = Stage1Trainer(VQModel(ddconfig=dd, lossconfig=loss, n_embed=16, embed_dim=8),
                            1e-3, device="cpu", seed=0)
    trainer.init_state(torch.Generator().manual_seed(1))
    disc = trainer.loss.discriminator
    assert type(disc).__name__ == cls and not disc.use_actnorm
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    logs = trainer.train_step(_images(1))
    assert all(np.isfinite(float(v)) for v in logs.values())
    assert logs["train_disc_factor"] == 1.0 and float(logs["train_disc_loss"]) > 0.0
    still = [k for k, p in disc.named_parameters() if torch.equal(before[k], p)]
    # a bias on the linear path to the logits has one gradient for every
    # image, and the hinge loss's real and fake halves cancel it exactly
    assert all(k.endswith(".bias") for k in still) and len(still) <= 3, still
