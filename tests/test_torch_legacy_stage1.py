"""The fixed-length stage-1 baselines of the port (`nn/vqgan_codec.py`,
`ops/quantizers.py`, `ops/quantize_lucidrains.py`, `models/vqgan.py`) against
the JAX package's modules, f32 on the CPU at tiny sizes, on weights carried
across by `utils.weights.vqgan_state_dict_from_flax`.

Draws the two frameworks cannot share are fed in: JAX's Gumbel noise and
uniform draws are replaced by numpy arrays while its module runs, and the
port takes the same arrays (`noise=`, a patched generator draw); the restart
permutations of the EMA codebooks are the shared draw of
`tests/test_torch_stage1_train.py`.

Tolerances: quantizer outputs, losses and gradients 1e-5 relative + 1e-6
absolute (f32, different summation orders); the codec's latents and
reconstructions 2e-5 absolute (f32 towers of several levels, as the DQ-VAE
tests hold theirs to 1e-4); codes and remapped indices exactly; the two
trainer steps as `tests/test_torch_stage1_train.py` holds its first step
(logs 1e-5 relative, Adam moments 1e-5 of the largest entry, parameters 1e-6
absolute except entries whose Adam direction is decided by f32 noise, which
may differ by a whole update, 2 lr, on under 6 % of them; EMA buffers 1e-5).
Resume is bit-equal. JAX is imported inside the tests; two JAX jit compiles
(the two trainer steps).
"""
import os

import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-5, 1e-6
CODEC_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(a, b, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol, err_msg=what)


def _feats(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


class _Patched:
    """JAX's random functions replaced by fixed numpy draws while a flax
    module runs."""

    def __init__(self, **fns):
        self.fns = fns

    def __enter__(self):
        import jax

        self.mp = pytest.MonkeyPatch()
        for name, fn in self.fns.items():
            self.mp.setattr(jax.random, name, fn)
        return self

    def __exit__(self, *exc):
        self.mp.undo()


# ------------------------------------------------------------ quantizers
def _jax_grads(module, variables, z, extra=(), **kw):
    """(outputs, d(sum(x_q * w) + loss)/dz, the same / d params) of a flax quantizer."""
    import jax
    import jax.numpy as jnp

    w = jnp.asarray(_feats(99, z.shape))

    def f(params, z):
        (x_q, loss, info), _ = module.apply({**variables, "params": params}, z, *extra,
                                            mutable=True, **kw)
        return jnp.sum(x_q * w) + loss, (x_q, loss, info)

    (_, out), (gp, gz) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(z))
    return out, gz, gp, np.asarray(w)


def _port_grads(module, z, w, **kw):
    zt = torch.tensor(z, requires_grad=True)
    x_q, loss, info = module(zt, **kw)
    (x_q * torch.from_numpy(w)).sum().add(loss).backward()
    return (x_q, loss, info), zt.grad


@pytest.mark.parametrize("legacy", [True, False])
def test_vector_quantizer2_matches_jax(legacy):
    """Codes, loss (beta on the codebook term when `legacy`), the
    straight-through output, the gradients to z and to the codebook."""
    import jax

    from dynamicvectorquantization_tpu.ops.quantizers import VectorQuantizer2 as J
    from dynamicvectorquantization_torch.ops.quantizers import VectorQuantizer2

    z = _feats(0, (2, 4, 4, 8))
    jm = J(n_e=16, e_dim=8, beta=0.25, legacy=legacy, sane_index_shape=True, use_pallas=False)
    variables = jm.init(jax.random.PRNGKey(0), z)
    (xq, loss, info), gz, gp, w = _jax_grads(jm, variables, z)
    pm = VectorQuantizer2(n_e=16, e_dim=8, beta=0.25, legacy=legacy, sane_index_shape=True)
    pm.embedding.weight.data = torch.tensor(np.asarray(variables["params"]["embedding"]))
    (pxq, ploss, pinfo), pgz = _port_grads(pm, z, w)
    assert np.array_equal(pinfo[2].numpy(), np.asarray(info[2]))
    _close(pxq, xq, what="x_q")
    _close(ploss, loss, what="loss")
    _close(pgz, gz, what="dz")
    _close(pm.embedding.weight.grad, gp["embedding"], what="d codebook")


@pytest.mark.parametrize("unknown", ["random", "extra", 3])
def test_vector_quantizer2_remap_matches_jax(tmp_path, unknown):
    """`remap` with each unknown-index mode; flattened (N, 1) codes without
    `sane_index_shape`; `get_codebook_entry` maps the positions back."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.quantizers import VectorQuantizer2 as J
    from dynamicvectorquantization_torch.ops.quantizers import VectorQuantizer2

    used = np.array([1, 3, 4, 7, 8, 10, 12, 15])
    path = str(tmp_path / "used.npy")
    np.save(path, used)
    z = _feats(1, (2, 4, 4, 8))
    jm = J(n_e=16, e_dim=8, remap=path, unknown_index=unknown, use_pallas=False)
    variables = jm.init({"params": jax.random.PRNGKey(0), "rng": jax.random.PRNGKey(1)}, z)
    fill = np.random.default_rng(5).integers(0, len(used), size=(2, 4, 4))
    with _Patched(randint=lambda key, shape, lo, hi: jnp.asarray(fill)):
        _, _, info = jm.apply(variables, z, rngs={"rng": jax.random.PRNGKey(2)})
    pm = VectorQuantizer2(n_e=16, e_dim=8, remap=path, unknown_index=unknown)
    pm.embedding.weight.data = torch.tensor(np.asarray(variables["params"]["embedding"]))
    mp = pytest.MonkeyPatch()
    mp.setattr(torch, "randint", lambda lo, hi, shape, **k: torch.from_numpy(fill))
    try:
        _, _, pinfo = pm(torch.from_numpy(z))
    finally:
        mp.undo()
    assert pinfo[2].shape == (32, 1)
    assert np.array_equal(pinfo[2].numpy(), np.asarray(info[2]))
    back = jm.apply(variables, jnp.asarray(info[2][:, 0]), method=jm.get_codebook_entry)
    _close(pm.get_codebook_entry(pinfo[2][:, 0]), back, rtol=0, atol=0)


def test_vector_quantizer_and_gumbel_match_jax():
    """taming's VectorQuantizer; GumbelQuantize in training on JAX's noise
    (straight-through one-hot, KL term) and in evaluation."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.quantizers import GumbelQuantize as JG
    from dynamicvectorquantization_tpu.ops.quantizers import VectorQuantizer as JV
    from dynamicvectorquantization_torch.ops.quantizers import GumbelQuantize, VectorQuantizer

    z = _feats(2, (2, 4, 4, 8))
    jm = JV(n_e=16, e_dim=8, use_pallas=False)
    variables = jm.init(jax.random.PRNGKey(0), z)
    (xq, loss, info), gz, gp, w = _jax_grads(jm, variables, z)
    pm = VectorQuantizer(n_e=16, e_dim=8)
    pm.embedding.weight.data = torch.tensor(np.asarray(variables["params"]["embedding"]))
    (pxq, ploss, pinfo), pgz = _port_grads(pm, z, w)
    assert np.array_equal(pinfo[2].numpy(), np.asarray(info[2]))
    for a, b, what in ((pxq, xq, "x_q"), (ploss, loss, "loss"), (pgz, gz, "dz"),
                       (pm.embedding.weight.grad, gp["embedding"], "d codebook")):
        _close(a, b, what=what)

    jg = JG(num_hiddens=8, embedding_dim=6, n_embed=16, kl_weight=5e-4, temp_init=1.0)
    gv = jg.init({"params": jax.random.PRNGKey(3), "gumbel": jax.random.PRNGKey(4)}, z)
    noise = -np.log(-np.log(np.random.default_rng(6).uniform(1e-6, 1.0, (2, 4, 4, 16))))
    noise = noise.astype(np.float32)
    pg = GumbelQuantize(num_hiddens=8, embedding_dim=6, n_embed=16)
    pg.proj.weight.data = torch.tensor(np.transpose(np.asarray(gv["params"]["proj"]["kernel"]),
                                                    (3, 2, 0, 1)))
    pg.proj.bias.data = torch.tensor(np.asarray(gv["params"]["proj"]["bias"]))
    pg.embed.weight.data = torch.tensor(np.asarray(gv["params"]["embedding"]))
    w6 = _feats(98, (2, 4, 4, 6))
    for train in (True, False):
        with _Patched(gumbel=lambda key, shape, *a, **k: jnp.asarray(noise)):
            def f(params, z):
                x_q, kl, info = jg.apply({"params": params}, z, train=train,
                                         rngs={"gumbel": jax.random.PRNGKey(5)})
                return jnp.sum(x_q * w6) + kl, (x_q, kl, info)

            (_, (xq, kl, info)), (gp, gz) = jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True)(gv["params"], jnp.asarray(z))
        pg.zero_grad()
        zt = torch.tensor(z, requires_grad=True)
        pxq, pkl, pinfo = pg(zt, train=train, noise=torch.from_numpy(noise))
        (pxq * torch.from_numpy(w6)).sum().add(pkl).backward()
        assert np.array_equal(pinfo[2].numpy(), np.asarray(info[2])), train
        _close(pxq, xq, what=f"gumbel x_q {train}")
        _close(pkl, kl, what=f"gumbel kl {train}")
        _close(zt.grad, gz, what=f"gumbel dz {train}")
        _close(pg.embed.weight.grad, gp["embedding"], what=f"gumbel d embed {train}")


def _shared_restart():
    from tests.test_torch_stage1_train import _port_draw, _shared_draw

    return _port_draw, _shared_draw


def _jax_restart_patch():
    import jax.numpy as jnp

    _, shared = _shared_restart()
    return _Patched(permutation=lambda key, n: jnp.asarray(shared(n, None)[1]),
                    uniform=lambda key, shape, *a, **k: jnp.asarray(shared(1, shape)[0]))


def _ema_tensors(variables):
    from dynamicvectorquantization_torch.utils.weights import vqgan_state_dict_from_flax

    return {k[len("quantize."):]: v for k, v in vqgan_state_dict_from_flax(
        {"ema": {"quantize": variables["ema"]}}).items()}


@pytest.mark.parametrize("shared", [True, False])
def test_rq_bottleneck_depth4_updates_in_sequence_as_jax(shared):
    """RQBottleneck at depth 4 in training: each depth searches the codebook
    the depth before it updated (one shared codebook) or its own; codes,
    output, commitment loss and the codebooks after the forward equal JAX's;
    a `commit=False` forward returns the same and puts the buffers back."""
    import jax

    from dynamicvectorquantization_tpu.ops.quantizers import RQBottleneck as J
    from dynamicvectorquantization_torch.ops.quantizers import RQBottleneck

    port_draw, _ = _shared_restart()
    z = _feats(3, (2, 4, 4, 8))
    kw = dict(latent_shape=(4, 4, 8), code_shape=(4, 4, 4), n_embed=16, shared_codebook=shared)
    jm = J(**kw, use_pallas=False)
    variables = jm.init(jax.random.PRNGKey(0), z)
    with _jax_restart_patch():
        (xq, loss, info), mut = jm.apply(variables, z, train=True, mutable=["ema"],
                                         rngs={"vq": jax.random.PRNGKey(1)})
    pm = RQBottleneck(**kw)
    pm.load_state_dict(_ema_tensors(variables))
    for book in pm.codebooks():
        book._draw_restart = port_draw
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    sxq, sloss, sinfo = pm(torch.from_numpy(z), train=True, commit=False)
    assert all(torch.equal(before[k], v) for k, v in pm.state_dict().items())
    pxq, ploss, pinfo = pm(torch.from_numpy(z), train=True)
    assert pinfo[2].shape == (2, 4, 4, 4)
    assert np.array_equal(pinfo[2].numpy(), np.asarray(info[2]))
    assert torch.equal(sinfo[2], pinfo[2]) and torch.equal(sxq, pxq)
    _close(pxq, xq, what="x_q")
    _close(ploss, loss, what="loss")
    after = _ema_tensors(mut)
    assert sorted(after) == sorted(pm.state_dict())
    for k, v in after.items():
        _close(pm.state_dict()[k], v, what=k)
    assert not torch.equal(before["codebook_0.codebook.weight" if not shared else
                                  "codebook_shared.codebook.weight"],
                           pm.state_dict()["codebook_0.codebook.weight" if not shared else
                                           "codebook_shared.codebook.weight"])
    _close(pm.get_codebook_entry(pinfo[2]),
           jm.apply(mut | {"params": {}}, info[2], method=jm.get_codebook_entry))


def test_ema_vector_quantizer_matches_jax():
    import jax

    from dynamicvectorquantization_tpu.ops.quantizers import EMAVectorQuantizer as J
    from dynamicvectorquantization_torch.ops.quantizers import EMAVectorQuantizer

    z = _feats(4, (2, 4, 4, 8))
    jm = J(n_embed=16, embedding_dim=8)
    variables = jm.init(jax.random.PRNGKey(0), z)
    (xq, loss, info), mut = jm.apply(variables, z, train=True, mutable=["ema"])
    pm = EMAVectorQuantizer(n_embed=16, embedding_dim=8)
    pm.load_state_dict(_ema_tensors(variables))
    zt = torch.tensor(z, requires_grad=True)
    pxq, ploss, pinfo = pm(zt, train=True)
    ploss.backward()
    assert np.array_equal(pinfo[2].numpy(), np.asarray(info[2]))
    _close(pxq, xq, what="x_q")
    _close(ploss, loss, what="loss")
    _close(zt.grad, jax.grad(lambda z: jm.apply(variables, z, train=True,
                                                 mutable=["ema"])[0][1])(z), what="dz")
    for k, v in _ema_tensors(mut).items():
        _close(pm.state_dict()[k], v, what=k)


@pytest.mark.parametrize("case", ["kmeans_l2", "cosine_masked_gumbel"])
def test_mask_vector_quantize_matches_jax(case):
    """MaskVectorQuantize: the kmeans init from the first batch (JAX's
    permutation fed in) with the L2 search (#1's plain version) and the
    orthogonal term; the cosine search with JAX's Gumbel assignment at temp
    > 0 and the masked commitment."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.quantizers import MaskVectorQuantize as J
    from dynamicvectorquantization_torch.ops.quantizers import MaskVectorQuantize

    z = _feats(5, (2, 4, 4, 8))
    cosine = case != "kmeans_l2"
    kw = dict(codebook_size=16, codebook_dim=8, kmeans_init=not cosine, kmeans_iters=3,
              use_cosine_sim=cosine, orthogonal_reg_weight=0.0 if cosine else 0.1)
    perm = np.random.default_rng(8).permutation(32)
    u = np.random.default_rng(9).uniform(1e-9, 1 - 1e-9, (32, 16)).astype(np.float32)
    jm = J(**kw)
    with _Patched(permutation=lambda key, n: jnp.asarray(perm[:n])):
        variables = jm.init(jax.random.PRNGKey(0), z)
    pm = MaskVectorQuantize(**kw)
    gen = torch.Generator().manual_seed(0)
    mp = pytest.MonkeyPatch()
    mp.setattr(torch, "randperm", lambda n, **k: torch.from_numpy(perm[:n]))
    try:
        pm.init_codebook(gen)
        pm.init_from_features(torch.from_numpy(z), gen)
    finally:
        mp.undo()
    if not cosine:
        _close(pm.embedding.weight, variables["params"]["embedding"], what="kmeans init")
    pm.embedding.weight.data = torch.tensor(np.asarray(variables["params"]["embedding"]))
    mask = None
    temp, train = 0.0, False
    if cosine:
        mask = (np.random.default_rng(10).uniform(size=(2, 4, 4, 1)) > 0.4).astype(np.float32)
        temp, train = 0.5, True
    extra = () if mask is None else (jnp.asarray(mask),)
    real = jax.random.uniform  # flax checks the initializer's shape on apply

    def uniform(key, shape, *a, **k):
        return jnp.asarray(u) if tuple(shape) == u.shape else real(key, shape, *a, **k)

    with _Patched(uniform=uniform):
        (xq, loss, info), gz, gp, w = _jax_grads(jm, variables, z, extra, temp=temp,
                                                 train=train, rngs={"vq": jax.random.PRNGKey(1)})
    noise = torch.from_numpy(-np.log(-np.log(u)))
    (pxq, ploss, pinfo), pgz = _port_grads(
        pm, z, w, codebook_mask=None if mask is None else torch.from_numpy(mask), temp=temp,
        train=train, noise=noise)
    assert np.array_equal(pinfo[2].numpy(), np.asarray(info[2]))
    for a, b, what in ((pxq, xq, "x_q"), (ploss, loss, "loss"), (pgz, gz, "dz"),
                       (pm.embedding.weight.grad, gp["embedding"], "d codebook")):
        _close(a, b, what=what)


def test_kmeans_and_lucidrains_quantizer_match_jax():
    """`kmeans` with JAX's permutation; LucidrainsVectorQuantize's first
    training forward (kmeans init, search, EMA update, dead codes replaced
    by JAX's row draw) and an evaluation forward after it."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.ops.quantize_lucidrains import (
        LucidrainsVectorQuantize as J,
    )
    from dynamicvectorquantization_tpu.ops.quantize_lucidrains import kmeans as jkmeans
    from dynamicvectorquantization_torch.ops.quantize_lucidrains import (
        LucidrainsVectorQuantize,
        kmeans,
    )

    z = _feats(6, (2, 4, 4, 8))
    perm = np.random.default_rng(11).permutation(32)
    rows = np.random.default_rng(12).integers(0, 32, size=16)
    for cosine in (False, True):
        with _Patched(permutation=lambda key, n: jnp.asarray(perm[:n])):
            ref = jkmeans(jax.random.PRNGKey(0), jnp.asarray(z.reshape(32, 8)), 16, 4, cosine)
        mp = pytest.MonkeyPatch()
        mp.setattr(torch, "randperm", lambda n, **k: torch.from_numpy(perm[:n]))
        try:
            got = kmeans(torch.from_numpy(z.reshape(32, 8)), 16, 4, cosine)
        finally:
            mp.undo()
        _close(got, ref, what=f"kmeans cosine={cosine}")

    jm = J(codebook_size=16, dim=8, kmeans_iters=3, threshold_ema_dead_code=2, use_pallas=False)
    variables = jm.init(jax.random.PRNGKey(0), z)
    with _Patched(permutation=lambda key, n: jnp.asarray(perm[:n]),
                  randint=lambda key, shape, lo, hi: jnp.asarray(rows)):
        (xq, loss, info), mut = jm.apply(variables, z, train=True, mutable=["ema"],
                                         rngs={"vq": jax.random.PRNGKey(1)})
    pm = LucidrainsVectorQuantize(codebook_size=16, dim=8, kmeans_iters=3)
    pm.load_state_dict(_ema_tensors(variables))
    mp = pytest.MonkeyPatch()
    mp.setattr(torch, "randperm", lambda n, **k: torch.from_numpy(perm[:n]))
    mp.setattr(torch, "randint", lambda lo, hi, shape, **k: torch.from_numpy(rows))
    try:
        pxq, ploss, pinfo = pm(torch.from_numpy(z), train=True)
    finally:
        mp.undo()
    assert np.array_equal(pinfo[2].numpy(), np.asarray(info[2]))
    _close(pxq, xq, what="x_q")
    _close(ploss, loss, what="loss")
    for k, v in _ema_tensors(mut).items():
        _close(pm.state_dict()[k], v, what=k)
    assert bool(pm.initted)
    _, _, info2 = jm.apply(mut, z)
    assert np.array_equal(pm(torch.from_numpy(z))[2][2].numpy(), np.asarray(info2[2]))


# ------------------------------------------------------------ codec, models
DD = {"double_z": False, "z_channels": 8, "resolution": 32, "in_channels": 3, "out_ch": 3,
      "ch": 8, "ch_mult": [1, 2, 2], "num_res_blocks": 1, "attn_resolutions": [8],
      "dropout": 0.0}
LOSS = {"target": "modules.losses.vqperceptual_multidisc.VQLPIPSWithDiscriminator",
        "params": {"disc_start": 0, "disc_weight_max": 0.75, "codebook_weight": 1.0,
                   "disc_config": {"target": "modules.discriminator.model.NLayerDiscriminator",
                                   "params": {"input_nc": 3, "ndf": 8, "n_layers": 2,
                                              "use_actnorm": False}}}}
RQ = {"target": "modules.vector_quantization.quantize_rqvae.RQBottleneck",
      "params": {"latent_shape": [8, 8, 8], "code_shape": [8, 8, 4], "n_embed": 64,
                 "shared_codebook": True, "restart_unused_codes": True}}
MODELS = {
    "vq": ("models.stage1.vqgan.VQModel", {"ddconfig": DD, "n_embed": 32, "embed_dim": 8}),
    "vq2_gumbel_dd": ("models.stage1.vqgan.VQModel", {
        "ddconfig": {**DD, "give_pre_end": False}, "embed_dim": 8,
        "vqconfig": {"target": "modules.vector_quantization.quantize_vqgan.GumbelQuantize",
                     "params": {"num_hiddens": 8, "embedding_dim": 8, "n_embed": 16}}}),
    "multivq": ("models.stage1.vqgan_multivq.VQModel", {
        "encoderconfig": {"params": DD}, "decoderconfig": {"params": DD},
        "vqconfig": {"target": "modules.vector_quantization.quantize_vqgan.EMAVectorQuantizer",
                     "params": {"n_embed": 32, "embedding_dim": 8}},
        "quant_before_dim": 8, "quant_after_dim": 8}),
    "rq": ("models.stage1.rqvae.RQModel", {"ddconfig": DD, "rqconfig": RQ, "embed_dim": 8}),
}


def _images(seed, b=2):
    return np.random.default_rng(seed).uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)


def _build(name, loss=None):
    """(JAX model, its variables, the port model holding them)."""
    import jax

    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
    from dynamicvectorquantization_torch.utils.weights import vqgan_state_dict_from_flax

    target, params = MODELS[name]
    cfg = {"target": target, "params": {**params, "lossconfig": loss}}
    jmodel = jinst(cfg)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0), _images(0, 1)))
    model = instantiate_from_config(cfg)
    model.load_state_dict(vqgan_state_dict_from_flax(variables), strict=True)
    return jmodel, variables, model


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_forward_encode_decode_match_jax(name):
    """Each model (and with it the codec) in evaluation: reconstruction,
    quantizer loss and codes equal JAX's; decoding the looked-up codes
    (`get_code_emb_with_depth`) gives `forward`'s reconstruction; the
    encoder's and decoder's outputs alone match too."""
    import jax.numpy as jnp

    jmodel, variables, model = _build(name)
    x = _images(1)
    dec, diff, codes, gate, ent = jmodel.forward(variables, jnp.asarray(x))
    with torch.no_grad():
        pdec, pdiff, pcodes, pgate, pent = model(torch.from_numpy(x))
        assert pgate is None and pent is None and gate is None
        assert np.array_equal(pcodes.numpy(), np.asarray(codes))
        _close(pdec, dec, atol=CODEC_ATOL, what="reconstruction")
        _close(pdiff, diff, what="quantizer loss")
        emb = model.get_code_emb_with_depth(pcodes)
        _close(model.decode(emb), pdec, atol=CODEC_ATOL, what="codes -> decode")
        quant = model.encode(torch.from_numpy(x))[0]
        jquant = jmodel.net.apply(variables, jnp.asarray(x), method="encode")[0]
        _close(quant, jquant, atol=CODEC_ATOL, what="encode")
        pre, out = model.decode(quant, return_pre_out=True)[::-1]
        assert out.shape == (2, 32, 32, 3) and pre.shape == (2, 8, 32, 32)


def test_taming_names_load_with_load_state_dict(tmp_path):
    """The port VQModel carries taming's state_dict names; a reference-style
    `.ckpt` (`{"state_dict": ...}`) loads into it through the stage-1
    loader."""
    from dynamicvectorquantization_torch.models.vqgan import VQModel
    from dynamicvectorquantization_torch.utils.model_loading import load_first_stage

    model = VQModel(ddconfig=DD, lossconfig=None, n_embed=32, embed_dim=8)
    sd = model.state_dict()
    for key in ("encoder.down.0.block.0.norm1.weight", "encoder.mid.attn_1.q.weight",
                "encoder.down.1.downsample.conv.weight", "decoder.up.1.upsample.conv.weight",
                "decoder.up.2.attn.0.proj_out.weight", "decoder.mid.block_2.conv2.bias",
                "quant_conv.weight", "post_quant_conv.weight", "quantize.embedding.weight",
                "encoder.conv_out.weight", "decoder.norm_out.bias"):
        assert key in sd, key
    ref = {k: torch.randn_like(v) for k, v in sd.items()}
    path = str(tmp_path / "vqgan.ckpt")
    torch.save({"state_dict": ref}, path)
    other = VQModel(ddconfig=DD, lossconfig=None, n_embed=32, embed_dim=8)
    load_first_stage(other, path)
    assert all(torch.equal(other.state_dict()[k], ref[k]) for k in ref)


def test_full_width_ymls_build_in_both_packages():
    """The two full-width ymls inside the port resolve and build in the JAX
    package and in the port (on the meta device), with the published widths."""
    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_torch.config.yaml_config import load_config
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "dynamicvectorquantization_torch", "configs", "stage1")
    want = {"vqgan_imagenet_f16_1024.yml": (1024, (16, 16)),
            "rqvae_imagenet_8x8x4.yml": (16384, (8, 8, 4))}
    for name, (codes, shape) in want.items():
        path = os.path.join(root, name)
        jinst(jload([path])["model"])
        with torch.device("meta"):
            model = instantiate_from_config(load_config([path])["model"])
        books = [m for m in model.quantize.modules() if hasattr(m, "codebook")] or [
            model.quantize]
        rows = (books[0].codebook.weight.shape[0] - 1 if hasattr(books[0], "codebook")
                else books[0].embedding.weight.shape[0])
        assert rows == codes, name
        assert model.image_size == 256 and model.loss.discriminator is not None
        if len(shape) == 3:
            assert model.quantize.code_shape == shape


# ------------------------------------------------------------ trainer steps
LR = 1e-3


# (model, learning rate) of each trainer step held to JAX. "rq" takes no
# restarts and holds the update. "rq_restart" restarts codes at every depth
# of both passes (from `_mid_training_ema`), at learning rate 0: on a step
# of 1e-3 Adam moves the parameters whose gradients are f32 noise by +-lr,
# the sign decided by the noise (see `test_trainer_step_state_matches_jax`),
# and the discriminator pass's reconstructions move with them. With no
# update both packages' discriminator passes run the same parameters, and
# its codes, logs and gradients tell whether its restart draws repeat the
# autoencoder pass's.
STEP_CASES = {
    "vq": (MODELS["vq"], LR),
    "rq": (("models.stage1.rqvae.RQModel", {
        "ddconfig": DD, "embed_dim": 8,
        "rqconfig": {**RQ, "params": {**RQ["params"], "restart_unused_codes": False}}}), LR),
    "rq_restart": (MODELS["rq"], 0.0),
}


class _DepthDraws:
    """Restart draws that tell a trainer step's two passes apart. JAX gives
    both passes one key, so depth d draws the same numbers in each: the d-th
    draw of a traced forward (`calls % depth`, the step jitted once) takes
    draw d. The port draws from its generator: the i-th generator state it
    meets takes draw i, so a discriminator pass that replays the autoencoder
    pass's states repeats its draws, and one that drew afresh takes draws
    depth, depth + 1, ... and other restarted codes."""

    def __init__(self, depth):
        self.depth, self.calls, self.states = depth, 0, {}

    @staticmethod
    def numbers(i, pool_rows, noise_shape):
        noise = (None if noise_shape is None else np.random.default_rng((i, pool_rows, 1))
                 .uniform(size=noise_shape).astype(np.float32))
        return noise, np.random.default_rng((i, pool_rows, 0)).permutation(pool_rows)

    def port(self, pool_rows, noise_shape, generator, device):
        i = self.states.setdefault(generator.get_state().numpy().tobytes(), len(self.states))
        torch.rand(1, generator=generator)  # moves on as a real draw does
        noise, perm = self.numbers(i, pool_rows, noise_shape)
        return (None if noise is None else torch.from_numpy(noise)), torch.from_numpy(perm)

    def jax_patch(self):
        import jax.numpy as jnp

        def permutation(key, n):
            i = self.calls % self.depth
            self.calls += 1
            return jnp.asarray(self.numbers(i, n, None)[1])

        def uniform(key, shape, *a, **k):  # the jitter comes before its permutation
            return jnp.asarray(self.numbers(self.calls % self.depth, shape[0], shape)[0])

        return _Patched(permutation=permutation, uniform=uniform)


def _mid_training_ema(ema, unused=32):
    """The shared RQ codebook as training leaves it: codes spread like the
    latents with counts of 2, kept at every depth, and the last `unused`
    with none, restarted. (At init every code restarts at depth 0 from the
    latents themselves, and depth 1 then ranks codes that are copies of its
    own rows: scores |c - r|^2 - |r|^2 equal to f32 rounding.)"""
    book = ema["quantize"]["codebook_shared"]
    k, d = book["embed_ema"].shape
    codes = (1.2 * np.random.default_rng(3).normal(size=(k, d))).astype(np.float32)
    counts = np.full(k, 2.0, np.float32)
    counts[-unused:] = 0.0
    book = {"codebook": np.concatenate([codes, np.zeros((1, d), np.float32)]),
            "embed_ema": codes * counts[:, None], "cluster_size_ema": counts}
    return {"quantize": {"codebook_shared": book}}


def _trainers(name):
    """(JAX trainer, initial state, the port trainer in that state)."""
    import jax

    from dynamicvectorquantization_tpu.train.stage1 import Stage1Trainer as JTrainer
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
    from dynamicvectorquantization_torch.utils.weights import (
        load_stage1_state,
        stage1_state_from_flax,
    )

    (target, params), lr = STEP_CASES[name]
    cfg = {"target": target, "params": {**params, "lossconfig": LOSS}}
    jtrainer = JTrainer(jinst(cfg), learning_rate=lr, warmup_steps=0, max_steps=100)
    state = jax.device_get(jtrainer.init_state(jax.random.PRNGKey(1), _images(0, 1)))
    if name == "rq_restart":
        state = state._replace(ema=_mid_training_ema(state.ema))
    trainer = Stage1Trainer(instantiate_from_config(cfg), lr, warmup_steps=0, max_steps=100,
                            device="cpu")
    load_stage1_state(trainer, stage1_state_from_flax(state))
    draws = _DepthDraws(RQ["params"]["code_shape"][-1])
    for mod in trainer.model.modules():
        if hasattr(mod, "_draw_restart"):
            mod._draw_restart = draws.port
    return jtrainer, state, trainer, draws


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def one_step(request):
    """One JAX step (jitted, the restart draws of `_DepthDraws`) and one port step from
    the same state on the same batch."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_torch.utils.weights import stage1_state_from_flax

    jtrainer, state, trainer, draws = _trainers(request.param)
    x = _images(2)
    with draws.jax_patch():
        jstate, jlogs = jax.jit(jtrainer.train_step)(state, jnp.asarray(x),
                                                     jax.random.PRNGKey(10))
        jstate = jax.device_get(jstate)
    logs = trainer.train_step(x, torch.Generator().manual_seed(0))
    if request.param == "rq_restart":  # both passes drew, depth by depth
        assert draws.calls == 2 * draws.depth and len(draws.states) == draws.depth
    return (request.param, stage1_state_from_flax(jstate),
            {k: float(v) for k, v in jlogs.items()}, trainer,
            {k: float(v) for k, v in logs.items()})


def test_trainer_step_logs_match_jax(one_step):
    """The logs, with the code indices' `train_fine_ratio` (JAX logs
    mean(codes > 0) for a fixed-length model) and no budget."""
    name, _, jlogs, _, logs = one_step
    assert sorted(logs) == sorted(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(logs[k], v, rtol=1e-5, atol=1e-6, err_msg=f"{name} {k}")
    assert logs["train_budget_loss"] == 0.0 and 0.0 < logs["train_fine_ratio"] <= 1.0


def test_trainer_step_state_matches_jax(one_step):
    """Adam moments, parameters (the gradient-trained codebook among them)
    and the EMA codebooks after one step."""
    from tests.test_torch_stage1_train import _assert_moments

    name, ref, _, trainer, _ = one_step
    for opt in ("ae_opt", "disc_opt"):
        count_r, m_r, v_r = ref[opt]
        mine = getattr(trainer, opt)
        assert mine.count == count_r == 1
        _assert_moments(mine.m, m_r, 1e-5, f"{name} {opt} m")
        _assert_moments(mine.v, v_r, 1e-5, f"{name} {opt} v")
    sd = trainer.model.state_dict()
    moments = {"": ref["ae_opt"][1],
               "loss.discriminator.": ref["disc_opt"][1]}
    flipped = total = 0
    for prefix, m_ref in moments.items():
        scale = max(float(t.abs().max()) for t in m_ref.values())
        for k, m in m_ref.items():
            ours, theirs = sd[prefix + k].numpy(), ref["state_dict"][prefix + k].numpy()
            diff = np.abs(ours - theirs)
            off = diff > 1e-6
            assert np.all(diff[off] <= 2.02 * STEP_CASES[name][1]), k
            assert np.all(np.abs(m.numpy()[off]) < 1e-4 * scale), k
            flipped += int(off.sum())
            total += diff.size
    assert flipped <= 0.06 * total
    params = {p + k for p, m in moments.items() for k in m}
    for k, v in ref["state_dict"].items():  # EMA codebooks, BatchNorm statistics, LPIPS
        if k not in params and not k.endswith("num_batches_tracked"):  # a torch counter
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    if name == "vq":
        assert "quantize.embedding.weight" in trainer.ae_params
        assert float(trainer.ae_opt.m["quantize.embedding.weight"].abs().max()) > 0


def test_trainer_resume_is_bit_equal(tmp_path):
    """Two port steps equal one step, a save / load into a new trainer, and
    a second step, bit for bit (the gradient-trained codebook's backward is
    a GEMM, no float atomics); the discriminator pass draws what the
    autoencoder pass drew."""
    from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    def fresh():
        target, params = MODELS["rq"]
        cfg = {"target": target, "params": {**params, "lossconfig": LOSS}}
        t = Stage1Trainer(instantiate_from_config(cfg), LR, max_steps=100, device="cpu", seed=3)
        return t.init_state(torch.Generator().manual_seed(4))

    xs = [_images(5), _images(6)]
    whole = fresh()
    for x in xs:
        whole.train_step(x)
    first = fresh()
    first.train_step(xs[0])
    path = str(tmp_path / "s.pt")
    torch.save(first.state_dict(), path)
    second = fresh()
    second.load_state_dict(torch.load(path, weights_only=True))
    second.train_step(xs[1])
    a, b = whole.state_dict(), second.state_dict()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for opt in ("ae_opt", "disc_opt"):
        for kind in ("m", "v"):
            assert all(torch.equal(a[opt][kind][k], b[opt][kind][k]) for k in a[opt][kind])
    assert torch.equal(a["generator"], b["generator"])


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    """The card with TF32 off; the backend flags a test sets are put back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = [(torch.backends.cuda.matmul, "allow_tf32"), (torch.backends.cudnn, "allow_tf32"),
             (torch.backends.cudnn, "deterministic"), (torch.backends.cudnn, "benchmark")]
    saved = [getattr(m, a) for m, a in flags]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    for (m, a), v in zip(flags, saved):
        setattr(m, a, v)


@pytest.mark.cuda
def test_cuda_use_pallas_false_still_launches_the_kernels(cuda_device):
    """`use_pallas: False` (a JAX yml's key) does not send a card tensor to
    the plain search, statistics or entropy: the kernels' counts rise."""
    from dynamicvectorquantization_torch.ops.entropy import patch_entropy
    from dynamicvectorquantization_torch.ops.quantizers import VectorQuantizer2
    from dynamicvectorquantization_torch.ops.vq import (
        VectorQuantizeEMA, nearest_codes, nearest_codes_with_stats)

    r = np.random.default_rng(0)
    z = torch.from_numpy(r.normal(size=(2, 4, 4, 8)).astype(np.float32)).to(cuda_device)
    ema = VectorQuantizeEMA(codebook_size=16, codebook_dim=8, use_pallas=False)
    ema.init_codebook(torch.Generator().manual_seed(0))
    ema.to(cuda_device)
    grad = VectorQuantizer2(n_e=16, e_dim=8, use_pallas=False).to(cuda_device)
    before = (nearest_codes.launches, nearest_codes_with_stats.launches, patch_entropy.launches)
    ema(z, train=True, generator=torch.Generator(cuda_device).manual_seed(1))
    grad(z)
    patch_entropy(torch.rand(1, 32, 32, 3, device=cuda_device) * 2 - 1, use_pallas=False)
    after = (nearest_codes.launches, nearest_codes_with_stats.launches, patch_entropy.launches)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(2048, 1024), (512, 16384)])
def test_cuda_search_and_statistics_at_the_baselines_shapes(cuda_device, n, k):
    """#1 and #2 at the VQGAN's (2,048 rows, 1,024 codes) and the RQ-VAE's
    (512 rows, 16,384 codes: the statistics' limit) shapes against the plain
    versions: codes equal (N(0, 1) codes, no near-ties), counts exact, sums
    within 1e-5 of the largest, bit-identical from call to call."""
    from dynamicvectorquantization_torch.ops.vq import (
        MAX_CODES_WITH_STATS, nearest_codes, nearest_codes_plain, nearest_codes_with_stats,
        nearest_codes_with_stats_plain)

    assert k <= MAX_CODES_WITH_STATS
    r = np.random.default_rng(n + k)
    x = torch.from_numpy(r.normal(size=(n, 256)).astype(np.float32)).to(cuda_device)
    cb = torch.from_numpy(r.normal(size=(k, 256)).astype(np.float32)).to(cuda_device)
    idx, xq = nearest_codes(x, cb)
    assert torch.equal(idx, nearest_codes_plain(x, cb)[0]) and torch.equal(xq, cb[idx])
    out, again = nearest_codes_with_stats(x, cb), nearest_codes_with_stats(x, cb)
    ref = nearest_codes_with_stats_plain(x, cb)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[3], ref[3])
    assert float((out[2] - ref[2]).abs().max()) <= 1e-5 * float(ref[2].abs().max())
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vq", "rq"])
def test_cuda_model_matches_its_plain_path_and_resumes_bit_equal(cuda_device, name):
    """A tiny VQModel / RQModel on the card (the attention, downsample and
    nearest-code kernels) against the same model on the CPU (the plain
    versions): reconstruction 1e-4, codes equal; a gradient-trained codebook's
    step taken twice from one state is bit-equal (its backward is a GEMM)."""
    from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

    target, params = MODELS[name]
    cfg = {"target": target, "params": {**params, "lossconfig": LOSS}}
    cpu = instantiate_from_config(cfg)
    cpu.init_weights(torch.Generator().manual_seed(0))
    card = instantiate_from_config(cfg).to(cuda_device)
    card.load_state_dict(cpu.state_dict())
    x = _images(3)
    with torch.no_grad():
        a = cpu(torch.from_numpy(x))
        b = card(torch.from_numpy(x).to(cuda_device))
    assert torch.equal(a[2], b[2].cpu())
    np.testing.assert_allclose(b[0].cpu().numpy(), a[0].numpy(), atol=1e-4, rtol=0)

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    trainer = Stage1Trainer(card, LR, max_steps=100, device=cuda_device, seed=5)
    trainer.init_state()

    def clone(o):
        if isinstance(o, dict):
            return {k: clone(v) for k, v in o.items()}
        return o.clone() if isinstance(o, torch.Tensor) else o

    saved = clone(trainer.state_dict())
    first = trainer.train_step(x)
    after = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.load_state_dict(saved)
    second = trainer.train_step(x)
    assert all(torch.equal(first[k], second[k]) for k in first)
    assert all(torch.equal(after[k], v) for k, v in trainer.model.state_dict().items())
