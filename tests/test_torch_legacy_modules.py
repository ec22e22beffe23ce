"""The legacy experimental modules of the port (`nn/stacked_mingpt.py`,
`nn/vit.py`, `nn/attn_decoder.py`, `nn/ddpm_unet.py`) against the JAX
package's, f32 on the CPU at tiny widths, on weights carried across by
`utils.weights.legacy_state_dict_from_flax`, and the seeded inits of the
whole family against the JAX inits' per-tensor moments; the companion of
`tests/test_torch_legacy_stage2.py`, whose tolerances these tests use
(`ATOL` / `RTOL` for outputs and losses, `GRAD_REL` for gradients,
`TOWER_ATOL` for towers of several levels). JAX is imported inside the
tests.
"""
import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-5, 2e-5
GRAD_REL = 1e-5
TOWER_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(a, b, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol, err_msg=what)


def _tokens(seed, shape, high):
    return np.random.default_rng(seed).integers(0, high, shape).astype(np.int32)


def _images(seed, b=2, res=16):
    return np.random.default_rng(seed).uniform(-1, 1, (b, res, res, 3)).astype(np.float32)


def _port(cls, variables, **kw):
    from dynamicvectorquantization_torch.utils.weights import legacy_state_dict_from_flax

    module = cls(**kw)
    module.load_state_dict(legacy_state_dict_from_flax(variables), strict=True)
    return module.eval()


def _grads_close(port_module, jax_grads, what=""):
    from dynamicvectorquantization_torch.utils.weights import legacy_state_dict_from_flax

    ref = legacy_state_dict_from_flax(jax_grads)
    got = {k: p.grad for k, p in port_module.named_parameters()}
    assert sorted(ref) == sorted(got)
    scale = max(float(v.abs().max()) for v in ref.values())
    assert scale > 0
    for k in ref:
        g = got[k] if got[k] is not None else torch.zeros_like(ref[k])
        np.testing.assert_allclose(_np(g), _np(ref[k]), atol=GRAD_REL * scale, rtol=0,
                                   err_msg=f"{what} d{k}")


# ----------------------------------------------------------------------- init
def test_trunc_normal_and_normal_draw_jax_distributions():
    """`trunc_normal_` / `normal_` against `trunc_normal_init` /
    `normal_init`: moments within 2 % on 200,000 draws, the bounds."""
    import jax

    from dynamicvectorquantization_torch.nn.init import normal_, trunc_normal_
    from dynamicvectorquantization_tpu.nn.init import normal_init, trunc_normal_init

    g = torch.Generator().manual_seed(0)
    for std in (0.02, 1.0):
        ref = np.asarray(trunc_normal_init(std)(jax.random.PRNGKey(0), (200_000,)))
        got = trunc_normal_(torch.empty(200_000), g, std=std).numpy()
        assert abs(got.std() / ref.std() - 1) < 0.02 and abs(got.mean()) < 0.02 * std
        assert got.min() >= -2.0 and got.max() <= 2.0
    ref = np.asarray(normal_init(0.02)(jax.random.PRNGKey(1), (200_000,)))
    got = normal_(torch.empty(200_000), g, 0.02).numpy()
    assert abs(got.std() / ref.std() - 1) < 0.02


def _moments_match(port_sd, ref_sd, what):
    """Per tensor: zeros and ones exactly where JAX's are, standard
    deviations within 10 % for tensors of >= 1,000 entries."""
    assert sorted(port_sd) == sorted(ref_sd), what
    for k, ref in ref_sd.items():
        got = port_sd[k].float()
        if float(ref.abs().max()) == 0.0 or bool((ref == 1.0).all()):
            assert torch.equal(got, ref), f"{what} {k}"
        elif ref.numel() >= 1000:
            assert abs(float(got.std()) / float(ref.std()) - 1) < 0.10, f"{what} {k}"


def test_seeded_inits_match_jax_moments():
    """GPT, RQTransformer, PositionAwareGPT, the ViT encoder,
    StackedPositionGPT and the attention decoder (whose `flax_defaults_` the
    DDPM UNets share): the port's `init_weights` against the JAX init per
    tensor."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_torch.nn import (attn_decoder, mingpt, rq_transformer,
                                                    stacked_mingpt, vit)
    from dynamicvectorquantization_torch.utils.weights import legacy_state_dict_from_flax
    from dynamicvectorquantization_tpu.nn import (attn_decoder as ja, mingpt as jm,
                                                  rq_transformer as jr, stacked_mingpt as js,
                                                  vit as jv)

    idx = jnp.zeros((1, 8), jnp.int32)
    cases = [
        (jm.GPT, mingpt.GPT, dict(vocab_size=512, block_size=64, n_layer=2, n_head=4,
                                  n_embd=64), (idx,)),
        (jr.RQTransformer, rq_transformer.RQTransformer,
         dict(vocab_size=512, spatial_size=16, depth=4, spatial_layer=1, depth_layer=1,
              n_head=4, n_embd=64), (jnp.zeros((1, 2, 2, 4), jnp.int32),
                                     jnp.zeros((1, 1), jnp.int32))),
        (jv.PositionAwareGPT, vit.PositionAwareGPT,
         dict(vocab_size=512, position_size=64, block_size=32, n_layer=1, n_head=4,
              n_embd=64), (idx, idx)),
        (jv.VisionTransformerEncoder, vit.VisionTransformerEncoder,
         dict(image_size=32, patch_size=8, embed_dim=64, depth=1, num_heads=4),
         (jnp.zeros((1, 32, 32, 3)),)),
        (js.StackedPositionGPT, stacked_mingpt.StackedPositionGPT,
         dict(vocab_size=512, position_size=64, block_size=32, position_layer=1,
              value_layer=1, n_head=4, n_embd=64), (idx, idx)),
        (ja.AttnDecoder, attn_decoder.AttnDecoder,
         dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, resolution=8, z_channels=8,
              token_n_layer=1), (jnp.zeros((1, 4, 4, 8)),)),
    ]
    for jcls, pcls, kw, args in cases:
        ref = legacy_state_dict_from_flax(jcls(**kw).init(jax.random.PRNGKey(0), *args))
        module = pcls(**kw)
        module.init_weights(torch.Generator().manual_seed(0))
        _moments_match(module.state_dict(), ref, pcls.__name__)


# ------------------------------------------------------ stacked / position GPTs
def test_stacked_position_gpt_matches_jax():
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_torch.nn.stacked_mingpt import StackedPositionGPT
    from dynamicvectorquantization_tpu.nn.stacked_mingpt import StackedPositionGPT as J

    kw = dict(vocab_size=20, position_size=18, block_size=32, position_layer=2,
              value_layer=1, n_head=2, n_embd=16)
    idx, pos = _tokens(31, (2, 9), 20), _tokens(32, (2, 9), 18)
    jgpt = J(**kw)
    variables = jax.device_get(jgpt.init(jax.random.PRNGKey(0), idx, pos))
    params = dict(variables["params"])
    params["pos_emb"] = np.random.default_rng(3).normal(
        0, 0.02, params["pos_emb"].shape).astype(np.float32)
    variables = {"params": params}
    gpt = _port(StackedPositionGPT, variables, **kw)

    def jloss(p):
        out = jgpt.apply({"params": p}, jnp.asarray(idx), jnp.asarray(pos),
                         idx_target=jnp.asarray(idx[:, 1:]),
                         pos_idx_target=jnp.asarray(pos[:, 1:]))
        return out["position_loss"] + out["value_loss"], out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    ti, tp = torch.from_numpy(idx).long(), torch.from_numpy(pos).long()
    out = gpt(ti, tp, ti[:, 1:], tp[:, 1:])
    for k in ("position_loss", "value_loss"):
        _close(out[k], jout[k], what=k)
    (out["position_loss"] + out["value_loss"]).backward()
    _grads_close(gpt, jg, "stacked")
    with torch.no_grad():
        logits = gpt(ti, tp)
    jlogits = jgpt.apply(variables, jnp.asarray(idx), jnp.asarray(pos))
    for k in ("position_logits", "value_logits"):
        _close(logits[k], jlogits[k], what=k)


def test_position_aware_gpt_matches_jax():
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_torch.nn.vit import PositionAwareGPT
    from dynamicvectorquantization_tpu.nn.vit import PositionAwareGPT as J

    kw = dict(vocab_size=24, position_size=20, block_size=32, n_layer=2, n_head=2, n_embd=16)
    idx, pos = _tokens(41, (2, 10), 24), _tokens(42, (2, 10), 20)
    emb = np.random.default_rng(43).normal(size=(2, 2, 16)).astype(np.float32)
    jgpt = J(**kw)
    variables = jax.device_get(jgpt.init(jax.random.PRNGKey(0), idx, pos))
    gpt = _port(PositionAwareGPT, variables, **kw)

    def jsum(p):
        v, q = jgpt.apply({"params": p}, jnp.asarray(idx), jnp.asarray(pos), jnp.asarray(emb))
        return jnp.sum(v * v) + jnp.sum(jnp.sin(q)), (v, q)

    (_, (jv, jq)), jg = jax.value_and_grad(jsum, has_aux=True)(variables["params"])
    v, q = gpt(torch.from_numpy(idx).long(), torch.from_numpy(pos).long(), torch.from_numpy(emb))
    _close(v, jv, what="value logits")
    _close(q, jq, what="position logits")
    ((v * v).sum() + torch.sin(q).sum()).backward()
    _grads_close(gpt, jg, "position-aware")


# ------------------------------------------------------------------------ ViT
def test_vit_encoder_decoder_match_jax():
    """Encoder tokens, decoder image, and the gradient of the round trip to
    both towers' parameters."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_torch.nn import vit
    from dynamicvectorquantization_tpu.nn import vit as jv

    kw = dict(image_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2)
    x = _images(51, res=32)
    jenc, jdec = jv.VisionTransformerEncoder(**kw), jv.VisionTransformerDecoder(**kw)
    ev = jax.device_get(jenc.init(jax.random.PRNGKey(0), x))
    tokens = jenc.apply(ev, jnp.asarray(x))
    dv = jax.device_get(jdec.init(jax.random.PRNGKey(1), tokens))
    enc, dec = _port(vit.VisionTransformerEncoder, ev, **kw), _port(
        vit.VisionTransformerDecoder, dv, **kw)

    def jround(pe, pd):
        img = jdec.apply({"params": pd}, jenc.apply({"params": pe}, jnp.asarray(x)))
        return jnp.sum(img * jnp.asarray(x)), img

    (_, jimg), (ge, gd) = jax.value_and_grad(jround, argnums=(0, 1), has_aux=True)(
        ev["params"], dv["params"])
    t = enc(torch.from_numpy(x))
    _close(t, tokens, atol=TOWER_ATOL, what="vit tokens")
    img = dec(t)
    assert img.shape == (2, 32, 32, 3)
    _close(img, jimg, atol=TOWER_ATOL, what="vit image")
    (img * torch.from_numpy(x)).sum().backward()
    _grads_close(enc, ge, "vit encoder")
    _grads_close(dec, gd, "vit decoder")


# --------------------------------------------------------- attention decoder
@pytest.mark.parametrize("mode", ["none", "mask", "reweight"])
def test_masked_self_attn_block_matches_jax(mode):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_torch.nn.attn_decoder import MaskedSelfAttnBlock
    from dynamicvectorquantization_tpu.nn.attn_decoder import MaskedSelfAttnBlock as J

    x = np.random.default_rng(61).normal(size=(2, 4, 4, 16)).astype(np.float32)
    mask = None if mode == "none" else np.random.default_rng(62).uniform(
        0.1, 1.0, (2, 16)).astype(np.float32)
    jblock = J(16, reweight=mode == "reweight")
    variables = jax.device_get(jblock.init(jax.random.PRNGKey(0), x))
    block = _port(MaskedSelfAttnBlock, variables, in_channels=16, reweight=mode == "reweight")
    ref = jblock.apply(variables, jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2),
                    None if mask is None else torch.from_numpy(mask))
    _close(got.permute(0, 2, 3, 1), ref, what=f"attention block ({mode})")


@pytest.mark.parametrize("mode,attn", [("square", "bias-self-attn"), ("cube", "bias-self-attn"),
                                       ("linear", "bias-self-attn"), ("const", "self-attn")])
def test_token_reconstruction_and_attn_decoder_match_jax(mode, attn):
    """`AttnDecoder` (its `TokenReconstruction` middle in each mask mode,
    `resnet_kernel_size` 3 with `fix_bug`) and `ResnetBlockK1`."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_torch.nn.attn_decoder import AttnDecoder
    from dynamicvectorquantization_tpu.nn.attn_decoder import AttnDecoder as J

    kw = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8,
              z_channels=4, token_n_layer=2, token_attn_type=attn, resnet_kernel_size=3,
              mask_update_mode=mode, fix_bug=True)
    z = np.random.default_rng(71).normal(size=(2, 4, 4, 4)).astype(np.float32)
    mask = np.random.default_rng(72).uniform(0.0, 1.0, (2, 16)).astype(np.float32)
    jdec = J(**kw)
    variables = jax.device_get(jdec.init(jax.random.PRNGKey(0), z, mask))
    dec = _port(AttnDecoder, variables, **kw)
    ref = jdec.apply(variables, jnp.asarray(z), jnp.asarray(mask))
    with torch.no_grad():
        got = dec(torch.from_numpy(z).permute(0, 3, 1, 2), torch.from_numpy(mask))
    assert got.shape == (2, 3, 8, 8)
    _close(got.permute(0, 2, 3, 1), ref, atol=TOWER_ATOL, what=f"attn decoder ({mode})")


# --------------------------------------------------------------------- DDPM
def test_timestep_embedding_matches_jax():
    from dynamicvectorquantization_torch.nn.ddpm_unet import get_timestep_embedding
    from dynamicvectorquantization_tpu.nn.ddpm_unet import get_timestep_embedding as J

    t = np.array([0, 1, 17, 999], np.int32)
    for dim in (16, 33):
        _close(get_timestep_embedding(torch.from_numpy(t), dim), J(t, dim), what=f"dim {dim}")


DDPM = {
    "DDPMUNet": (dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                      resolution=16, in_channels=3), ("x", "t")),
    "VUNet": (dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                   resolution=16, in_channels=3, z_channels=4), ("x", "z")),
    "SimpleDecoder": (dict(in_channels=8, out_channels=3), ("h",)),
    "UpsampleDecoder": (dict(in_channels=8, out_channels=3, ch=8, num_res_blocks=1,
                             resolution=16), ("h",)),
}


@pytest.mark.parametrize("name", sorted(DDPM))
def test_ddpm_models_match_jax(name):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_torch.nn import ddpm_unet
    from dynamicvectorquantization_tpu.nn import ddpm_unet as jd

    kw, inputs = DDPM[name]
    rng = np.random.default_rng(81)
    arrays = {"x": rng.normal(size=(2, 16, 16, 3)), "z": rng.normal(size=(2, 8, 8, 4)),
              "h": rng.normal(size=(2, 8, 8, 8))}
    args = [np.array([3, 250], np.int32) if k == "t" else arrays[k].astype(np.float32)
            for k in inputs]
    jm = getattr(jd, name)(**kw)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), *args))
    model = _port(getattr(ddpm_unet, name), variables, **kw)
    ref = jm.apply(variables, *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a) if a.ndim == 1 else torch.from_numpy(a).permute(0, 3, 1, 2)
             for a in args]
    with torch.no_grad():
        got = model(*targs)
    _close(got.permute(0, 2, 3, 1), ref, atol=TOWER_ATOL, what=name)
