"""The fixed-length stage-2 baselines of the port (`nn/mingpt.py`,
`models/legacy_transformer.py`, `nn/rq_transformer.py`,
`nn/stacked_mingpt.py`, `nn/vit.py`, `nn/attn_decoder.py`,
`nn/ddpm_unet.py`, `models/sequence_permuters.py`) against the JAX
package's modules, f32 on the CPU at tiny widths, on weights carried across
by `utils.weights.legacy_state_dict_from_flax` /
`legacy_stage2_state_dict_from_flax` (the first stages by
`vqgan_state_dict_from_flax`).

Draws the frameworks cannot share: the T2I `pkeep` mask and replacement
tokens are JAX's, fed to the port (`pkeep_mask=`, `pkeep_tokens=`);
sampling is compared greedily (`sample=False`, or `top_k=1` where the JAX
function always draws), token for token.

Tolerances (f32, different summation orders): logits, losses, hidden
states and images 2e-5 absolute + 1e-5 relative (`ATOL`, `RTOL`); the
gradients 1e-5 of the largest gradient entry (`GRAD_REL`); the codec towers
of several levels (the ViT, the attention decoder, the DDPM UNets, decoded
images) 1e-4 absolute (`TOWER_ATOL`); permuter orders, codes and sampled
tokens exactly. One shared JAX init per module (module-scoped fixtures);
JAX is imported inside the tests, so the `cuda` cases collect where only
PyTorch is installed.
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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


# ------------------------------------------------------------------ permuters
PERMUTERS = ("Identity", "AlternateParsing", "ZCurve", "Subsample", "SpiralOut", "SpiralIn",
             "Random")


@pytest.mark.parametrize("name", PERMUTERS)
def test_permuters_match_jax(name):
    """Forward and reverse orders equal JAX's exactly, square and not."""
    from dynamicvectorquantization_torch.models import sequence_permuters as port
    from dynamicvectorquantization_tpu.models import sequence_permuters as ref

    for h, w in ((8, 8), (4, 6)):
        x = np.arange(3 * h * w).reshape(3, h * w)
        jp, pp = getattr(ref, name)(H=h, W=w), getattr(port, name)(H=h, W=w)
        y = pp(torch.from_numpy(x))
        assert np.array_equal(y.numpy(), np.asarray(jp(x)))
        assert np.array_equal(pp(y, reverse=True).numpy(), x)
        assert np.array_equal(np.asarray(jp(np.asarray(jp(x)), reverse=True)), x)


# ------------------------------------------------------------------------ GPT
GPT_KW = dict(vocab_size=40, block_size=32, n_layer=2, n_head=2, n_embd=32)


@pytest.fixture(scope="module")
def gpt_pair():
    """(JAX GPT, its variables with seg_emb, the port's GPT) at GPT_KW with
    two segments, the JAX init perturbed so `pos_emb` is not zero."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_torch.nn.mingpt import GPT
    from dynamicvectorquantization_tpu.nn.mingpt import GPT as J

    jgpt = J(**GPT_KW, segment_size=2)
    idx = jnp.zeros((1, 8), jnp.int32)
    variables = jax.device_get(jgpt.init(jax.random.PRNGKey(0), idx, segment=idx))
    params = dict(variables["params"])
    params["pos_emb"] = np.random.default_rng(9).normal(
        0, 0.02, params["pos_emb"].shape).astype(np.float32)
    variables = {"params": params}
    return jgpt, variables, _port(GPT, variables, **GPT_KW, segment_size=2)


def test_gpt_logits_loss_and_gradients_match_jax(gpt_pair):
    """Logits and the cross entropy, with segments and a prefix of
    embeddings, and every parameter's gradient against `jax.grad`."""
    import jax
    import jax.numpy as jnp

    jgpt, variables, gpt = gpt_pair
    idx = _tokens(1, (2, 12), 40)
    seg = (np.arange(12)[None].repeat(2, 0) >= 5).astype(np.int32)
    emb = np.random.default_rng(2).normal(size=(2, 3, 32)).astype(np.float32)
    tgt = _tokens(3, (2, 15), 40)
    tgt[0, :3] = -100

    def jloss(params):
        logits, loss = jgpt.apply({"params": params}, jnp.asarray(idx), jnp.asarray(emb),
                                  jnp.asarray(tgt), jnp.asarray(seg))
        return loss, logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    logits, loss = gpt(torch.from_numpy(idx).long(), torch.from_numpy(emb),
                       torch.from_numpy(tgt).long(), torch.from_numpy(seg).long())
    _close(logits, jlogits, what="logits")
    _close(loss, jl, what="loss")
    loss.backward()
    _grads_close(gpt, jg, "gpt")
    gpt.zero_grad(set_to_none=True)
    plain, none = gpt(torch.from_numpy(idx).long())
    assert none is None
    _close(plain, jgpt.apply(variables, jnp.asarray(idx))[0], what="logits, no extras")


def test_gpt_cached_step_and_step_embedding_match_jax(gpt_pair):
    """`step` (with a segment) and `step_embedding` over a prefix: each
    step's logits equal the JAX cached steps' and the full forward's."""
    import jax.numpy as jnp

    jgpt, variables, gpt = gpt_pair
    idx = _tokens(4, (2, 7), 40)
    emb = np.random.default_rng(5).normal(size=(2, 32)).astype(np.float32)
    seg = np.ones((2,), np.int32)
    jcache = jgpt.apply(variables, 2, 10, method="make_cache")
    cache = gpt.make_cache(2, 10)
    assert cache.layers[0][0].shape == tuple(jcache.layers[0][0].shape)
    with torch.no_grad():
        jl, jcache = jgpt.apply(variables, jnp.asarray(emb), jcache, 0,
                                method="step_embedding")
        _close(gpt.step_embedding(torch.from_numpy(emb), cache, 0), jl, what="embedding step")
        for i in range(idx.shape[1]):
            jl, jcache = jgpt.apply(variables, jnp.asarray(idx[:, i]), jcache, i + 1,
                                    jnp.asarray(seg), method="step")
            pl = gpt.step(torch.from_numpy(idx[:, i]).long(), cache, i + 1,
                          torch.from_numpy(seg).long())
            _close(pl, jl, what=f"step {i}")
        full, _ = gpt(torch.from_numpy(idx).long(), torch.from_numpy(emb)[:, None],
                      segment=torch.ones(2, 7, dtype=torch.long))
    _close(pl, full[:, -1], what="last step vs forward")


def test_gpt_step_with_a_device_index_equals_the_host_index_step(gpt_pair):
    """The step the card's sampler replays as a graph (a 0-d int32 index,
    every chunk of the cache read) against the host-index step, bit for bit,
    at positions on both sides of a chunk boundary."""
    from dynamicvectorquantization_torch.ops.kv_int8 import CHUNK

    _, _, gpt = gpt_pair
    gpt = type(gpt)(**{**GPT_KW, "block_size": 2 * CHUNK}, segment_size=2)
    gpt.init_weights(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(_tokens(7, (2, CHUNK + 3), 40)).long()
    seg = torch.ones(2, dtype=torch.long)
    host, dev = gpt.make_cache(2, 2 * CHUNK), gpt.make_cache(2, 2 * CHUNK)
    with torch.no_grad():
        for i in range(toks.shape[1]):
            a = gpt.step(toks[:, i], host, i, seg)
            b = gpt.step(toks[:, i], dev, torch.tensor(i, dtype=torch.int32), seg, n_chunks=2)
            assert torch.equal(a, b), i


@pytest.mark.parametrize("segments", [False, True])
def test_gpt_greedy_sample_with_past_is_token_exact(gpt_pair, segments):
    import jax

    from dynamicvectorquantization_torch.nn.mingpt import sample_with_past
    from dynamicvectorquantization_tpu.nn.mingpt import sample_with_past as jsample

    jgpt, variables, gpt = gpt_pair
    x0 = _tokens(6, (3, 3), 40)
    ref = jsample(jgpt, variables, x0, 20, jax.random.PRNGKey(0), sample_logits=False,
                  use_segments=segments)
    got = sample_with_past(gpt, torch.from_numpy(x0).long(), 20, sample_logits=False,
                           use_segments=segments)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    top1 = sample_with_past(gpt, torch.from_numpy(x0).long(), 20, torch.Generator(),
                            top_k=1, use_segments=segments)
    assert torch.equal(top1, got)


# --------------------------------------------------------- fixed-length models
DD = {"double_z": False, "z_channels": 8, "resolution": 16, "in_channels": 3, "out_ch": 3,
      "ch": 8, "ch_mult": [1, 2, 2], "num_res_blocks": 1, "attn_resolutions": [4],
      "dropout": 0.0}
FIRST_STAGE = {"target": "models.stage1.vqgan.VQModel",
               "params": {"ddconfig": DD, "lossconfig": None, "n_embed": 32, "embed_dim": 8}}
PERMUTER = {"target": "modules.transformer.permuter.ZCurve", "params": {"H": 4, "W": 4}}


def _gpt_config(vocab, segment_size=0):
    return {"target": "modules.transformer.mingpt.GPT",
            "params": {"vocab_size": vocab, "block_size": 32, "n_layer": 2, "n_head": 2,
                       "n_embd": 16, "segment_size": segment_size}}


MODELS = {
    "uncond": ("models.stage2.uncond_transformer.UncondTransformer",
               {"transformer_config": _gpt_config(33), "first_stage_config": FIRST_STAGE,
                "permuter_config": PERMUTER, "sos_token": 32}),
    "class": ("models.stage2.class_transformer.ClassTransformer",
              {"transformer_config": _gpt_config(42), "first_stage_config": FIRST_STAGE,
               "permuter_config": PERMUTER,
               "cond_stage_config": {"target": "utils.utils.Labelator",
                                     "params": {"n_classes": 10, "threshold": 32}}}),
    "t2i": ("models.stage2.text2image_transformer.Text2ImageTransformer",
            {"transformer_config": _gpt_config(52), "first_stage_config": FIRST_STAGE,
             "text_vocab_size": 20, "image_vocab_size": 32, "text_loss_radio": 0.3,
             "pkeep": 0.8}),
    "t2i2": ("models.stage2.text2image_transformer2.Text2ImageTransformer",
             {"transformer_config": _gpt_config(52, 2), "first_stage_config": FIRST_STAGE,
              "permuter_config": PERMUTER, "text_vocab_size": 20, "image_vocab_size": 32,
              "pkeep": 0.8}),
}


def _conditions(name):
    if name == "class":
        return np.array([3, 7], np.int32)
    if name.startswith("t2i"):
        return _tokens(11, (2, 5), 20)
    return _images(12)


@pytest.fixture(scope="module")
def legacy_models():
    """{name: (JAX model, variables, port model)}: one JAX init each."""
    import jax

    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
    from dynamicvectorquantization_torch.utils.weights import legacy_stage2_state_dict_from_flax
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    out = {}
    for name, (target, params) in MODELS.items():
        cfg = {"target": target, "params": params}
        jmodel = jinst(cfg)
        fs = jmodel.first_stage_model.init(jax.random.PRNGKey(0))
        variables = jax.device_get(jmodel.init(jax.random.PRNGKey(1), fs))
        model = instantiate_from_config(cfg)
        model.load_state_dict(legacy_stage2_state_dict_from_flax(variables, model), strict=True)
        out[name] = (jmodel, variables, model.eval())
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_legacy_models_forward_loss_gradients_match_jax(legacy_models, name):
    """The training forward's loss(es) on the same codes; the GPT's
    gradients; for the T2I models with JAX's `pkeep` draw fed in."""
    import jax
    import jax.numpy as jnp

    jmodel, variables, model = legacy_models[name]
    x, c = _images(13), _conditions(name)
    t2i = name.startswith("t2i")
    rngs = {"pkeep": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(5)}
    feed = {}
    if t2i:
        k1, k2 = jax.random.split(rngs["pkeep"])
        feed = {"pkeep_mask": torch.from_numpy(np.array(
                    jax.random.bernoulli(k1, 0.8, (2, 16)))),
                "pkeep_tokens": torch.from_numpy(np.array(
                    jax.random.randint(k2, (2, 16), 0, 52))).long()}

    def jloss(tparams):
        v = {**variables, "transformer": {"params": tparams}}
        out = jmodel.forward(v, jnp.asarray(x), jnp.asarray(c), train=t2i, rngs=rngs)
        return (out[0], out) if t2i else (out[1], out)

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        variables["transformer"]["params"])
    out = model(torch.from_numpy(x), torch.from_numpy(c), train=t2i, **feed)
    if t2i:
        for a, b, what in zip(out, jout, ("total", "image", "text")):
            _close(a, b, what=f"{name} {what} loss")
        assert not torch.equal(feed["pkeep_mask"], torch.ones_like(feed["pkeep_mask"]))
        loss = out[0]
    else:
        _close(out[0], jout[0], what=f"{name} logits")
        loss = out[1]
        _close(loss, jl, what=f"{name} loss")
    loss.backward()
    _grads_close(model.transformer, jg, name)
    assert all(p.grad is None for p in model.first_stage_model.parameters())
    model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_legacy_models_greedy_sample_and_decode_match_jax(legacy_models, name):
    """Greedy sampling from the condition prefix token for token, then
    `decode_to_img` of the codes."""
    import jax
    import jax.numpy as jnp

    jmodel, variables, model = legacy_models[name]
    c = _conditions(name)
    jc = jmodel.encode_to_c(jnp.asarray(c))
    pc = model.encode_to_c(torch.from_numpy(c))
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    ref = jmodel.sample(variables, jc, 16, jax.random.PRNGKey(0), sample=False)
    got = model.sample(pc, 16, sample=False)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    codes = np.clip(np.asarray(ref), 0, 31)
    jimg = jmodel.decode_to_img(variables, jnp.asarray(codes), (2, 4, 4))
    img = model.decode_to_img(torch.from_numpy(codes).long(), (2, 4, 4))
    assert img.shape == (2, 16, 16, 3)
    _close(img, jimg, atol=TOWER_ATOL, what=f"{name} decode_to_img")


def test_labelator_shifts_and_sos_provider():
    from dynamicvectorquantization_torch.models.legacy_transformer import (Labelator,
                                                                         SOSProvider)

    c, _, info = Labelator(n_classes=10, threshold=100).encode(torch.tensor([3, 7]))
    assert c.ravel().tolist() == [103, 107] and info[2] is c
    c, _, _ = SOSProvider(42).encode(torch.zeros(3, 8, 8, 3))
    assert c.shape == (3, 1) and bool((c == 42).all())


# ------------------------------------------------------------- RQ-Transformer
RQ_FIRST = {"target": "models.stage1.rqvae.RQModel",
            "params": {"ddconfig": DD, "lossconfig": None, "embed_dim": 8,
                       "rqconfig": {"target":
                                    "modules.vector_quantization.quantize_rqvae.RQBottleneck",
                                    "params": {"latent_shape": [4, 4, 8],
                                               "code_shape": [4, 4, 3], "n_embed": 32,
                                               "shared_codebook": True}}}}
RQ_TRANSFORMER = {"target": "dynamicvectorquantization_tpu.nn.rq_transformer.RQTransformer",
                  "params": {"vocab_size": 32, "spatial_size": 16, "depth": 3,
                             "spatial_layer": 2, "depth_layer": 1, "n_head": 2, "n_embd": 16}}


@pytest.fixture(scope="module")
def rq_pair():
    import jax

    from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
    from dynamicvectorquantization_torch.utils.weights import legacy_stage2_state_dict_from_flax
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    def cfg(pkg):
        t = dict(RQ_TRANSFORMER, target=RQ_TRANSFORMER["target"].replace(
            "dynamicvectorquantization_tpu", pkg))
        return {"target": "models.stage2.uncond_rqtransformer.RQTransformerTrainer",
                "params": {"transformer_config": t, "first_stage_config": RQ_FIRST}}

    jmodel = jinst(cfg("dynamicvectorquantization_tpu"))
    fs = jmodel.first_stage_model.init(jax.random.PRNGKey(0))
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(1), fs))
    tp = dict(variables["transformer"]["params"])
    for k in ("pos_emb_cond", "pos_emb_hw", "pos_emb_d"):  # not zero, so they count
        tp[k] = jax.numpy.asarray(np.random.default_rng(len(k)).normal(
            0, 0.02, tp[k].shape).astype(np.float32))
    variables = {**variables, "transformer": {"params": tp}}
    model = instantiate_from_config(cfg("dynamicvectorquantization_torch"))
    model.load_state_dict(legacy_stage2_state_dict_from_flax(variables, model), strict=True)
    return jmodel, variables, model.eval()


def test_rq_transformer_loss_and_gradients_match_jax(rq_pair):
    import jax
    import jax.numpy as jnp

    jmodel, variables, model = rq_pair
    x = _images(21)

    def jloss(tparams):
        return jmodel.forward({**variables, "transformer": {"params": tparams}},
                              jnp.asarray(x), jnp.asarray(x))

    jl, jg = jax.value_and_grad(jloss)(variables["transformer"]["params"])
    loss = model(torch.from_numpy(x), torch.from_numpy(x))
    _close(loss, jl, what="rq loss")
    loss.backward()
    _grads_close(model.transformer, jg, "rq")
    model.zero_grad(set_to_none=True)
    codes = model.encode_to_z(torch.from_numpy(x))
    assert codes.shape == (2, 4, 4, 3)
    logits = model.transformer(codes, return_loss=False)
    jlogits = jmodel.transformer.apply(variables["transformer"], jnp.asarray(codes.numpy()),
                                       return_loss=False)
    _close(logits, jlogits, what="rq logits")


def test_rq_greedy_sample_is_token_exact_and_decodes(rq_pair):
    import jax
    import jax.numpy as jnp

    jmodel, variables, model = rq_pair
    x = _images(22)
    ref = jmodel.sample(variables, (2, 4, 4, 3), jnp.asarray(x), jax.random.PRNGKey(0),
                        top_k=1, top_p=None)
    got = model.sample((2, 4, 4, 3), torch.from_numpy(x), torch.Generator(), top_k=1,
                       top_p=None)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    _close(model.decode_to_img(got), jmodel.decode_to_img(variables, ref), atol=TOWER_ATOL,
           what="rq decode")
    logs = model.log_images(torch.from_numpy(x), torch.Generator().manual_seed(0), top_k=4)
    assert logs["sample"].shape == logs["inputs"].shape == (2, 16, 16, 3)


# ----------------------------------------------------------------- registry
def test_every_jax_legacy_target_resolves_in_the_port():
    """Every entry of the JAX registry's legacy block (the baselines'
    stage 1 and stage 2, the permuters, the conditioners, the attention
    decoder, the DDPM UNets) names an importable port class."""
    import importlib
    import re

    from dynamicvectorquantization_torch.config.registry import resolve_target
    from dynamicvectorquantization_tpu.config import registry as jreg

    legacy = [t for t in jreg.TARGET_ALIASES
              if re.match(r"(models\.stage1\.(vqgan|rqvae)|models\.stage2\.|modules\.transformer\."
                          r"|modules\.diffusionmodules\.|utils\.utils\.|modules\.vector_"
                          r"quantization\.quantize(_vqgan|_rqvae|_lucidrains)?\.)", t)]
    assert len(legacy) >= 40
    for target in legacy:
        module, name = resolve_target(target).rsplit(".", 1)
        assert hasattr(importlib.import_module(module), name), target


# ---------------------------------------------------------------------- card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_cin_attention_shape_matches_plain(cuda_device, dtype):
    """#4 / #5 at the cin transformer's shape (24 heads of 64, T 256, batch
    2) against their plain versions: forward 2e-5 (f32) / 2e-2 (bf16)
    relative to the output's scale, gradients likewise."""
    from dynamicvectorquantization_torch.ops.attention import (fused_attention_backward_plain,
                                                               fused_attention_forward_plain,
                                                               fused_causal_attention)

    g = torch.Generator().manual_seed(0)
    q, k, v, dy = (torch.randn(2, 256, 1536, generator=g).to(cuda_device, dtype)
                   for _ in range(4))
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    y = fused_causal_attention(qr, kr, vr, 24)
    y.backward(dy)
    ref, lse = fused_attention_forward_plain(q, k, v, 24, causal=True, return_lse=True)
    scale = float(ref.float().abs().max())
    assert float((y.detach().float() - ref.float()).abs().max()) <= tol * scale
    grads = fused_attention_backward_plain(q, k, v, ref, lse, dy, 24, causal=True)
    for got, want in zip((qr.grad, kr.grad, vr.grad), grads):
        assert float((got.float() - want.float()).abs().max()) <= tol * float(
            want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [False, True])
def test_cuda_graph_sampling_equals_the_eager_loop(cuda_device, segments):
    """`sample_with_past` replaying each step as a CUDA graph against its
    eager control: the same tokens greedily and with a seeded top-k draw,
    twice (the second call replays the first's graph)."""
    from dynamicvectorquantization_torch.nn.mingpt import GPT, sample_with_past

    gpt = GPT(**{**GPT_KW, "block_size": 300}, segment_size=2 if segments else 0)
    gpt.init_weights(torch.Generator().manual_seed(4))
    gpt.to(cuda_device)
    x0 = torch.from_numpy(_tokens(8, (3, 2), 40)).long().to(cuda_device)
    for _ in range(2):
        for knobs in (dict(sample_logits=False), dict(top_k=5)):
            got = [sample_with_past(gpt, x0, 280, torch.Generator(cuda_device).manual_seed(9),
                                    use_segments=segments, eager=eager, **knobs)
                   for eager in (False, True)]
            assert torch.equal(got[0], got[1]), knobs


@pytest.mark.cuda
def test_cuda_vit_noncausal_hd32_and_gpt_match_cpu(cuda_device):
    """The ViT's non-causal attention at hd 32 (square tiles) and a small
    GPT's loss and gradients on the card against the same modules on the
    CPU: 1e-4 relative (the gradients: of the largest gradient entry, as
    `GRAD_REL` is taken on the CPU)."""
    from dynamicvectorquantization_torch.nn.mingpt import GPT
    from dynamicvectorquantization_torch.nn.vit import VisionTransformerEncoder

    enc = VisionTransformerEncoder(image_size=64, patch_size=8, embed_dim=256, depth=1,
                                   num_heads=8)
    enc.init_weights(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images(91, res=64))
    ref = enc(x)
    got = enc.to(cuda_device)(x.to(cuda_device))
    assert float((got.cpu() - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    gpt = GPT(vocab_size=64, block_size=256, n_layer=2, n_head=4, n_embd=256)
    gpt.init_weights(torch.Generator().manual_seed(1))
    idx = torch.from_numpy(_tokens(92, (2, 256), 64)).long()
    _, loss = gpt(idx[:, :-1], targets=idx[:, 1:])
    loss.backward()
    cpu_grads = {k: p.grad.clone() for k, p in gpt.named_parameters()}
    gpt.zero_grad(set_to_none=True)
    gpt.to(cuda_device)
    _, closs = gpt(idx[:, :-1].to(cuda_device), targets=idx[:, 1:].to(cuda_device))
    closs.backward()
    assert abs(float(closs) - float(loss)) <= 1e-4 * float(loss)
    scale = max(float(g.abs().max()) for g in cpu_grads.values())
    for k, p in gpt.named_parameters():
        assert float((p.grad.cpu() - cpu_grads[k]).abs().max()) <= 1e-4 * scale, k
