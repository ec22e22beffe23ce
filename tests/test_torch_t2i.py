"""Text-to-image in the PyTorch port against the JAX package on the CPU, f32:
the byte-level BPE tokenizer (token-exact, with and without a merge table),
the CLIP text tower (a tiny tower's features on shared weights, and the
OpenAI-layout converter against the JAX package's), `HashTextEncoder`
(equal within one process: both index by Python's salted `hash`), and
`T2IDualformer` at the tiny stage-2 config in both variants on one
perturbed JAX init carried over by `utils.weights`: losses (atol 1e-5),
logits with caption memory, `content_step` with caption memory against the
JAX step and the full forward (atol 1e-5), an uncaptioned greedy sample
token-exact, masked caption padding inert, the flag-off keys those of the
plain `Dualformer`; the loop's refusal to cache codes for text models; and
every reference alias of the JAX registry resolving in the port's, each
JAX-package path refused with the port's path of the same class.

JAX is imported inside the fixtures and tests; one JAX init per variant.
"""
import copy
import gzip
import os
import runpy

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.weights import (clip_text_state_dict_from_flax,
                                                           clip_text_state_dict_from_openai,
                                                           stackgpt_state_dict_from_flax)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")
PKG, JPKG = "dynamicvectorquantization_torch", "dynamicvectorquantization_tpu"
T2I_TARGET = "models.stage2_dynamic.dqtransformer_t2i.Dualformer"
TEXT_DIM = 16
CAPTIONS = ["a red cat on the grass", "blue dog"]
OTHER = ["stormy ocean waves", "quiet mountain snow at night"]
TEXTS = ["Hello, world!", "A photo of 2 cats; they're (very) fluffy...", "café crème",
         "x" * 200, "", "<|startoftext|> raw specials <|endoftext|>"]
ATOL = 1e-5
LOSS_NAMES = ("content_loss", "position_loss", "coarse_position_loss", "fine_position_loss")


def t2i_config(cfg, on, pkg):
    """The tiny stage-2 yml (either package's loader) as a T2I model with a
    `HashTextEncoder` of width TEXT_DIM from package `pkg`."""
    model = copy.deepcopy(cfg["model"])
    model["target"] = T2I_TARGET
    model["params"]["use_text_conditioning"] = on
    model["params"]["text_encoder_config"] = {
        "target": f"{pkg}.nn.text_encoders.HashTextEncoder", "params": {"embed_dim": TEXT_DIM}}
    return model


def perturbed(tree, rng, std):
    return {k: perturbed(v, rng, std) if isinstance(v, dict)
            else (np.asarray(v) + rng.normal(0.0, std, np.shape(v))).astype(np.float32)
            for k, v in tree.items()}


def _images(seed, b, size=64):
    """Left half smooth, right half noisy, so both grains occur."""
    r = np.random.default_rng(seed)
    x = r.uniform(-1, 1, size=(b, size, size, 3)).astype(np.float32)
    x[:, :, : size // 2] = (0.2 + 0.01 * x[:, :, : size // 2]).astype(np.float32)
    return x


@pytest.fixture(scope="module", params=[False, True], ids=["dropped", "consumed"])
def pair(request):
    """(JAX model, its transformer's variables, the port model on the same
    transformer weights and a seeded first stage). The JAX side is compared
    from the port's codes (`forward_tokens`): the encode's equality with the
    JAX package's is `tests/test_torch_encoder.py`'s."""
    import jax

    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    on = request.param
    jmodel = jinst(t2i_config(jload([TINY]), on, JPKG))
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(1), {}))
    variables["transformer"]["params"] = perturbed(variables["transformer"]["params"],
                                                   np.random.default_rng(0), 0.05)
    port = instantiate_from_config(t2i_config(load_config([TINY]), on, PKG))
    port.init_weights(torch.Generator().manual_seed(0))
    port.transformer.load_state_dict(stackgpt_state_dict_from_flax(
        variables["transformer"]["params"]))
    return jmodel, variables, port.eval()


# ------------------------------------------------------------------ tokenizer
def _tokenizers(bpe_path=None):
    from dynamicvectorquantization_tpu.utils import clip_bpe as jbpe

    from dynamicvectorquantization_torch.utils import clip_bpe as tbpe

    return (jbpe, jbpe.ClipBPETokenizer(bpe_path=bpe_path),
            tbpe, tbpe.ClipBPETokenizer(bpe_path=bpe_path))


def _merge_table(tmp_path):
    merges = ["h e", "l l", "he ll", "hell o</w>", "c a", "ca t</w>", "o t", "p h", "ph ot"]
    p = tmp_path / "bpe.txt.gz"
    with gzip.open(p, "wt") as f:
        f.write("#version\n" + "\n".join(merges) + "\n")
    return str(p)


@pytest.mark.parametrize("merges", [False, True], ids=["byte_level", "merge_table"])
def test_tokenizer_is_token_exact(tmp_path, merges):
    jbpe, jtok, tbpe, ttok = _tokenizers(_merge_table(tmp_path) if merges else None)
    assert ttok.vocab_size == jtok.vocab_size == 514 + 9 * merges
    for text in TEXTS + ["hello cat photo", "fellow cats"]:
        ids = ttok.encode(text)
        assert ids == jtok.encode(text), text
        assert ttok.decode(ids) == jtok.decode(ids)
    for context, add in ((77, True), (8, True), (12, False)):
        a = tbpe.tokenize(TEXTS, context_length=context, add_start_and_end=add, tokenizer=ttok)
        b = jbpe.tokenize(TEXTS, context_length=context, add_start_and_end=add, tokenizer=jtok)
        np.testing.assert_array_equal(a["token"], b["token"])
        np.testing.assert_array_equal(a["mask"], b["mask"])
    assert tbpe.Tokenize(context_length=12).get_tokens("a test")["token"].tolist() == \
        jbpe.Tokenize(context_length=12).get_tokens("a test")["token"].tolist()


# ------------------------------------------------------------------ CLIP tower
TOWER = dict(vocab_size=600, context_length=77, width=32, layers=2, heads=2, embed_dim=512)


@pytest.fixture(scope="module")
def tower():
    """(JAX tower, its perturbed params, token ids of TEXTS)."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn.clip_text import CLIPTextTransformer as JTower
    from dynamicvectorquantization_tpu.utils.clip_bpe import tokenize

    jt = JTower(**TOWER)
    params = jax.device_get(jt.init(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32)))
    params = perturbed(params, np.random.default_rng(1), 0.02)
    return jt, params, tokenize(TEXTS[:4], context_length=77)["token"]


def _port_tower(state_dict):
    from dynamicvectorquantization_torch.nn.clip_text import CLIPTextTransformer

    t = CLIPTextTransformer(**TOWER)
    t.load_state_dict(state_dict)
    return t.eval()


def test_clip_tower_features_match_jax(tower):
    import jax.numpy as jnp

    jt, params, tokens = tower
    seq, pooled = jt.apply(params, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        tseq, tpooled = _port_tower(clip_text_state_dict_from_flax(params))(
            torch.from_numpy(tokens))
    assert tseq.shape == (4, 77, 32) and tpooled.shape == (4, 512)
    np.testing.assert_allclose(tseq.numpy(), np.asarray(seq), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled), atol=ATOL, rtol=0)


def test_openai_layout_converter_matches_jax(tower, tmp_path):
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.utils.torch_ckpt import (convert_clip_text_state_dict,
                                                                load_torch_state_dict)

    jt, params, tokens = tower
    # an OpenAI CLIP file: the text tower under its own names, a visual tower
    # and the logit scale beside it
    sd = dict(clip_text_state_dict_from_flax(params))
    sd["visual.conv1.weight"] = torch.zeros(4, 3, 2, 2)
    sd["logit_scale"] = torch.tensor(4.6)
    path = tmp_path / "clip.pt"
    torch.save(sd, path)
    jparams = convert_clip_text_state_dict(load_torch_state_dict(str(path)), layers=2)
    seq, pooled = jt.apply(jparams, jnp.asarray(tokens, jnp.int32))
    port_sd = clip_text_state_dict_from_openai(torch.load(path), layers=2)
    assert "logit_scale" not in port_sd and not any(k.startswith("visual.") for k in port_sd)
    with torch.no_grad():
        tseq, tpooled = _port_tower(port_sd)(torch.from_numpy(tokens))
    np.testing.assert_allclose(tseq.numpy(), np.asarray(seq), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled), atol=ATOL, rtol=0)
    with pytest.raises(KeyError, match="beyond"):
        clip_text_state_dict_from_openai(torch.load(path), layers=1)


def test_clip_embedding_and_native_encoder_match_jax(tower, tmp_path, monkeypatch):
    """`CLIPTextEmbedding` in each of its output modes and
    `NativeCLIPTextEncoder` (tokenizer + tower) of both packages on one
    OpenAI-layout weights file (`weights_path`), at a tiny tower registered
    under a name of its own in both packages' `CLIP_TEXT_CONFIGS` (its
    512-wide projection doubles to 1,024 as ViT-B/32's does)."""
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn import clip_text as jclip
    from dynamicvectorquantization_tpu.nn.text_encoders import NativeCLIPTextEncoder as JNative

    from dynamicvectorquantization_torch.nn import clip_text
    from dynamicvectorquantization_torch.nn.text_encoders import NativeCLIPTextEncoder

    _, params, tokens = tower
    cfg = {k: TOWER[k] for k in ("width", "layers", "heads", "embed_dim")}
    monkeypatch.setitem(jclip.CLIP_TEXT_CONFIGS, "tiny", cfg)
    monkeypatch.setitem(clip_text.CLIP_TEXT_CONFIGS, "tiny", cfg)
    path = str(tmp_path / "clip.pt")
    torch.save(clip_text_state_dict_from_flax(params), path)
    tokens = np.where(np.arange(77) < 70, tokens, -1)  # negative ids are clamped to 0
    for kw in (dict(), dict(normalize=False, keep_seq_len_dim=True),
               dict(pick_last_embedding=False, normalize=False),
               dict(additional_last_embedding=True, keep_seq_len_dim=True)):
        kw = dict(clip_name="tiny", num_embed=600, weights_path=path, **kw)
        ref, got = jclip.CLIPTextEmbedding(**kw)(jnp.asarray(tokens)), \
            clip_text.CLIPTextEmbedding(**kw)(tokens)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert a.shape == b.shape, kw
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0,
                                       err_msg=str(kw))
    # the native encoder: tokenizer (byte-level), tower, the mask; the vocabulary
    # of 49,408 ids needs a table that wide, so the file is widened with zero rows
    sd = clip_text_state_dict_from_flax(params)
    sd["token_embedding.weight"] = torch.cat([sd["token_embedding.weight"],
                                              torch.zeros(49408 - 600, TOWER["width"])])
    torch.save(sd, path)
    feats, mask = NativeCLIPTextEncoder("tiny", weights_path=path).encode_text(CAPTIONS)
    jfeats, jmask = JNative("tiny", weights_path=path).encode_text(CAPTIONS)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=ATOL, rtol=0)


def test_hash_encoder_equals_jax_within_a_process():
    from dynamicvectorquantization_tpu.nn.text_encoders import HashTextEncoder as JHash

    from dynamicvectorquantization_torch.nn.text_encoders import HashTextEncoder

    feats, mask = HashTextEncoder(embed_dim=TEXT_DIM).encode_text(CAPTIONS + OTHER)
    jfeats, jmask = JHash(embed_dim=TEXT_DIM).encode_text(CAPTIONS + OTHER)
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.sum(1).tolist() == [6, 2, 3, 5]


@pytest.fixture(scope="module")
def tiny_hf(tmp_path_factory):
    """(the CLIP model's directory, the BERT model's) of
    `tests/fixtures/tiny_hf.py`; skipped where `transformers` is absent."""
    pytest.importorskip("transformers")
    write = runpy.run_path(os.path.join(_REPO, "tests/fixtures/tiny_hf.py"))["write_tiny_hf_models"]
    return dict(zip(("clip", "bert"), write(tmp_path_factory.mktemp("hf"))))


@pytest.mark.parametrize("name", ["clip", "bert"])
def test_hf_encoders_match_jax(tiny_hf, name):
    """`CLIPTextEncoder` / `BERTTextEncoder` of both packages on one local
    model: the same last hidden state and mask (one torch model on the CPU
    either way, so equal to f32 rounding)."""
    from dynamicvectorquantization_tpu.nn import text_encoders as jenc

    from dynamicvectorquantization_torch.nn import text_encoders as tenc

    cls = {"clip": "CLIPTextEncoder", "bert": "BERTTextEncoder"}[name]
    feats, mask = getattr(tenc, cls)(tiny_hf[name]).encode_text(CAPTIONS, device="cpu")
    jfeats, jmask = getattr(jenc, cls)(tiny_hf[name]).encode_text(CAPTIONS)
    assert feats.shape == (2, 77, 16) and feats.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=1e-6, rtol=0)
    assert 2 < mask.sum(1)[1] < mask.sum(1)[0] < 77


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["clip", "bert"])
def test_hf_encoders_run_on_the_callers_device(tiny_hf, name):
    """On a CUDA `device` the model runs there (its parameters move), and
    its features hold against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dynamicvectorquantization_torch.nn import text_encoders as tenc

    enc = getattr(tenc, {"clip": "CLIPTextEncoder", "bert": "BERTTextEncoder"}[name])(
        tiny_hf[name])
    want, want_mask = enc.encode_text(CAPTIONS, device="cpu")
    feats, mask = enc.encode_text(CAPTIONS, device="cuda")
    assert feats.is_cuda and mask.is_cuda and next(enc.model.parameters()).is_cuda
    torch.testing.assert_close(mask.cpu(), want_mask, rtol=0, atol=0)
    torch.testing.assert_close(feats.cpu(), want, rtol=0, atol=1e-4)


# ------------------------------------------------------------- T2IDualformer
def test_t2i_losses_match_jax(pair):
    import jax.numpy as jnp

    jmodel, variables, port = pair
    x = torch.from_numpy(_images(2, 2))
    z = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in port.encode_to_z(x)[1].items()}
    out = {}
    for name, caps in (("a", CAPTIONS), ("b", OTHER)):
        text = {}
        if port.use_text_conditioning:  # what JAX's `forward` hands over
            feats, mask = jmodel.text_encoder.encode_text(caps)
            text = dict(text_memory=feats, text_mask=mask)
        ref = jmodel.forward_tokens(variables, z, z, **text)
        with torch.no_grad():
            got = port(x, caps)
        for key in LOSS_NAMES:
            np.testing.assert_allclose(float(got[key]), float(ref[key]), atol=ATOL, rtol=0,
                                       err_msg=f"{name} {key}")
        out[name] = float(got["content_loss"])
    # captions shift the content loss only when they are consumed
    assert (out["a"] != out["b"]) == port.use_text_conditioning


def test_flag_off_keys_are_the_plain_dualformers(pair):
    _, _, port = pair
    plain = instantiate_from_config(load_config([TINY])["model"])
    keys, plain_keys = set(port.state_dict()), set(plain.state_dict())
    extra = {k for k in keys - plain_keys}
    if port.use_text_conditioning:
        assert plain_keys < keys and extra and all(
            ".xattn." in k or ".ln_x." in k or k.startswith("transformer.text_proj.")
            for k in extra)
        assert port.transformer.text_proj.in_features == TEXT_DIM  # the encoder's embed_dim
    else:
        assert keys == plain_keys


def _text(port, captions):
    feats, mask = port.encode_text(captions, "cpu")
    return feats, mask


def _streams(p, b, n, seed=1):
    r = np.random.default_rng(seed)
    return dict(content=r.integers(0, p["vocab_size"], (b, n)),
                coarse_pos=r.integers(0, p["coarse_position_size"], (b, n)),
                fine_pos=r.integers(0, p["fine_position_size"], (b, n)))


def test_logits_and_content_steps_with_captions_match_jax(pair):
    """The consuming variant's StackGPT with caption memory: the full
    forward's logits, and 10 teacher-forced cached steps whose content
    logits equal both the JAX step's and the full forward's."""
    import jax.numpy as jnp

    jmodel, variables, port = pair
    if not port.use_text_conditioning:
        pytest.skip("the dropped variant has no caption memory")
    jgpt, jvars, tgpt = jmodel.transformer, variables["transformer"], port.transformer
    p = load_config([TINY])["model"]["params"]["transformer_config"]["params"]
    b, lc, lf = 2, 3, 4
    s = _streams(p, b, lc + lf)
    seg = np.concatenate([np.zeros((b, lc)), np.ones((b, lf))], 1).astype(np.int64)
    streams = (s["content"][:, :lc], s["content"][:, lc:], s["coarse_pos"][:, :lc] % 16,
               s["fine_pos"][:, lc:], seg[:, :lc], seg[:, lc:])
    feats, mask = _text(port, CAPTIONS)
    ref = jgpt.apply(jvars, *(jnp.asarray(a, jnp.int32) for a in streams),
                     text_memory=jnp.asarray(feats.numpy()), text_mask=jnp.asarray(mask.numpy()))
    with torch.no_grad():
        full = tgpt(*(torch.from_numpy(a) for a in streams), text_memory=feats, text_mask=mask)
    for key in ("position_logits", "content_logits"):
        np.testing.assert_allclose(full[key].numpy(), np.asarray(ref[key]), atol=ATOL, rtol=0)

    # cached steps over the same teacher-forced streams
    content = np.concatenate(streams[:2], 1)
    position = np.concatenate(streams[2:4], 1)
    jpos, jcont = jgpt.apply(jvars, b, lc + lf, jnp.float32, method="make_caches")
    tpos, tcont = tgpt.make_caches(b, lc + lf, torch.float32, "cpu")
    jtext = dict(text_memory=jnp.asarray(feats.numpy()), text_mask=jnp.asarray(mask.numpy()))
    for i in range(lc + lf - 1):
        fine, next_fine = i >= lc, i + 1 >= lc
        args = (content[:, i], position[:, i], seg[:, i])
        x = jgpt.apply(jvars, *(jnp.asarray(a, jnp.int32) for a in args), i, fine,
                       method="embed_input_token")
        hidden, _, jpos = jgpt.apply(jvars, x, jpos, i, method="position_step")
        jcl, jcont = jgpt.apply(jvars, hidden, jnp.asarray(position[:, i + 1], jnp.int32),
                                next_fine, jcont, i, method="content_step", **jtext)
        with torch.no_grad():
            xt = tgpt.embed_input_token(*(torch.from_numpy(a).long() for a in args), i, fine)
            ht, _ = tgpt.position_step(xt, tpos, i)
            tcl = tgpt.content_step(ht, torch.from_numpy(position[:, i + 1]).long(), next_fine,
                                    tcont, i, text_memory=feats, text_mask=mask)
        np.testing.assert_allclose(tcl.numpy(), np.asarray(jcl), atol=ATOL, rtol=0,
                                   err_msg=f"content step {i}")
        np.testing.assert_allclose(tcl.numpy(), full["content_logits"][:, i].numpy(),
                                   atol=ATOL, rtol=0, err_msg=f"step {i} vs the forward")


def test_masked_caption_padding_is_inert(pair):
    _, _, port = pair
    if not port.use_text_conditioning:
        pytest.skip("the dropped variant has no caption memory")
    x = torch.from_numpy(_images(3, 2))
    _, z = port.encode_to_z(x)
    feats, mask = _text(port, CAPTIONS)
    noisy = torch.where(mask[..., None] > 0, feats, torch.randn(feats.shape) * 3.0)
    with torch.no_grad():
        a = port.forward_tokens(z, text_memory=feats, text_mask=mask)
        b = port.forward_tokens(z, text_memory=noisy, text_mask=mask)
        c = port.forward_tokens(z, text_memory=noisy, text_mask=torch.ones_like(mask))
    assert float(a["content_loss"]) == float(b["content_loss"])
    assert float(a["content_loss"]) != float(c["content_loss"])  # unmasked, the noise counts


def test_uncaptioned_greedy_sample_is_token_exact(pair):
    """As the JAX package samples a T2I model: the inherited sampler, no
    caption."""
    import jax

    jmodel, variables, port = pair
    jc = jmodel.encode_to_c(jax.numpy.zeros((2, 1)))
    ref = jmodel.sample_from_scratch(variables, *jc, rng=jax.random.PRNGKey(0), sample=False)
    out = port.sample_from_scratch(*port.encode_to_c(2), sample=False)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_trainer_step_on_captions(pair):
    """`Stage2Trainer` takes the captions as the condition of an
    inline-encode step; the first step's losses are the forward's."""
    from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer

    _, _, port = pair
    port = copy.deepcopy(port)
    x = _images(4, 2)
    with torch.no_grad():
        want = port(torch.from_numpy(x), CAPTIONS)
    trainer = Stage2Trainer(port, 1e-3, max_steps=10, device="cpu")
    logs = trainer.train_step(x, c=CAPTIONS)
    np.testing.assert_allclose(float(logs["train_content_loss"]), float(want["content_loss"]),
                               rtol=1e-6)
    assert trainer.count == 1 and np.isfinite(float(trainer.eval_step(x, CAPTIONS)["val_loss"]))


@pytest.mark.parametrize("on", [False, True], ids=["dropped", "consumed"])
def test_loop_refuses_cached_codes_for_text_models(tmp_path, capsys, on):
    from dynamicvectorquantization_torch.train.loop import Trainer

    cfg = load_config([TINY])
    model = instantiate_from_config(t2i_config(cfg, on, PKG))
    model.learning_rate, model.min_learning_rate = 1e-3, 0.0
    data = instantiate_from_config(cfg["data"])
    kw = dict(max_epochs=1, max_steps_per_epoch=1, device="cpu", image_log_frequency=0)
    with pytest.raises(ValueError, match="text features are not cached"):
        Trainer(str(tmp_path / "on"), cached_codes="on", **kw).fit(model, data)
    # auto downgrades to inline encoding, whose steps need the batch's captions
    with pytest.raises(ValueError, match="captions"):
        Trainer(str(tmp_path / "auto"), cached_codes="auto", **kw).fit(model, data)
    assert "cached_codes auto: OFF" in capsys.readouterr().out


# ------------------------------------------------------------------ registry
def test_every_reference_alias_of_the_jax_registry_resolves():
    import importlib

    from dynamicvectorquantization_tpu.config.registry import TARGET_ALIASES as JALIASES

    from dynamicvectorquantization_torch.config.registry import resolve_target

    def exists(path):
        module, name = path.rsplit(".", 1)
        return hasattr(importlib.import_module(module), name)

    assert len(JALIASES) >= 102
    for ref, jpath in JALIASES.items():
        here = resolve_target(ref)
        assert here.startswith(PKG + ".") and exists(here), ref
        tail = jpath.split(".", 1)[1]
        if tail.startswith("data."):  # a data class resolves by its tail from any package
            assert resolve_target(jpath) == f"{PKG}.{tail}"
            continue
        # the JAX package's own spelling is refused, naming this package's path
        with pytest.raises(KeyError, match="ROADMAP.md") as err:
            resolve_target(jpath)
        msg = str(err.value)
        assert "Slices to port" in msg and "another package" in msg
        assert f"'{PKG}.{tail}'" in msg, msg
