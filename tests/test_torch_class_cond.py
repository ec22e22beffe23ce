"""The class-conditional model of the port (`ClassCondDualformer`, its two
label providers) against the JAX package's at the tiny class config of
tests/test_class_cond.py (vocabulary 76, positions 28 / 76, 2 + 2 layers,
n_embd 32, ten classes): the providers' prefixes, the class-range bans of
both masks (exact), greedy `sample_from_scratch` token-exact for labels
[3, 7, 0, 9] with float and int8 caches in both fine-position modes (images
f32 atol 1e-4), the training losses with labels (atol 1e-5), and one f32
`Stage2Trainer` step and `eval_step` with labels against the JAX trainer
(the tolerances of tests/test_torch_train.py).

Weights are made once in the port (seeded init, perturbed from a numpy seed
so greedy choices are far from ties) and carried to the JAX package by its
own converters. JAX is imported inside the tests and fixtures.
"""
import copy
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.models import label_providers as tlp
from dynamicvectorquantization_torch.models.dqtransformer import ClassCondDualformer
from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.weights import stackgpt_state_dict_from_flax


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
N_CLASSES, CODEBOOK = 10, 64
# [0..63 codes][64 pad][65 eos][66.. classes]; coarse positions [0..15][16 pad][17 eos][18..]
VOCAB, COARSE_POS, FINE_POS = CODEBOOK + 2 + N_CLASSES, 16 + 2 + N_CLASSES, 64 + 2 + N_CLASSES
CLASS_TARGET = "models.stage2_dynamic.dqtransformer_class2_entropy.Dualformer"
COND_CFG = {
    "target": "modules.dynamic_modules.label_provider.ClassAwareSOSProvider",
    "params": {"n_classes": N_CLASSES, "threshold_content": CODEBOOK + 2,
               "threshold_coarse_position": 18, "threshold_fine_position": CODEBOOK + 2,
               "coarse_seg_sos": 0, "fine_seg_sos": 1},
}
LABELS = [3, 7, 0, 9]
LR, MAX_STEPS = 1e-3, 50
GRAD_FLOOR = 1e-5
LOSS_NAMES = ("loss", "content_loss", "position_loss", "coarse_position_loss",
              "fine_position_loss")


def class_config(cfg):
    """The tiny stage-2 yml as loaded (either package's loader) made
    class-conditional: the class model, the class provider, vocabularies
    with ten class tokens, and synthetic data with ten classes."""
    cfg = copy.deepcopy(cfg)
    model = cfg["model"]
    model["target"] = CLASS_TARGET
    model["params"].pop("uncond_stage_config")
    model["params"]["cond_stage_config"] = copy.deepcopy(COND_CFG)
    model["params"]["transformer_config"]["params"].update(
        vocab_size=VOCAB, coarse_position_size=COARSE_POS, fine_position_size=FINE_POS)
    for split in ("train", "validation"):
        cfg["data"]["params"][split]["params"]["num_classes"] = N_CLASSES
    return cfg


def _images(seed, b, size=64):
    """Left half smooth, right half noisy, so both grains occur."""
    r = np.random.default_rng(seed)
    x = r.uniform(-1, 1, size=(b, size, size, 3)).astype(np.float32)
    x[:, :, : size // 2] = (0.2 + 0.01 * x[:, :, : size // 2]).astype(np.float32)
    return x


def _port(state_dict=None, kv_cache_dtype=None):
    cfg = class_config(load_config([TINY]))["model"]
    if kv_cache_dtype:
        cfg["params"]["transformer_config"]["params"]["kv_cache_dtype"] = kv_cache_dtype
    model = instantiate_from_config(cfg)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state_dict)
    return model.eval()


def _jax(state_dict, kv_cache_dtype=None):
    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload_config
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import (
        convert_dqvae_state_dict,
        convert_stackgpt_state_dict,
    )

    cfg = class_config(jload_config([TINY]))
    if kv_cache_dtype:
        cfg["model"]["params"]["transformer_config"]["params"]["kv_cache_dtype"] = kv_cache_dtype
    model = jinst(cfg["model"])
    sd = {k: v.numpy() for k, v in state_dict.items()}
    fs = {k[len("first_stage_model."):]: v for k, v in sd.items()
          if k.startswith("first_stage_model.")}
    fs["quantize.codebook.cluster_size_ema"] = np.zeros(fs["quantize.codebook.weight"].shape[0] - 1,
                                                       np.float32)
    fs["quantize.codebook.embed_ema"] = fs["quantize.codebook.weight"][:-1]
    variables = {"transformer": convert_stackgpt_state_dict(sd, prefix="transformer."),
                 "first_stage": convert_dqvae_state_dict(fs)}
    return model, variables


@pytest.fixture(scope="module")
def state_dict():
    model = _port()
    r = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.transformer.parameters():
            p.add_(torch.from_numpy(r.normal(0.0, 0.1, tuple(p.shape)).astype(np.float32)))
        cb = model.first_stage_model.quantize.codebook.weight
        cb[:-1] = torch.from_numpy((0.5 * r.normal(size=tuple(cb[:-1].shape))).astype(np.float32))
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_side(state_dict):
    return _jax(state_dict)


@pytest.fixture(scope="module")
def streams(state_dict):
    """Two batches of four cached code streams, encoded by the port, and
    their labels."""
    trainer = Stage2Trainer(_port(state_dict), LR, max_steps=MAX_STEPS, device="cpu")
    z = trainer.encode_dataset(_images(1, 8), batch=4)
    labels = np.array([3, 7, 0, 9, 1, 5, 5, 2], np.int32)
    return [({k: v[i:i + 4] for k, v in z.items()}, labels[i:i + 4]) for i in (0, 4)]


# ------------------------------------------------------------------ providers
PROVIDERS = [
    ("ClassAwareSOSProvider", COND_CFG["params"]),
    ("ClassAwareSOSProvider", {**COND_CFG["params"], "coarse_seg_sos": None,
                               "fine_seg_sos": None}),  # no fine prefixes
    ("ClassForContentOnlyPositionAwareSOSProvider",
     {"n_classes": N_CLASSES, "threshold": 66, "coarse_pos_sos": 18, "fine_pos_sos": 66,
      "coarse_seg_sos": 0, "fine_seg_sos": 1}),
    ("ClassForContentOnlyPositionAwareSOSProvider",
     {"n_classes": N_CLASSES, "threshold": 66, "coarse_pos_sos": 18}),  # no fine prefixes
]


@pytest.mark.parametrize("name,params", PROVIDERS)
def test_class_providers_encode_like_jax(name, params):
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.models import label_providers as jlp

    port, ref = getattr(tlp, name)(**params), getattr(jlp, name)(**params)
    got = port.encode(torch.tensor(LABELS))
    want = ref.encode(jnp.asarray(LABELS))
    assert len(got) == len(want) == 6
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), i
        if a is not None:
            assert a.shape == (4, 1) and a.dtype == torch.long
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(i))
    # (B, 1) labels give the same; a batch size means label 0 for every row
    for a, b in zip(port.encode(torch.tensor(LABELS)[:, None]), got):
        assert (a is None and b is None) or torch.equal(a, b)
    for a, b in zip(port.encode(3), ref.encode(jnp.zeros((3, 1)))):
        assert (a is None and b is None) or np.array_equal(a.numpy(), np.asarray(b))


def test_class_yml_builds_the_class_model(state_dict):
    """Both reference targets and the shipped class yml resolve to the
    class model and its provider."""
    model = _port(state_dict)
    assert isinstance(model, ClassCondDualformer) and model.cond_is_class
    assert model.cond_stage_key == "class_label"
    assert isinstance(model.cond_stage_model, tlp.ClassAwareSOSProvider)
    # the SOS codes fall back to the provider's thresholds, as in the JAX package
    assert model.content_sos_code == 66 and model.fine_position_sos_code == 66
    cfg = load_config([os.path.join(_REPO, "configs/stage2/class_imagenet_p6c18.yml")])
    from dynamicvectorquantization_torch.config.registry import resolve_target

    for target in (cfg["model"]["target"], "models.stage2_dynamic.dqtransformer_class.Dualformer"):
        assert resolve_target(target).endswith("models.dqtransformer.ClassCondDualformer")
    assert resolve_target(cfg["model"]["params"]["cond_stage_config"]["target"]).endswith(
        "label_providers.ClassAwareSOSProvider")
    params = cfg["model"]["params"]
    params["transformer_config"]["params"].update(n_embd=16, n_head=2, position_layer=1,
                                                  content_layer=1)
    full = instantiate_from_config(cfg["model"])  # the shipped geometry, narrow
    assert isinstance(full, ClassCondDualformer) and full.vocab_size == 2026
    c = full.encode_to_c(torch.tensor([0, 999]))
    assert c[0].tolist() == [[1026], [2025]] and c[2].tolist() == [[258], [1257]]


# ---------------------------------------------------------------------- masks
def test_class_masks_equal_jax(state_dict, jax_side):
    import jax.numpy as jnp

    port = _port(state_dict)
    jmodel, _ = jax_side
    r = np.random.default_rng(4)
    b = 6
    done = np.array([False, True, False, False, True, False])
    content = r.normal(size=(b, VOCAB)).astype(np.float32)
    got = port._content_mask(torch.from_numpy(content), torch.from_numpy(done))
    want = jmodel._content_mask(jnp.asarray(content), jnp.asarray(done))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    live = got.numpy()[~done]
    assert (live[:, CODEBOOK:] == -1e9).all() and (live[:, :CODEBOOK] > -1e9).all()
    pos = r.normal(size=(b, FINE_POS)).astype(np.float32)
    pos_ban = r.random((b, FINE_POS)) < 0.3
    pos_ban[0, 65] = True  # eos stays allowed even where banned
    got = port._fine_position_mask(torch.from_numpy(pos), torch.from_numpy(pos_ban),
                                   torch.from_numpy(done))
    want = jmodel._fine_position_mask(jnp.asarray(pos), jnp.asarray(pos_ban), jnp.asarray(done))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[~done][:, 66:] == -1e9).all() and got[0, 65] > -1e9


# ------------------------------------------------------------------- sampling
@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_greedy_class_sampling_token_exact_and_images_match(state_dict, kv_cache_dtype):
    import jax
    import jax.numpy as jnp

    port = _port(state_dict, kv_cache_dtype)
    jmodel, jvars = _jax(state_dict, kv_cache_dtype)
    jc = jmodel.encode_to_c(jnp.asarray(LABELS))
    c = port.encode_to_c(torch.tensor(LABELS))
    for fix in (False, True):
        ref = jmodel.sample_from_scratch(jvars, *jc, rng=jax.random.PRNGKey(0), sample=False,
                                         fix_fine_position=fix)
        out = port.sample_from_scratch(*c, sample=False, fix_fine_position=fix)
        for name, a, b in zip(("coarse_content", "fine_content", "coarse_position",
                               "fine_position"), out, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name} fix={fix}")
        cc, fc, cp, fp = (a.numpy() for a in out)
        assert cc.max() < CODEBOOK + 1 and fc.max() < CODEBOOK + 1  # no eos, no class token
        assert fp.max() <= CODEBOOK + 1  # codes, pad, eos; no class position
        assert ((cp < 15) | (cp == 16) | (cp == 17)).all()
    # the sampled streams are not degenerate: several coarse and fine codes
    assert (np.asarray(ref[2]) < 16).sum() > 4 and (np.asarray(ref[3]) < 64).sum() > 4
    # the labels steer the samples
    other = port.sample_from_scratch(*port.encode_to_c(4), sample=False)
    assert any(not torch.equal(a, b) for a, b in zip(other, out))

    img_ref = np.asarray(jmodel.decode_to_img(jvars, *ref))
    img = port.decode_to_img(*(torch.from_numpy(np.array(t)).long() for t in ref))
    assert img.shape == img_ref.shape == (4, 64, 64, 3)
    np.testing.assert_allclose(img.numpy(), img_ref, atol=1e-4, rtol=0)


def test_log_images_samples_from_the_labels(state_dict):
    port = _port(state_dict)
    x = torch.from_numpy(_images(2, 5))
    labels = torch.tensor(LABELS + [1])
    logs = port.log_images(x, labels, generator=torch.Generator().manual_seed(0), top_k=1,
                           top_k_pos=1)
    assert set(logs) == {"samples_fixed_fine_position", "samples_from_scratch", "inputs",
                         "reconstructions"}
    assert all(v.shape == (4, 64, 64, 3) and np.isfinite(v).all() for v in logs.values())
    greedy = port.decode_to_img(*port.sample_from_scratch(*port.encode_to_c(labels[:4]),
                                                          top_k=1, top_k_pos=1))
    np.testing.assert_array_equal(logs["samples_from_scratch"], greedy.numpy())


# ------------------------------------------------------------------- training
def test_training_losses_with_labels_match_jax(state_dict, jax_side, streams):
    import jax.numpy as jnp

    port = _port(state_dict)
    jmodel, jvars = jax_side
    z, labels = streams[0]
    with torch.no_grad():
        out = port.forward_tokens({k: torch.as_tensor(v) for k, v in z.items()},
                                  torch.as_tensor(labels))
        zero = port.forward_tokens({k: torch.as_tensor(v) for k, v in z.items()})
    ref = jmodel.forward_tokens(jvars, {k: jnp.asarray(v, jnp.int32) for k, v in z.items()},
                                jnp.asarray(labels))
    for key in LOSS_NAMES[1:]:
        np.testing.assert_allclose(float(out[key]), float(ref[key]), atol=1e-5, rtol=0,
                                   err_msg=key)
    np.testing.assert_allclose(float(port.loss(out)), float(jmodel.loss(ref)), atol=1e-5, rtol=0)
    assert float(zero["content_loss"]) != float(out["content_loss"])  # labels reach the loss


def test_trainer_step_and_eval_with_labels_match_jax(state_dict, jax_side, streams):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.train.stage2 import Stage2Trainer as JaxTrainer

    jmodel, jvars = jax_side
    z, labels = streams[0]
    jtrainer = JaxTrainer(jmodel, LR, warmup_steps=0, max_steps=MAX_STEPS, fused_adamw=True)
    state = jtrainer.init_state(jvars)
    jz = {k: jnp.asarray(v, jnp.int32) for k, v in z.items()}
    jc = jnp.asarray(labels)

    @jax.jit
    def grad_fn(params):
        def loss_fn(p):
            v = {**jvars, "transformer": {**jvars["transformer"], "params": p}}
            return jmodel.loss(jmodel.forward_tokens(v, jz, jc, train=True,
                                                     rngs={"dropout": jax.random.PRNGKey(0)}))
        return jtrainer._freeze_pad_rows(jax.grad(loss_fn)(params))

    ref_grads = stackgpt_state_dict_from_flax(jax.device_get(grad_fn(state.params)))
    state, ref_logs = jax.jit(jtrainer.train_step)(state, jvars, jz, jc, jax.random.PRNGKey(0))
    ref_params = stackgpt_state_dict_from_flax(jax.device_get(state.params))
    ref_val = jax.jit(jtrainer.eval_step)(state, jvars, jz, jc)

    trainer = Stage2Trainer(_port(state_dict), LR, warmup_steps=0, max_steps=MAX_STEPS,
                            device="cpu")
    start = {k: v.clone() for k, v in trainer.masters.items()}
    logs, grads = trainer.compute_grads(z, c=labels)
    for key in LOSS_NAMES:
        np.testing.assert_allclose(float(logs[f"train_{key}"]), float(ref_logs[f"train_{key}"]),
                                   atol=1e-5, rtol=0, err_msg=key)
    assert sorted(grads) == sorted(ref_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), atol=2e-6, rtol=1e-4,
                                   err_msg=f"grad {name}")
    trainer.apply_update(grads)
    for name, p in trainer.masters.items():
        want = ref_params[name]
        torch.testing.assert_close(p, want, atol=2.1 * LR, rtol=0, msg=name)
        big = ref_grads[name].abs() > GRAD_FLOOR
        torch.testing.assert_close(p[big], want[big], atol=1e-6, rtol=0, msg=name)
    for name, row in trainer.pad_rows.items():
        assert torch.equal(trainer.masters[name][row], start[name][row]), name
    val = trainer.eval_step(z, labels)
    for key, want in ref_val.items():
        np.testing.assert_allclose(float(val[key]), float(want), atol=1e-5, rtol=0, err_msg=key)


def test_accumulated_microbatches_carry_their_labels(state_dict, streams):
    """accum = 2 over two labelled microbatches equals the mean of the two
    single-batch gradients; the labels of each microbatch are its own."""
    single = Stage2Trainer(_port(state_dict), LR, max_steps=MAX_STEPS, device="cpu")
    parts = [single.compute_grads(z, c=c) for z, c in streams]
    stacked = {k: np.stack([z[k] for z, _ in streams]) for k in streams[0][0]}
    labels = np.stack([c for _, c in streams])
    accum = Stage2Trainer(_port(state_dict), LR, max_steps=MAX_STEPS, device="cpu", accum=2)
    logs, grads = accum.compute_grads(stacked, c=labels)
    np.testing.assert_allclose(float(logs["train_loss"]),
                               np.mean([float(p[0]["train_loss"]) for p in parts]), atol=1e-6)
    for name, g in grads.items():
        torch.testing.assert_close(g, (parts[0][1][name] + parts[1][1][name]) / 2, atol=1e-7,
                                   rtol=1e-5, msg=name)
    swapped = accum.compute_grads(stacked, c=labels[::-1].copy())[0]
    assert float(swapped["train_loss"]) != float(logs["train_loss"])
