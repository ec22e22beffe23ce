"""The stage-2 trainer's first stage in bf16 (mode (i): every floating leaf of
the frozen first stage cast to bf16, the images cast to bf16) against the
JAX package's `Stage2Trainer(compute_dtype="bfloat16")`, at the tiny stage-2
configuration on the CPU.

Weights: the JAX first stage's init, perturbed from a numpy seed, with a
codebook of well-separated codes, carried to the port by `utils/weights.py`.
The router's threshold is set between the bf16 and the f32 entropy of the
patch where the two differ most (JAX's own numbers), so that an encode in
f32 puts that patch in the other grain: that is what an f32 encode of the
shipped p6c18 trainer did (F4).

What is compared, with what tolerance:
  * the entropy map within 2e-6 and the grain map exactly, except a cell
    whose JAX entropy lies within 1e-5 of the threshold;
  * the features the VQ searches (`quant_conv`'s output): each row within
    10 % of the mean row norm (L2) of JAX's, as far as the two frameworks'
    bf16 roundings (XLA's CPU sigmoid rounds three steps to bf16, the port
    one; attention rounds as the TPU kernel, not as JAX's CPU einsums;
    sums in other orders) carry them apart;
  * the codes: those of the f32 search of JAX's features, except where that
    search is a near tie: the score gap between the two codes smaller than
    what the measured feature difference can move it (2 |dh| |c_a - c_b|);
  * the cached-codes streams of `encode_dataset`: the JAX permuter's
    packing of the port's codes and grains, and equal to those of JAX's
    `encode_dataset` (its `make_encode_fn`, the VQ through the Pallas kernel
    in interpret mode) for every image whose grains and codes all agree;
  * one stage-2 `train_step` of each trainer on these streams: losses within
    5e-2, the bf16 tolerance of the port's stage-2 tests;
  * `eval_step` on images encodes in f32, as the JAX trainer's does.

JAX is imported inside the fixtures and tests.
"""
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.weights import dqvae_state_dict_from_flax


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
LR = 1e-3
N_IMAGES, BATCH = 8, 4
ENTROPY_MARGIN = 1e-5
FEATURE_REL = 0.1
LOSS_ATOL = 5e-2


def _images(seed, b, size=64):
    """Left half smooth, right half noisy, so both grains occur."""
    r = np.random.default_rng(seed)
    x = r.uniform(-1, 1, size=(b, size, size, 3)).astype(np.float32)
    x[:, :, : size // 2] = (0.2 + 0.01 * x[:, :, : size // 2]).astype(np.float32)
    return x


def _config(threshold, use_pallas=False):
    cfg = load_config([TINY])["model"]
    fs = cfg["params"]["first_stage_config"]["params"]
    fs["encoderconfig"]["params"]["router_config"]["params"]["threshold"] = float(threshold)
    fs["vqconfig"]["params"]["use_pallas"] = use_pallas
    return cfg


@pytest.fixture(scope="module")
def setup():
    """The JAX model, its variables, its trainer, the threshold, the images,
    and the JAX numbers the test holds the port to."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from dynamicvectorquantization_tpu.ops.entropy import patch_entropy as jax_entropy
    from dynamicvectorquantization_tpu.train.stage2 import Stage2Trainer as JaxTrainer
    from dynamicvectorquantization_tpu.train.stage2 import _cast_tree
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from tests.test_torch_stackgpt import perturbed

    images = _images(11, N_IMAGES)
    xb = jnp.asarray(images).astype(jnp.bfloat16)
    e16 = np.asarray(jax_entropy(xb, 16))
    e32 = np.asarray(jax_entropy(jnp.asarray(images), 16))
    flat = int(np.argmax(np.abs(e16 - e32)))
    threshold = float((e16.reshape(-1)[flat] + e32.reshape(-1)[flat]) / 2)

    # the VQ through the Pallas kernel (interpret mode): the f32 search of
    # the bf16 rows, as on the TPU; the JAX package's CPU route would score
    # bf16 rows against the bf16 codebook in bf16
    jmodel = jinst(_config(threshold, use_pallas=True))
    with pltpu.force_tpu_interpret_mode():
        init = jax.device_get(jmodel.first_stage_model.init(jax.random.PRNGKey(0)))
    r = np.random.default_rng(12)
    params = perturbed(init["params"], r, 0.05)
    k, d = 64, 32
    codebook = (0.5 * r.normal(size=(k + 1, d))).astype(np.float32)
    codebook[k] = 0.0
    ema = {"quantize": {**init["ema"]["quantize"], "codebook": jnp.asarray(codebook),
                        "embed_ema": jnp.asarray(codebook[:k])}}
    first_stage = {"params": params, "ema": ema}

    port = instantiate_from_config(_config(threshold))
    port.init_weights(torch.Generator().manual_seed(0))
    port.first_stage_model.load_state_dict(dqvae_state_dict_from_flax(first_stage))
    port.eval()
    from dynamicvectorquantization_tpu.utils.torch_ckpt import convert_stackgpt_state_dict

    sd = {k_: v.numpy() for k_, v in port.state_dict().items()}
    variables = {"transformer": convert_stackgpt_state_dict(sd, prefix="transformer."),
                 "first_stage": first_stage}
    jtrainer = JaxTrainer(jmodel, LR, warmup_steps=0, max_steps=50, compute_dtype="bfloat16",
                          fused_adamw=True)

    # JAX's mode-(i) encode, piece by piece: the make_encode_fn casts
    cast = _cast_tree(first_stage, jnp.bfloat16)
    net = jmodel.first_stage_model.net

    def features(m, x):
        ent = jax_entropy(x, 16)
        h = m.encoder(x, ent)
        return m.quant_conv(h["h_dual"]), h["indices"], ent

    # jitted and in the batches `encode_dataset` takes, as `make_encode_fn`
    # runs it: XLA rounds bf16 differently with and without jit
    feat_fn = jax.jit(lambda x: net.apply(cast, x, method=features))
    parts = [feat_fn(xb[i:i + BATCH]) for i in range(0, N_IMAGES, BATCH)]
    h, grains, ent = (jnp.concatenate(z) for z in zip(*parts))
    with pltpu.force_tpu_interpret_mode():
        code_fn = jax.jit(lambda x: jmodel.first_stage_model.encode(cast, x)[2][2])
        codes = jnp.concatenate([code_fn(xb[i:i + BATCH]) for i in range(0, N_IMAGES, BATCH)])
        ref_streams = jtrainer.encode_dataset(variables, images, batch=BATCH)
    return dict(jmodel=jmodel, variables=variables, jtrainer=jtrainer, port=port,
                images=images, threshold=threshold, flipped=flat,
                e16=e16, e32=e32, h=np.asarray(h.astype(jnp.float32)),
                grains=np.asarray(grains), entropy=np.asarray(ent), codes=np.asarray(codes),
                codebook=np.asarray(cast["ema"]["quantize"]["codebook"]
                                    .astype(jnp.float32))[:k],
                ref_streams=ref_streams)


@pytest.fixture(scope="module")
def port_encode(setup):
    """The port's trainer, its streams, and the grains, codes, entropies and
    features of the first-stage encodes that made them."""
    trainer = Stage2Trainer(setup["port"], LR, warmup_steps=0, max_steps=50,
                            compute_dtype="bfloat16", device="cpu")
    fs = trainer.frozen_first_stage
    seen, feats = [], []
    hook = fs.quant_conv.register_forward_hook(lambda m, i, o: feats.append(o))
    encode = fs.encode
    fs.encode = lambda *a, **k: seen.append(encode(*a, **k)) or seen[-1]
    try:
        streams = trainer.encode_dataset(setup["images"], batch=BATCH)
    finally:
        del fs.encode
        hook.remove()
    grains, codes, ent = (torch.cat(z).numpy() for z in zip(*(
        (out[3], out[2][2], out[5]) for out in seen)))
    h = torch.cat(feats).float().permute(0, 2, 3, 1).numpy()
    return dict(trainer=trainer, streams=streams, grains=grains, codes=codes, entropy=ent, h=h)


def _f32_search(h, codebook):
    """(codes, scores |c|^2 - 2 h.c) of the features h (.., D), in float64."""
    h = h.reshape(-1, h.shape[-1]).astype(np.float64)
    cb = codebook.astype(np.float64)
    scores = (cb * cb).sum(1)[None] - 2.0 * h @ cb.T
    return scores.argmin(1), scores


def test_the_threshold_separates_the_bf16_and_f32_entropy_of_one_patch(setup):
    e16, e32, thr = (setup[k] for k in ("e16", "e32", "threshold"))
    i = setup["flipped"]
    assert (e16.reshape(-1)[i] > thr) != (e32.reshape(-1)[i] > thr)
    assert abs(e16.reshape(-1)[i] - thr) > 100 * ENTROPY_MARGIN


def test_the_frozen_first_stage_is_a_bf16_copy(setup, port_encode):
    trainer = port_encode["trainer"]
    fs = trainer.frozen_first_stage
    assert fs is not setup["port"].first_stage_model
    assert all(t.dtype == torch.bfloat16 for t in (*fs.parameters(), *fs.buffers())
               if t.is_floating_point())
    assert all(p.dtype == torch.float32 for p in setup["port"].first_stage_model.parameters())
    assert not any(p.requires_grad for p in fs.parameters())
    own = setup["port"].first_stage_model.state_dict()
    for name, t in fs.state_dict().items():
        assert torch.equal(t, own[name].to(t.dtype)), name


def test_entropy_and_grains_match_jax(setup, port_encode):
    np.testing.assert_allclose(port_encode["entropy"], setup["entropy"], atol=2e-6, rtol=0)
    differ = port_encode["grains"] != setup["grains"]
    assert np.all(np.abs(setup["entropy"][differ] - setup["threshold"]) <= ENTROPY_MARGIN)
    assert 0 < setup["grains"].mean() < 1  # both grains


def test_features_and_codes_match_jax_up_to_near_ties(setup, port_encode):
    h_j = setup["h"].reshape(-1, setup["h"].shape[-1]).astype(np.float64)
    h_p = port_encode["h"].reshape(h_j.shape).astype(np.float64)
    row_diff = np.linalg.norm(h_p - h_j, axis=1)
    scale = np.linalg.norm(h_j, axis=1).mean()
    assert row_diff.max() <= FEATURE_REL * scale, (row_diff.max(), scale)
    ref, scores = _f32_search(setup["h"], setup["codebook"])
    cb = setup["codebook"].astype(np.float64)
    got = port_encode["codes"].reshape(-1)
    rows = np.arange(len(ref))
    gap = scores[rows, got] - scores[rows, ref]
    allowed = 2 * row_diff * np.linalg.norm(cb[got] - cb[ref], axis=1)
    assert np.all((got == ref) | (gap <= allowed))
    assert (got == ref).mean() >= 0.95


def test_cached_streams_match_jax_make_encode_fn(setup, port_encode):
    import jax.numpy as jnp

    np.testing.assert_array_equal(  # the Pallas route's codes: the f32 search
        setup["codes"].reshape(-1), _f32_search(setup["h"], setup["codebook"])[0])
    ref, out = setup["ref_streams"], port_encode["streams"]
    assert sorted(out) == sorted(ref)
    jax_packed = setup["jmodel"].permuter.forward(jnp.asarray(setup["codes"]),
                                                  jnp.asarray(setup["grains"]))
    for key in ref:  # the codes and grains above are those of make_encode_fn
        np.testing.assert_array_equal(np.asarray(jax_packed[key]), ref[key], err_msg=key)
    # every image: the port's streams are the JAX permuter's packing of the
    # port's own codes and grains (which the tests above hold to JAX's)
    packed = setup["jmodel"].permuter.forward(jnp.asarray(port_encode["codes"], jnp.int32),
                                              jnp.asarray(port_encode["grains"], jnp.int32))
    # the images whose codes and grains all agree: JAX's streams themselves
    same = ((setup["codes"] == port_encode["codes"]).all(axis=(1, 2))
            & (setup["grains"] == port_encode["grains"]).all(axis=(1, 2)))
    assert same.any()
    for key in ref:
        assert out[key].shape == ref[key].shape
        np.testing.assert_array_equal(out[key], np.asarray(packed[key]), err_msg=key)
        np.testing.assert_array_equal(out[key][same], ref[key][same], err_msg=key)


def test_train_step_on_the_bf16_streams_matches_jax(setup, port_encode):
    import jax
    import jax.numpy as jnp

    jtrainer, variables = setup["jtrainer"], setup["variables"]
    streams = {k: v[:BATCH] for k, v in setup["ref_streams"].items()}
    state = jtrainer.init_state(variables)
    z = {k: jnp.asarray(v, jnp.int32) for k, v in streams.items()}
    _, jlogs = jax.jit(jtrainer.train_step)(state, variables, z, z, jax.random.PRNGKey(0))
    logs = port_encode["trainer"].train_step(streams)
    assert sorted(logs) == sorted(jlogs)
    for key, want in jlogs.items():
        np.testing.assert_allclose(float(logs[key]), float(want), atol=LOSS_ATOL, rtol=0,
                                   err_msg=key)


def test_eval_step_encodes_with_the_f32_first_stage(setup, port_encode):
    """`eval_step` on images: the f32 first stage and f32 images, so its
    losses are those of the f32 trainer on the same weights (the same f32
    arithmetic: atol 1e-6)."""
    trainer = port_encode["trainer"]
    f32 = Stage2Trainer(instantiate_from_config(_config(setup["threshold"])), LR,
                        warmup_steps=0, max_steps=50, device="cpu")
    f32.model.load_state_dict(setup["port"].state_dict())
    with torch.no_grad():
        for name, p in f32.params.items():
            p.copy_(trainer.masters[name])
    x = setup["images"][:2]
    got, want = trainer.eval_step(x), f32.eval_step(x)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), atol=1e-6, rtol=0,
                                   err_msg=key)


def test_refresh_first_stage_follows_new_weights(setup):
    """A first stage loaded after the trainer was built (a resumed run)
    reaches the bf16 copy through `refresh_first_stage`."""
    model = instantiate_from_config(_config(setup["threshold"]))
    model.init_weights(torch.Generator().manual_seed(1))
    trainer = Stage2Trainer(model, LR, compute_dtype="bfloat16", device="cpu")
    model.first_stage_model.load_state_dict(setup["port"].first_stage_model.state_dict())
    w = trainer.frozen_first_stage.encoder.conv_in.weight
    assert not torch.equal(w, model.first_stage_model.encoder.conv_in.weight.to(w.dtype))
    trainer.refresh_first_stage()
    w = trainer.frozen_first_stage.encoder.conv_in.weight
    assert torch.equal(w, model.first_stage_model.encoder.conv_in.weight.to(torch.bfloat16))
    f32 = Stage2Trainer(model, LR, device="cpu")
    assert f32.frozen_first_stage is model.first_stage_model
