"""Stage-2 training in the PyTorch port against the JAX package at the tiny
config, f32 on the CPU, dropout 0: the StackGPT training forward (logits atol
1e-5, the five losses 1e-5, both `activate_pad_ignore` branches, an all-pad
target), and the slice as a whole — `Stage2Trainer` of the JAX package
(`fused_adamw=True`, interpret mode) and the port's from the same converted
weights and the same cached streams: losses of two steps, the gradient of
every leaf, parameters after two steps, frozen pad rows, the decayed-name
set, the optimizer state carried across mid-run, `encode_dataset`, and a
bf16 step through the plain versions.

Weights are made once in the port (seeded init, perturbed from a numpy seed
so zero-initialised tables carry signal) and carried to the JAX package by
its own converters. JAX is imported inside the tests and fixtures.
"""
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.nn.stackgpt import cross_entropy_ignore
from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer, decayed_parameter_names
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables
from dynamicvectorquantization_torch.utils.weights import (
    adamw_state_from_optax,
    stackgpt_state_dict_from_flax,
)


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
LR, MAX_STEPS = 1e-3, 50
BATCH = 4  # 4 x 83 tokens = 332 rows: LayerNorm goes through the autograd Function
GRAD_FLOOR = 1e-5  # parameters are compared tightly where both steps' |gradient| exceeds this
LOSS_NAMES = ("loss", "content_loss", "position_loss", "coarse_position_loss",
              "fine_position_loss")


def _images(seed, b, size=64):
    """Left half smooth, right half noisy, so both grains occur."""
    r = np.random.default_rng(seed)
    x = r.uniform(-1, 1, size=(b, size, size, 3)).astype(np.float32)
    x[:, :, : size // 2] = (0.2 + 0.01 * x[:, :, : size // 2]).astype(np.float32)
    return x


def _port_model(state_dict=None, **transformer_overrides):
    cfg = load_config([TINY])["model"]
    cfg["params"]["transformer_config"]["params"].update(transformer_overrides)
    model = instantiate_from_config(cfg)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state_dict)
    return model.eval()


def _trainer(state_dict, **kw):
    overrides = kw.pop("transformer_overrides", {})
    return Stage2Trainer(_port_model(state_dict, **overrides), LR, warmup_steps=0,
                         max_steps=MAX_STEPS, device="cpu", **kw)


@pytest.fixture(scope="module")
def state_dict():
    model = _port_model()
    r = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.transformer.parameters():
            p.add_(torch.from_numpy(r.normal(0.0, 0.05, tuple(p.shape)).astype(np.float32)))
        cb = model.first_stage_model.quantize.codebook.weight
        cb[:-1] = torch.from_numpy((0.5 * r.normal(size=tuple(cb[:-1].shape))).astype(np.float32))
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_side(state_dict):
    """(JAX model, its variables) with the port's weights."""
    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload_config
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import (
        convert_dqvae_state_dict,
        convert_stackgpt_state_dict,
    )

    model = jinst(jload_config([TINY])["model"])
    sd = {k: v.numpy() for k, v in state_dict.items()}
    fs = {k[len("first_stage_model."):]: v for k, v in sd.items()
          if k.startswith("first_stage_model.")}
    fs["quantize.codebook.cluster_size_ema"] = np.zeros(
        fs["quantize.codebook.weight"].shape[0] - 1, np.float32)
    fs["quantize.codebook.embed_ema"] = fs["quantize.codebook.weight"][:-1]
    variables = {"transformer": convert_stackgpt_state_dict(sd, prefix="transformer."),
                 "first_stage": convert_dqvae_state_dict(fs)}
    return model, variables


@pytest.fixture(scope="module")
def streams(state_dict):
    """Two batches of cached code streams, encoded by the port."""
    z = _trainer(state_dict).encode_dataset(_images(1, 2 * BATCH), batch=3)
    assert 0 < int((z["coarse_position"] < 16).sum()) < 2 * BATCH * 16  # both grains
    return [{k: v[i:i + BATCH] for k, v in z.items()} for i in (0, BATCH)]


@pytest.fixture(scope="module")
def jax_run(jax_side, streams):
    """Three steps of the JAX trainer on the cached streams: per step the
    logs, the (pad-frozen) gradients in the port's names, and the state."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.train.stage2 import Stage2Trainer as JaxTrainer

    model, variables = jax_side
    trainer = JaxTrainer(model, LR, warmup_steps=0, max_steps=MAX_STEPS, fused_adamw=True)
    state = trainer.init_state(variables)
    step = jax.jit(trainer.train_step)

    @jax.jit
    def grad_fn(params, z):
        def loss_fn(p):
            v = {**variables, "transformer": {**variables["transformer"], "params": p}}
            return model.loss(model.forward_tokens(v, z, z, train=True,
                                                   rngs={"dropout": jax.random.PRNGKey(0)}))
        return trainer._freeze_pad_rows(jax.grad(loss_fn)(params))

    steps = []
    for i in range(3):
        z = {k: jnp.asarray(v, jnp.int32) for k, v in streams[i % 2].items()}
        grads = stackgpt_state_dict_from_flax(jax.device_get(grad_fn(state.params, z)))
        state, logs = step(state, variables, z, z, jax.random.PRNGKey(i))
        steps.append(dict(
            logs={k: float(v) for k, v in logs.items()}, grads=grads, opt=state.opt,
            params=stackgpt_state_dict_from_flax(jax.device_get(state.params))))
    val = jax.jit(trainer.eval_step)(state, variables, z, z)
    return dict(steps=steps, val={k: float(v) for k, v in val.items()}, trainer=trainer)


# ------------------------------------------------------------ StackGPT forward
def _prefixed(model, z):
    z = {k: torch.as_tensor(v).long() for k, v in z.items()}
    c = model.encode_to_c(z["coarse_content"].shape[0], "cpu")
    cat = lambda ci, key: torch.cat([c[ci], z[key]], dim=1)  # noqa: E731
    return dict(coarse_content=cat(0, "coarse_content"), fine_content=cat(1, "fine_content"),
                coarse_position=cat(2, "coarse_position"), fine_position=cat(3, "fine_position"),
                coarse_seg=cat(4, "coarse_segment"), fine_seg=cat(5, "fine_segment"))


def test_training_forward_logits_and_losses_match_jax(state_dict, jax_side, streams):
    import jax.numpy as jnp

    model = _port_model(state_dict)
    jmodel, jvars = jax_side
    inputs = _prefixed(model, streams[0])
    with torch.no_grad():
        out = model.transformer(**inputs)
        losses = model.forward_tokens({k: torch.as_tensor(v) for k, v in streams[0].items()})
        total = model.loss(losses)
    jin = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in inputs.items()}
    ref = jmodel.transformer.apply(jvars["transformer"], **jin)
    for key in ("position_logits", "content_logits"):
        assert out[key].shape == tuple(ref[key].shape)
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-5, rtol=0,
                                   err_msg=key)
    z = {k: jnp.asarray(v, jnp.int32) for k, v in streams[0].items()}
    ref_losses = jmodel.forward_tokens(jvars, z, z)
    for key in LOSS_NAMES[1:]:
        np.testing.assert_allclose(float(losses[key]), float(ref_losses[key]), atol=1e-5, rtol=0,
                                   err_msg=key)
    np.testing.assert_allclose(float(total), float(jmodel.loss(ref_losses)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("activate_pad_ignore", [True, False])
def test_losses_from_logits_both_pad_ignore_branches(activate_pad_ignore):
    """With pad-ignore the position logits split at coarse_length - 1 and all
    three CEs ignore their pad code; without it they split at coarse_length
    and only the content CE drops its ignore index."""
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    cfg = load_config([TINY])["model"]["params"]["transformer_config"]
    cfg["params"]["activate_pad_ignore"] = activate_pad_ignore
    tgpt, jgpt = instantiate_from_config(cfg), jinst(cfg)
    p = cfg["params"]
    r = np.random.default_rng(2)
    b, lc, t = 3, 6, 15
    split = lc - 1 if activate_pad_ignore else lc
    pos_logits = r.normal(size=(b, t, p["fine_position_size"])).astype(np.float32)
    content_logits = r.normal(size=(b, t, p["vocab_size"])).astype(np.float32)
    content_t = r.integers(0, p["vocab_size"], (b, t))
    coarse_t = r.integers(0, p["coarse_position_size"], (b, split))
    fine_t = r.integers(0, p["fine_position_size"], (b, t - split))
    content_t[:, -4:] = p["content_pad_code"]
    coarse_t[:, -2:] = p["coarse_position_pad_code"]
    fine_t[0] = p["fine_position_pad_code"]
    out = tgpt.losses_from_logits(torch.from_numpy(pos_logits), torch.from_numpy(content_logits),
                                  *(torch.from_numpy(a) for a in (content_t, coarse_t, fine_t)), lc)
    ref = jgpt.losses_from_logits(jnp.asarray(pos_logits), jnp.asarray(content_logits),
                                  *(jnp.asarray(a, jnp.int32) for a in (content_t, coarse_t, fine_t)),
                                  lc)
    for key in LOSS_NAMES[1:]:
        np.testing.assert_allclose(float(out[key]), float(ref[key]), atol=1e-5, rtol=0,
                                   err_msg=key)
    # the content CE counts its pad targets only in the second branch
    no_pad = tgpt.losses_from_logits(
        torch.from_numpy(pos_logits), torch.from_numpy(content_logits),
        torch.from_numpy(np.where(content_t == p["content_pad_code"], 0, content_t)),
        torch.from_numpy(coarse_t), torch.from_numpy(fine_t), lc)
    assert (float(no_pad["content_loss"]) != float(out["content_loss"]))


def test_cross_entropy_ignore_all_pad_is_zero_and_reduces_in_f32():
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.nn.stackgpt import cross_entropy_ignore as jax_ce

    r = np.random.default_rng(3)
    logits = r.normal(size=(2, 5, 11)).astype(np.float32)
    targets = r.integers(0, 10, (2, 5))
    all_pad = np.full((2, 5), 10)
    assert float(cross_entropy_ignore(torch.from_numpy(logits), torch.from_numpy(all_pad), 10)) == 0.0
    assert float(jax_ce(jnp.asarray(logits), jnp.asarray(all_pad), 10)) == 0.0
    targets[0, :2] = 10
    out = cross_entropy_ignore(torch.from_numpy(logits).bfloat16(), torch.from_numpy(targets), 10)
    ref = jax_ce(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(targets), 10)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(float(out), float(ref), atol=1e-6, rtol=0)


# --------------------------------------------------------- the slice as a whole
def test_trainer_two_steps_match_jax(state_dict, jax_run, streams):
    trainer = _trainer(state_dict)
    start = {k: v.clone() for k, v in trainer.masters.items()}
    big = None  # elements whose JAX gradient exceeded the floor in both steps
    for i in range(2):
        ref = jax_run["steps"][i]
        logs, grads = trainer.compute_grads(streams[i])
        trainer.apply_update(grads)
        for key in LOSS_NAMES:
            np.testing.assert_allclose(float(logs[f"train_{key}"]), ref["logs"][f"train_{key}"],
                                       atol=1e-5, rtol=0, err_msg=f"{key} step {i}")
        assert sorted(grads) == sorted(ref["grads"])
        for name, g in grads.items():
            # f32 sums of a few hundred terms in another order; |g| up to ~1
            np.testing.assert_allclose(g.numpy(), ref["grads"][name].numpy(), atol=2e-6,
                                       rtol=1e-4, err_msg=f"grad {name} step {i}")
        above = {k: g.abs() > GRAD_FLOOR for k, g in ref["grads"].items()}
        big = above if big is None else {k: big[k] & above[k] for k in big}
    assert trainer.count == 2
    ref_params = jax_run["steps"][1]["params"]
    n_big = 0
    for name, p in trainer.masters.items():
        want = ref_params[name]
        # every element: within Adam's reach of two updates of at most lr (1 + wd |p|) each
        torch.testing.assert_close(p, want, atol=2 * 2.1 * LR, rtol=0, msg=name)
        # where rounding cannot flip an update: tight
        torch.testing.assert_close(p[big[name]], want[big[name]], atol=1e-6, rtol=0,
                                   msg=f"{name} above the gradient floor")
        n_big += int(big[name].sum())
    assert n_big > 0.5 * sum(p.numel() for p in trainer.masters.values())
    for name, row in trainer.pad_rows.items():
        assert torch.equal(trainer.masters[name][row], start[name][row]), name
        assert not torch.equal(trainer.masters[name], start[name]), name


def test_optimizer_state_carries_over_from_optax(state_dict, jax_run, streams):
    """A JAX training state after two steps, converted, continues in the port:
    the third step gives the JAX package's third step."""
    after_two, third = jax_run["steps"][1], jax_run["steps"][2]
    count, m, v = adamw_state_from_optax(after_two["opt"])
    assert count == 2 and sorted(m) == sorted(after_two["params"]) == sorted(v)
    sd = dict(state_dict)
    sd.update({f"transformer.{k}": t for k, t in after_two["params"].items()})
    trainer = _trainer(sd)
    trainer.load_optimizer_state(count, m, v)
    for name in m:  # a converted state is held by value, in the port's layout
        assert trainer.m[name].shape == trainer.masters[name].shape
        assert torch.equal(trainer.m[name], m[name]) and trainer.m[name] is not m[name]
    logs = trainer.train_step(streams[0])
    np.testing.assert_allclose(float(logs["train_loss"]), third["logs"]["train_loss"], atol=1e-5,
                               rtol=0)
    assert trainer.count == 3
    for name, p in trainer.masters.items():
        above = third["grads"][name].abs() > GRAD_FLOOR
        torch.testing.assert_close(p[above], third["params"][name][above], atol=1e-6, rtol=0,
                                   msg=name)
    with pytest.raises(KeyError):
        trainer.load_optimizer_state(0, {}, {})


def test_decayed_names_equal_the_jax_mask(state_dict, jax_side):
    import jax

    from dynamicvectorquantization_tpu.train.stage2 import _decay_mask

    params = jax_side[1]["transformer"]["params"]
    mask = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                        _decay_mask(params), params)
    ref = {k for k, t in stackgpt_state_dict_from_flax(mask).items() if bool(t.all())}
    trainer = _trainer(state_dict)
    assert trainer.decayed == ref == decayed_parameter_names(trainer.model.transformer)
    assert "position_head.1.weight" in ref and "content_head.1.weight" in ref
    assert not any("emb" in k or ".ln" in k or k.endswith(".bias") or k.endswith(".0.weight")
                   and "head" in k for k in ref)
    assert len(ref) == 4 * 6 + 2  # six Linear layers in each of four blocks, two heads


def test_eval_step_matches_jax(state_dict, jax_run, streams):
    sd = dict(state_dict)
    sd.update({f"transformer.{k}": t for k, t in jax_run["steps"][2]["params"].items()})
    val = _trainer(sd).eval_step(streams[0])
    for key, want in jax_run["val"].items():
        np.testing.assert_allclose(float(val[key]), want, atol=1e-5, rtol=0, err_msg=key)


def test_bf16_eval_step_runs_on_the_f32_masters(state_dict, jax_run, streams):
    """The JAX trainer evaluates with its f32 `state.params` whatever its
    compute dtype; under `compute_dtype: bfloat16` the port's `eval_step`
    does too (the masters put in place of the bf16 working copy for the
    call): it equals the f32 trainer's on the same weights (the same f32
    arithmetic: atol 1e-6) and the JAX `eval_step` (atol 1e-5, as above), and
    the working copy is bf16 again after it."""
    sd = dict(state_dict)
    sd.update({f"transformer.{k}": t for k, t in jax_run["steps"][2]["params"].items()})
    t16, t32 = _trainer(sd, compute_dtype="bfloat16"), _trainer(sd)
    v16, v32 = t16.eval_step(streams[0]), t32.eval_step(streams[0])
    for key in v32:
        np.testing.assert_allclose(float(v16[key]), float(v32[key]), atol=1e-6, rtol=0,
                                   err_msg=key)
    for key, want in jax_run["val"].items():
        np.testing.assert_allclose(float(v16[key]), want, atol=1e-5, rtol=0, err_msg=key)
    assert all(p.dtype == torch.bfloat16 for p in t16.params.values())
    with t16.master_weights():  # the image grids' context: the masters themselves, no copy
        assert all(p.data_ptr() == t16.masters[k].data_ptr() for k, p in t16.params.items())
    assert all(torch.equal(p.data, t16.masters[k].to(torch.bfloat16))
               for k, p in t16.params.items())


def test_accum_two_equals_the_mean_gradient(state_dict, streams):
    single = _trainer(state_dict)
    parts = [single.compute_grads(z) for z in streams]
    stacked = {k: np.stack([z[k] for z in streams]) for k in streams[0]}
    logs, grads = _trainer(state_dict, accum=2).compute_grads(stacked)
    for name, g in grads.items():
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, (parts[0][1][name] + parts[1][1][name]) / 2, atol=1e-7,
                                   rtol=1e-6, msg=name)
    torch.testing.assert_close(logs["train_loss"],
                               (parts[0][0]["train_loss"] + parts[1][0]["train_loss"]) / 2)
    with pytest.raises(ValueError):
        _trainer(state_dict, accum=3).compute_grads(stacked)


def test_train_steps_equals_sequential_steps(state_dict, streams):
    seq, loop = _trainer(state_dict), _trainer(state_dict)
    want = [seq.train_step(z)["train_loss"] for z in streams]
    logs = loop.train_steps({k: np.stack([z[k] for z in streams]) for k in streams[0]})
    assert logs["train_loss"].shape == (2,)
    torch.testing.assert_close(logs["train_loss"], torch.stack(want), atol=0, rtol=0)
    for name in seq.masters:
        assert torch.equal(seq.masters[name], loop.masters[name])


def test_encode_dataset_streams_equal_jax(state_dict, jax_side, jax_run):
    images = _images(4, 5)
    ref = jax_run["trainer"].encode_dataset(jax_side[1], images, batch=2)  # ragged tail
    out = _trainer(state_dict).encode_dataset(images, batch=2)
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert out[key].shape == ref[key].shape and np.issubdtype(out[key].dtype, np.integer)
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    # images in, as the inline (not cached) step takes them
    trainer = _trainer(state_dict)
    logs_img = trainer.compute_grads(images[:2])[0]
    logs_z = trainer.compute_grads({k: v[:2] for k, v in out.items()})[0]
    torch.testing.assert_close(logs_img["train_loss"], logs_z["train_loss"], atol=0, rtol=0)


def test_bf16_step_over_f32_masters(state_dict, streams):
    t32, t16 = _trainer(state_dict), _trainer(state_dict, compute_dtype="bfloat16")
    start = {k: v.clone() for k, v in t16.masters.items()}
    logs32, logs16 = t32.train_step(streams[0]), t16.train_step(streams[0])
    # bf16 activations through four blocks: within 5 % of the f32 loss, as the
    # JAX package's own mixed-precision test holds its trainer
    assert np.isfinite(float(logs16["train_loss"]))
    assert abs(float(logs16["train_loss"]) - float(logs32["train_loss"])) < \
        0.05 * max(1.0, abs(float(logs32["train_loss"])))
    for name, p in t16.params.items():
        assert p.dtype == torch.bfloat16 and t16.masters[name].dtype == torch.float32
        assert t16.m[name].dtype == torch.float32
        assert torch.equal(p.data, t16.masters[name].to(torch.bfloat16)), name  # the working copy
    assert any(not torch.equal(t16.masters[k], start[k]) for k in start)
    assert float(t16.train_step(streams[1])["train_loss"]) < float(logs16["train_loss"]) + 0.5
    assert all(p.dtype == torch.float32 for p in t16.model.first_stage_model.parameters())
    assert not any(p.requires_grad for p in t16.model.first_stage_model.parameters())


ALL_DROPOUTS = {"attn_pdrop": 0.1, "embd_pdrop": 0.1, "resid_pdrop": 0.1}


def test_attention_dropout_raises_and_other_dropouts_take_a_generator(state_dict, streams):
    """Attention dropout no longer raises: a step at `attn_pdrop` 0.1 runs
    and differs from the dropout-free step; eval draws no mask. The
    elementwise dropouts take the caller's generator when one is given and
    the trainer's own, re-seeded per step, otherwise."""
    with_attn = _trainer(state_dict, transformer_overrides={"attn_pdrop": 0.1})
    loss = float(with_attn.train_step(streams[0])["train_loss"])
    plain = float(_trainer(state_dict).compute_grads(streams[0])[0]["train_loss"])
    assert with_attn.count == 1 and np.isfinite(loss) and loss != plain
    assert abs(loss - plain) < 0.5
    quiet = _trainer(state_dict)
    for t in (with_attn, quiet):  # no dropout in eval
        t.load_state_dict(_trainer(state_dict).state_dict())
    assert float(with_attn.eval_step(streams[0])["val_loss"]) == \
        float(quiet.eval_step(streams[0])["val_loss"])

    trainer = _trainer(state_dict, transformer_overrides={"embd_pdrop": 0.1, "resid_pdrop": 0.1})
    losses = [float(trainer.compute_grads(streams[0], torch.Generator().manual_seed(s))[0]
                    ["train_loss"]) for s in (0, 0, 1)]
    assert losses[0] == losses[1] != losses[2] and losses[0] != plain
    assert abs(losses[0] - plain) < 0.5
    own = [float(trainer.compute_grads(streams[0])[0]["train_loss"]) for _ in range(2)]
    assert own[0] == own[1] != plain  # the trainer's generator restarts from (seed, step)


def test_two_trainers_with_one_base_seed_agree_bit_for_bit(state_dict, streams):
    a, b, c = (_trainer(state_dict, transformer_overrides=ALL_DROPOUTS, seed=s) for s in (3, 3, 4))
    la, lb, lc = ([float(t.train_step(streams[i % 2])["train_loss"]) for i in range(3)]
                  for t in (a, b, c))
    assert la == lb and la != lc
    assert len(set(la)) == 3
    for name in a.masters:
        assert torch.equal(a.masters[name], b.masters[name]), name
        assert torch.equal(a.m[name], b.m[name]) and torch.equal(a.v[name], b.v[name])


def test_state_dict_round_trip_resumes_the_dropout_streams(state_dict, streams):
    whole = _trainer(state_dict, transformer_overrides=ALL_DROPOUTS, seed=3)
    want = [float(whole.train_step(streams[i % 2])["train_loss"]) for i in range(3)]
    first = _trainer(state_dict, transformer_overrides=ALL_DROPOUTS, seed=3)
    first.train_step(streams[0])
    first.epoch = 1
    saved = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
             for k, v in first.state_dict().items()}
    assert saved["count"] == 1 and saved["epoch"] == 1 and saved["seed"] == 3
    resumed = _trainer(state_dict, transformer_overrides=ALL_DROPOUTS, seed=99,
                       compute_dtype=None)
    resumed.load_state_dict(saved)
    assert (resumed.count, resumed.epoch, resumed.base_seed) == (1, 1, 3)
    got = [float(resumed.train_step(streams[i % 2])["train_loss"]) for i in (1, 2)]
    assert got == want[1:]
    for name in whole.masters:
        assert torch.equal(whole.masters[name], resumed.masters[name]), name
    with pytest.raises(KeyError):
        resumed.load_state_dict({**saved, "masters": {"nope": torch.zeros(1)}})


def test_state_dict_restores_the_bf16_working_copy(state_dict, streams):
    t16 = _trainer(state_dict, compute_dtype="bfloat16")
    t16.train_step(streams[0])
    saved = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
             for k, v in t16.state_dict().items()}
    fresh = _trainer(state_dict, compute_dtype="bfloat16")
    fresh.load_state_dict(saved)
    for name, p in fresh.params.items():
        assert p.dtype == torch.bfloat16 and torch.equal(p.data, t16.params[name].data), name
    assert float(fresh.train_step(streams[1])["train_loss"]) == \
        float(t16.train_step(streams[1])["train_loss"])


def _attention_seeds(trainer, x):
    """The (rate, seed) every CausalSelfAttention hands the kernel wrapper in
    one `compute_grads`, in call order."""
    import dynamicvectorquantization_torch.nn.transformer as tfm

    seen, real = [], tfm.fused_causal_attention

    def spy(q, k, v, n_head, scale=None, causal=True, rate=0.0, seed=None):
        seen.append((rate, seed))
        return real(q, k, v, n_head, scale, causal, rate, seed)

    tfm.fused_causal_attention = spy
    try:
        trainer.compute_grads(x)
    finally:
        tfm.fused_causal_attention = real
    return seen


def test_layers_and_microbatches_draw_different_masks(state_dict, streams):
    from dynamicvectorquantization_torch.ops.attention import (
        attention_seed, dropout_keep_mask, mix_seed)

    trainer = _trainer(state_dict, transformer_overrides={"attn_pdrop": 0.1}, accum=2, seed=5)
    stacked = {k: np.stack([z[k] for z in streams]) for k in streams[0]}
    seen = _attention_seeds(trainer, stacked)
    layers = 4  # two position + two content layers
    assert len(seen) == 2 * layers and all(rate == 0.1 for rate, _ in seen)
    seeds = [s for _, s in seen]
    assert len(set(seeds)) == 2 * layers  # no two layers, no two microbatches share a seed
    # position stack 0..1, content stack 2..3, per microbatch
    want = [mix_seed(attention_seed(5, 0, micro), layer)
            for micro in range(2) for layer in range(layers)]
    assert seeds == want
    masks = [dropout_keep_mask(s, 1, 2, 32, 0.1) for s in seeds]
    assert all(not torch.equal(masks[0], m) for m in masks[1:])
    # the next optimizer step draws new seeds, the same step the same ones
    assert _attention_seeds(trainer, stacked) == seen
    trainer.count = 1
    assert not set(s for _, s in _attention_seeds(trainer, stacked)) & set(seeds)


def test_attention_dropout_in_training_needs_the_forward_seed(state_dict, streams):
    model = _port_model(state_dict, attn_pdrop=0.1)
    z = {k: torch.as_tensor(v) for k, v in streams[0].items()}
    with pytest.raises(ValueError, match="seed"):
        model.forward_tokens(z, train=True)
    with torch.no_grad():
        out = model.forward_tokens(z, train=True, seed=1)
        same = model.forward_tokens(z, train=True, seed=1)
        other = model.forward_tokens(z, train=True, seed=2)
        quiet = model.forward_tokens(z, train=False)
    assert float(out["content_loss"]) == float(same["content_loss"])
    assert len({float(o["content_loss"]) for o in (out, other, quiet)}) == 3


def test_trainer_defaults_to_cuda(state_dict):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        Stage2Trainer(_port_model(state_dict), LR)
    with pytest.raises(ValueError):
        Stage2Trainer(_port_model(state_dict), LR, compute_dtype="float16", device="cpu")
    assert load_model_and_variables(TINY, device="cpu")[0].weight_decay == 0.01


@pytest.mark.cuda
def test_cuda_train_step_goes_through_every_kernel():
    """Two bf16 steps at a small width on the card: each training kernel is
    launched the number of times the depth implies, and the loss agrees with
    the same step on the CPU (plain versions)."""
    from dynamicvectorquantization_torch.ops.attention import (
        fused_attention_backward,
        fused_attention_forward,
    )
    from dynamicvectorquantization_torch.ops.fused_adamw import fused_adamw_step
    from dynamicvectorquantization_torch.ops.layernorm import layernorm_backward, layernorm_forward

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = (fused_attention_forward, fused_attention_backward, layernorm_forward,
                layernorm_backward, fused_adamw_step)
    sd = {k: v.clone() for k, v in _port_model().state_dict().items()}
    cpu = _trainer(sd, compute_dtype="bfloat16")
    z = cpu.encode_dataset(_images(5, BATCH), batch=BATCH)
    gpu = Stage2Trainer(_port_model(sd), LR, warmup_steps=0, max_steps=MAX_STEPS,
                        compute_dtype="bfloat16", device="cuda")
    before = [w.launches for w in wrappers]
    got = [float(gpu.train_step(z)["train_loss"]) for _ in range(2)]
    torch.cuda.synchronize()
    want = [float(cpu.train_step(z)["train_loss"]) for _ in range(2)]
    layers = 4
    assert [w.launches - b for w, b in zip(wrappers, before)] == [
        2 * layers, 2 * layers, 2 * (2 * layers + 2), 2 * (2 * layers + 2), 2 * len(gpu.params)]
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=0)  # bf16 activations, two devices


@pytest.mark.cuda
def test_cuda_f32_train_step_runs_the_3xtf32_attention():
    """Two f32 steps (`compute_dtype` None, the JAX trainer's default, whose
    CPU counterpart `test_trainer_two_steps_match_jax` holds to the JAX
    trainer) at two heads of 64 on the card: every attention forward and
    backward on the 3xTF32 kernels, none on the FMA units, and the losses
    within f32 summation order of the same steps on the CPU (plain versions)."""
    from dynamicvectorquantization_torch.ops.attention import (
        fused_attention_backward,
        fused_attention_forward,
    )

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    overrides = dict(n_embd=128)  # 2 heads of 64
    sd = {k: v.clone() for k, v in _port_model(**overrides).state_dict().items()}
    cpu = _trainer(sd, transformer_overrides=overrides)
    z = cpu.encode_dataset(_images(5, BATCH), batch=BATCH)
    gpu = Stage2Trainer(_port_model(sd, **overrides), LR, warmup_steps=0, max_steps=MAX_STEPS,
                        device="cuda")
    counters = [(fused_attention_forward, "f32_tc_launches"),
                (fused_attention_backward, "f32_tc_launches"),
                (fused_attention_forward, "fma_launches"),
                (fused_attention_backward, "fma_launches")]
    before = [getattr(w, name) for w, name in counters]
    got = [float(gpu.train_step(z)["train_loss"]) for _ in range(2)]
    torch.cuda.synchronize()
    want = [float(cpu.train_step(z)["train_loss"]) for _ in range(2)]
    layers = 4
    assert [getattr(w, name) - b for (w, name), b in zip(counters, before)] == [
        2 * layers, 2 * layers, 0, 0]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)  # f32, two devices
