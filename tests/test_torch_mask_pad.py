"""`StackGPT(mask_pad_attention=True)` in the PyTorch port: -1e9 on the
self-attention scores of the keys that are content pads, in both stacks,
through `ops.attention.masked_causal_attention` (torch ops: the JAX package
sends any attention bias to XLA, its Pallas kernel takes no mask).

* One stage-2 optimizer step on cached codes with pads (the tiny config,
  dropout 0) against the JAX trainer's: losses (atol 1e-5), gradients and
  the updated parameters (as `tests/test_torch_class_cond.py` holds them);
  the option changes the losses.
* The masked route at a zero bias equals the kernels' plain version at rate
  0.1 for the same seed (an int or a device int64, read without a host
  sync), forward bit for bit and gradients against the plain backward.
* The refusals of the JAX package under sequence and pipeline parallelism.
* `cuda`: the graph-captured stage-2 step with the option (dropouts 0.1)
  equals the eager step bit for bit over three steps.
"""
import copy
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.ops.attention import (fused_attention_backward_plain,
                                                           fused_attention_forward_plain,
                                                           masked_causal_attention)
from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.weights import stackgpt_state_dict_from_flax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")
LR, MAX_STEPS = 1e-3, 50
GRAD_FLOOR = 1e-5
LOSS_NAMES = ("loss", "content_loss", "position_loss", "coarse_position_loss",
              "fine_position_loss")


def masked_config(cfg, on=True, **params):
    model = copy.deepcopy(cfg["model"])
    model["params"]["transformer_config"]["params"].update(mask_pad_attention=on, **params)
    return model


def _streams(trainer, b=4):
    r = np.random.default_rng(1)
    x = r.uniform(-1, 1, size=(b, 64, 64, 3)).astype(np.float32)
    x[:, :, :32] = (0.2 + 0.01 * x[:, :, :32]).astype(np.float32)
    return trainer.encode_dataset(x, batch=b)


def test_stage2_step_with_mask_pad_attention_matches_jax():
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload
    from dynamicvectorquantization_tpu.train.stage2 import Stage2Trainer as JaxTrainer
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    jmodel = jinst(masked_config(jload([TINY])))
    jvars = jax.device_get(jmodel.init(jax.random.PRNGKey(1), {}))
    port = instantiate_from_config(masked_config(load_config([TINY])))
    port.init_weights(torch.Generator().manual_seed(0))
    port.transformer.load_state_dict(stackgpt_state_dict_from_flax(jvars["transformer"]))
    trainer = Stage2Trainer(port.eval(), LR, warmup_steps=0, max_steps=MAX_STEPS, device="cpu")
    z = _streams(trainer)
    pad = port.transformer.content_pad_code
    assert (z["fine_content"] == pad).any()  # keys to mask

    jtrainer = JaxTrainer(jmodel, LR, warmup_steps=0, max_steps=MAX_STEPS, fused_adamw=True)
    state = jtrainer.init_state(jvars)
    jz = {k: jnp.asarray(v, jnp.int32) for k, v in z.items()}

    @jax.jit
    def grad_fn(params):
        def loss_fn(p):
            v = {**jvars, "transformer": {**jvars["transformer"], "params": p}}
            return jmodel.loss(jmodel.forward_tokens(v, jz, jz, train=True,
                                                     rngs={"dropout": jax.random.PRNGKey(0)}))
        return jtrainer._freeze_pad_rows(jax.grad(loss_fn)(params))

    ref_grads = stackgpt_state_dict_from_flax(jax.device_get(grad_fn(state.params)))
    state, ref_logs = jax.jit(jtrainer.train_step)(state, jvars, jz, jz, jax.random.PRNGKey(0))
    ref_params = stackgpt_state_dict_from_flax(jax.device_get(state.params))

    logs, grads = trainer.compute_grads(z)
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

    # the option reaches the losses: the same weights without it differ
    plain = instantiate_from_config(masked_config(load_config([TINY]), on=False))
    plain.load_state_dict(port.state_dict())
    with torch.no_grad():
        zt = {k: torch.as_tensor(v) for k, v in z.items()}
        on, off = port.forward_tokens(zt), plain.forward_tokens(zt)
    assert float(on["content_loss"]) != float(off["content_loss"])


@pytest.mark.parametrize("seed", [2 ** 63 + 5, 123], ids=["high_bit", "small"])
def test_masked_route_at_zero_bias_is_the_kernels_plain_version(seed):
    g = torch.Generator().manual_seed(0)
    b, t, n_head, hd, rate = 2, 37, 2, 16, 0.1
    q, k, v, dy = (torch.randn((b, t, n_head * hd), generator=g) for _ in range(4))
    bias = torch.zeros((b, 1, 1, t))
    tensor_seed = torch.tensor(np.array([seed], np.uint64).view(np.int64))
    for s in (seed, tensor_seed[0]):
        qq, kk, vv = (z.clone().requires_grad_() for z in (q, k, v))
        y = masked_causal_attention(qq, kk, vv, n_head, bias, rate, s)
        want, lse = fused_attention_forward_plain(q, k, v, n_head, None, True, True, rate, seed)
        assert torch.equal(y.detach(), want)
        y.backward(dy)
        for got, ref in zip((qq.grad, kk.grad, vv.grad),
                            fused_attention_backward_plain(q, k, v, want, lse, dy, n_head,
                                                           rate=rate, seed=seed)):
            torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    # a bias of -1e9 on a key removes it: the same as dropping the key column
    bias[:, :, :, 5] = -1e9
    y = masked_causal_attention(q, k, v, n_head, bias)
    keep = torch.ones(t, dtype=torch.bool)
    keep[5] = False
    ref = fused_attention_forward_plain(q[:, keep], k[:, keep], v[:, keep], n_head,
                                        causal=True)
    torch.testing.assert_close(y[:, keep], ref, atol=1e-6, rtol=1e-6)


def test_sequence_and_pipeline_parallel_refuse_mask_pad_attention():
    from dynamicvectorquantization_torch.parallel.stackgpt_pp import stackgpt_forward_pp
    from dynamicvectorquantization_torch.parallel.stackgpt_sp import stackgpt_forward_sp

    gpt = instantiate_from_config(masked_config(load_config([TINY]))["params"]
                                  ["transformer_config"])
    streams = [torch.zeros((2, 3), dtype=torch.long)] * 4
    with pytest.raises(ValueError, match="mask_pad_attention is not supported under sp"):
        stackgpt_forward_sp(gpt, None, *streams)
    with pytest.raises(ValueError, match="mask_pad_attention is not supported under pp"):
        stackgpt_forward_pp(gpt, None, 2, *streams)


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_graph_captured_mask_pad_step_equals_eager_on_cuda(cuda, dtype):
    from dynamicvectorquantization_torch.models import graphs

    def trainer():
        cfg = masked_config(load_config([TINY]), attn_pdrop=0.1, resid_pdrop=0.1,
                            embd_pdrop=0.1, n_embd=128)
        model = instantiate_from_config(cfg)
        model.init_weights(torch.Generator().manual_seed(0))
        return Stage2Trainer(model.eval(), LR, warmup_steps=0, max_steps=MAX_STEPS,
                             compute_dtype=dtype, device=cuda, seed=3)

    graph, eager = trainer(), trainer()
    z = _streams(graph)
    calls = masked_causal_attention.calls
    got = [graph.train_step(z) for _ in range(3)]
    want = [eager.train_step(z, eager=True) for _ in range(3)]
    runner = graphs.runner_for(graph, cuda)
    assert runner.captures == 1 and runner.replays == 2
    assert masked_causal_attention.calls > calls
    for a, b in zip(got, want):
        for n in b:
            assert torch.equal(a[n], b[n]), n
    for name in eager.masters:
        assert torch.equal(graph.masters[name], eager.masters[name]), name
