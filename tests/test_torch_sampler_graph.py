"""The sampler as the JAX package runs it: masked AR steps over static state,
the loop condition read every `STEPS_PER_READ` steps, the loop index on the
device (`models/dqtransformer.py`), and on a CUDA card the steps replayed
from CUDA graphs (`models/graphs.py`).

On the CPU the very step function that the card replays runs eagerly and is
held against the JAX sampler at the tiny stage-2 config: greedy tokens exact
for float and int8 caches, both fine-position modes and the class model, at
one step per read and at a read interval that overshoots both phases; a loop
that stops at capacity with rows not done commits nothing further; the
decode attention with a device int32 index equals the host-int call, and
fully masked chunks leave it bit for bit as it was; the graph key follows
the parameters' storage. The `cuda` cases hold the graphs against the eager
loop on the card (greedy and seeded sampled tokens, AR steps), recapture
under `Stage2Trainer.master_weights`, and count kernel launches through
replays.

Weights are made once per module in the port (seeded init, transformer
perturbed from a numpy seed so greedy choices are far from ties) and carried
to the JAX package by its own converters; JAX is imported inside the JAX-side
fixtures only, and the JAX sampler runs once per case for the module.
"""
import copy
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.models import dqtransformer as dq
from dynamicvectorquantization_torch.models import graphs
from dynamicvectorquantization_torch.nn.transformer import (
    CausalSelfAttention,
    KVCache,
    chunked_decode_attention,
)
from dynamicvectorquantization_torch.ops.kv_int8 import decode_attention_int8
from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config


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
B = 3
LABELS = [3, 7, 0]
# more steps per read than either phase of the tiny config has (17 coarse, 65 fine):
# every phase ends inside its first block, most of whose steps are past the end
OVERSHOOT = 72
CAPACITY = {"coarse_max_len": 3, "fine_max_len": 5}  # phases that stop at capacity
NAMES = ("coarse_content", "fine_content", "coarse_position", "fine_position")


def _config(kind):
    """The tiny stage-2 model config (the port's loader): `uncond`, `class`
    (tests/test_torch_class_cond.py's ten-class variant) or `capacity`
    (short streams, so both phases stop at capacity)."""
    cfg = load_config([TINY])
    if kind == "class":
        from tests.test_torch_class_cond import class_config

        cfg = class_config(cfg)
    elif kind == "capacity":
        cfg["model"]["params"]["permuter_config"]["params"].update(CAPACITY)
    return cfg["model"]


def _port(kind, state_dict=None, kv_cache_dtype=None, device="cpu"):
    cfg = copy.deepcopy(_config(kind))
    if kv_cache_dtype:
        cfg["params"]["transformer_config"]["params"]["kv_cache_dtype"] = kv_cache_dtype
    model = instantiate_from_config(cfg)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(0))
        r = np.random.default_rng(0)
        with torch.no_grad():
            for p in model.transformer.parameters():
                p.add_(torch.from_numpy(r.normal(0.0, 0.1, tuple(p.shape)).astype(np.float32)))
    else:
        model.load_state_dict(state_dict)
    return model.eval().to(device)


def _condition(model, kind, device="cpu"):
    c = torch.tensor(LABELS) if kind == "class" else B
    return model.encode_to_c(c, device)


@pytest.fixture(scope="module")
def state_dicts():
    return {kind: {k: v.clone() for k, v in _port(kind).state_dict().items()}
            for kind in ("uncond", "class")}


def _jax_greedy(state_dict, kind, kv_cache_dtype, fix):
    """The JAX sampler's greedy tokens at the same weights (numpy)."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload_config
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import (
        convert_dqvae_state_dict,
        convert_stackgpt_state_dict,
    )

    cfg = jload_config([TINY])
    if kind == "class":
        from tests.test_torch_class_cond import class_config

        cfg = class_config(cfg)
    elif kind == "capacity":
        cfg["model"]["params"]["permuter_config"]["params"].update(CAPACITY)
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
    c = jnp.asarray(LABELS) if kind == "class" else jnp.zeros((B, 1))
    out = model.sample_from_scratch(variables, *model.encode_to_c(c), rng=jax.random.PRNGKey(0),
                                    sample=False, fix_fine_position=fix)
    return [np.asarray(t) for t in out]


@pytest.fixture(scope="module")
def jax_tokens(state_dicts):
    """One JAX run per (model, cache dtype, fine-position mode), shared."""
    return {(kind, kv, fix): _jax_greedy(state_dicts[kind], kind, kv, fix)
            for kind in ("uncond", "class") for kv in (None, "int8") for fix in (False, True)}


@pytest.mark.parametrize("steps_per_read", [1, OVERSHOOT])
@pytest.mark.parametrize("fix", [False, True], ids=["free", "fixed"])
@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("kind", ["uncond", "class"])
def test_masked_step_greedy_token_exact(state_dicts, jax_tokens, monkeypatch, kind,
                                        kv_cache_dtype, fix, steps_per_read):
    monkeypatch.setattr(dq, "STEPS_PER_READ", steps_per_read)
    model = _port(kind, state_dicts[kind], kv_cache_dtype)
    out = model.sample_from_scratch(*_condition(model, kind), sample=False,
                                    fix_fine_position=fix)
    ref = jax_tokens[(kind, kv_cache_dtype, fix)]
    for name, a, b in zip(NAMES, out, ref):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    # AR steps: the coarse steps, the entry step, the fine steps up to the last row's eos
    coarse_steps = int((ref[2] != model.coarse_position_pad_code).sum(axis=1).max())
    fine_steps = int((ref[3] != model.fine_position_pad_code).sum(axis=1).max())
    assert model.last_ar_steps == coarse_steps + 1 + fine_steps
    assert (ref[2] < 16).sum() > B and (ref[3] < 64).sum() > B  # not degenerate


def test_capacity_stop_commits_nothing_further(state_dicts, monkeypatch):
    """Both phases stop by i == n_max with rows not done; the steps past the
    end (the read interval overshoots both) leave the buffers and the ban
    mask as the JAX sampler's state."""
    monkeypatch.setattr(dq, "STEPS_PER_READ", OVERSHOOT)
    states = []

    class Recorded(dq._SamplerState):
        def __init__(self, *args):
            super().__init__(*args)
            states.append(self)

    monkeypatch.setattr(dq, "_SamplerState", Recorded)
    model = _port("capacity", state_dicts["uncond"])
    out = model.sample_from_scratch(*_condition(model, "uncond"), sample=False)
    ref = _jax_greedy(state_dicts["uncond"], "capacity", None, False)
    for name, a, b in zip(NAMES, out, ref):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    st, = states
    nc, nf = CAPACITY["coarse_max_len"], CAPACITY["fine_max_len"]
    assert (int(st.i), int(st.j), int(st.coarse_len)) == (nc, nf, nc + 1)
    # rows not done at either capacity (no eos among the sampled positions)
    assert not (ref[2] == model.coarse_position_eos_code).any(axis=1).all()
    assert not (ref[3] == model.fine_position_eos_code).any(axis=1).all()
    assert model.last_ar_steps == nc + 1 + nf
    # the fine ban mask JAX ends with: the fine positions the coarse regions cover, the
    # fine sos, and every sampled fine position
    regions = np.zeros((B, model.hw1 * model.hw1), bool)
    for r, row in enumerate(ref[2]):
        regions[r, row[row < model.hw1 * model.hw1]] = True
    ban = np.zeros((B, model.fine_position_size), bool)
    ban[:, : model.fine_hw ** 2] = model._coarse_covered_to_fine_positions(
        torch.from_numpy(regions)).numpy()
    ban[:, model.fine_position_sos_code] = True
    for r, row in enumerate(ref[3]):
        ban[r, row] = True
    np.testing.assert_array_equal(st.pos_ban.numpy(), ban)
    assert not st.done.all()


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"], ids=["float", "int8"])
def test_attention_device_index_equals_host_index(kv_cache_dtype):
    torch.manual_seed(0)
    attn = CausalSelfAttention(32, 2).eval()
    b, t_max = 2, 512
    make = KVCache.create_int8 if kv_cache_dtype else KVCache.create
    caches = [make(1, b, 2, t_max, 16).layers[0] for _ in range(2)]
    indices = list(range(6)) + list(range(250, 262))  # across the first chunk's end
    x = torch.randn(len(indices), b, 1, 32)
    with torch.no_grad():
        for step, idx in enumerate(indices):
            host = attn(x[step], caches[0], idx)
            device = attn(x[step], caches[1], torch.tensor(idx, dtype=torch.int32))
            assert torch.equal(host, device), idx
    for a, c in zip(*caches):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_extra_masked_chunks_are_bit_identical(dtype):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 2, 1, 16, generator=g).to(dtype)
    k = torch.randn(2, 2, 1024, 16, generator=g).to(dtype)
    v = torch.randn(2, 2, 1024, 16, generator=g).to(dtype)
    for idx in (0, 100, 255, 256, 700):
        exact = chunked_decode_attention(q, k, v, idx)
        for n_chunks in range(idx // 256 + 1, 5):
            for index in (idx, torch.tensor(idx, dtype=torch.int32)):
                got = chunked_decode_attention(q, k, v, index, n_chunks)
                assert torch.equal(got, exact), (idx, n_chunks)
    with pytest.raises(ValueError):
        chunked_decode_attention(q, k, v, 3, 5)


def test_graph_key_follows_parameter_storage(state_dicts):
    model = _port("uncond", state_dicts["uncond"])
    trainer = Stage2Trainer(model, 1e-3, compute_dtype="bfloat16", device="cpu")
    working = graphs.parameter_storage(model.transformer)
    assert {dtype for _, dtype in working} == {torch.bfloat16}
    with trainer.master_weights():
        masters = graphs.parameter_storage(model.transformer)
    assert {dtype for _, dtype in masters} == {torch.float32}
    assert not set(p for p, _ in working) & set(p for p, _ in masters)
    assert graphs.parameter_storage(model.transformer) == working


def test_cpu_sampling_captures_nothing(state_dicts):
    model = _port("uncond", state_dicts["uncond"], "int8")
    model.sample_from_scratch(*_condition(model, "uncond"), sample=False)
    assert not graphs.runners_of(model)


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sample(model, dev, seed, eager, sample=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    out = model.sample_from_scratch(*_condition(model, "uncond", dev), generator=g,
                                    sample=sample, top_k=30, top_k_pos=16, eager=eager)
    return [t.cpu() for t in out], model.last_ar_steps, g.get_offset()


@pytest.mark.cuda
@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"], ids=["float", "int8"])
def test_graph_equals_eager_on_cuda(cuda, kv_cache_dtype, sample):
    model = _port("uncond", None, kv_cache_dtype, cuda)
    eager = _sample(model, cuda, 5, True, sample)
    runner = graphs.runner_for(model, cuda)
    for _ in range(2):  # the first call captures, the second replays only
        got = _sample(model, cuda, 5, False, sample)
        for name, a, b in zip(NAMES, got[0], eager[0]):
            assert torch.equal(a, b), name
        assert got[1:] == eager[1:]  # AR steps; the caller's generator advanced alike
    assert runner.captures > 0 and runner.replays > 0


@pytest.mark.cuda
def test_recapture_under_master_weights_on_cuda(cuda):
    model = _port("uncond", None, "int8", cuda)
    trainer = Stage2Trainer(model, 1e-3, compute_dtype="bfloat16", device=cuda)
    runner = graphs.runner_for(model, cuda)
    bf16 = _sample(model, cuda, 7, False)
    captured = runner.captures
    with trainer.master_weights():
        f32 = _sample(model, cuda, 7, False)
        assert runner.captures > captured  # the masters' storage: new graphs
        f32_eager = _sample(model, cuda, 7, True)
    for a, b in zip(f32[0], f32_eager[0]):
        assert torch.equal(a, b)
    captured = runner.captures
    again = _sample(model, cuda, 7, False)  # the working copy's graphs again
    assert runner.captures == captured
    for a, b in zip(again[0], bf16[0]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_launches_counted_through_replays_on_cuda(cuda):
    model = _port("uncond", None, "int8", cuda)
    layers = model.transformer.position_layer + model.transformer.content_layer
    counts = []
    for eager in (True, False, False):
        decode_attention_int8.launches = 0
        _, ar_steps, _ = _sample(model, cuda, 9, eager)
        counts.append(decode_attention_int8.launches)
        assert counts[-1] >= layers * ar_steps and counts[-1] % layers == 0
    assert counts[0] == counts[1] == counts[2]
    assert graphs.runner_for(model, cuda).replays > 0
