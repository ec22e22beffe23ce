"""`steps_per_dispatch` and the stage-2 step over static state
(`train/loop.py`, `train/stage2.py`), the attention kernels' dropout seed and
AdamW's (lr, c1, c2) read from device tensors (`ops/attention.py`,
`ops/fused_adamw.py`).

On the CPU, at the tiny configs, f32: the port's loop against the JAX loop
at the same K steps a dispatch, stage 2 on cached codes at K = 2 and 4, with
the inline encode at 4, the class model at 2 (rows at the same optimizer
steps, losses within the loop tests' tolerances, the state after the fit);
every mode, stage 1 included, at K = 2 and 4 equal to the port at K = 1 bit
for bit (with every dropout on in stage 2), which tests/test_torch_loop*.py
hold to the JAX loop; the JAX auto rule (K = min(8, steps an epoch) on
cached codes, else 1), the dropped trailing group and the cadences in
optimizer steps; a resumed run at K = 4 equal to the uninterrupted one; the
static-state step (what the card captures) equal to the eager step; a
tensor seed equal to an int seed through the plain attention, and a tensor
(lr, c1, c2) equal to floats through the plain AdamW. A JAX loop fit costs
15-25 s here (stage 1's over 60 s), so the JAX side runs four of them.

The `cuda` cases hold each attention family's `_device_seed` entry and
AdamW's `_device_scalars` entry to their by-value entries bit for bit, the
graph step to the eager step over three steps (bf16, f32, class), a
recapture when the parameters' storage changes, and the launch counts
through replays.

JAX is imported inside the JAX-side helpers.
"""
import json
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import dump_yaml, load_config
from dynamicvectorquantization_torch.models import graphs
from dynamicvectorquantization_torch.ops.attention import (
    attention_seed,
    dropout_keep_mask,
    fused_attention_backward,
    fused_attention_forward,
    fused_causal_attention,
    mix_seed,
)
from dynamicvectorquantization_torch.ops.fused_adamw import (
    adamw_scalars,
    fused_adamw_step,
    fused_adamw_step_plain,
)
from dynamicvectorquantization_torch.train.loop import Trainer
from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
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
TINY1 = os.path.join(_REPO, "configs/smoke/dqvae-dual-entropy-tiny.yml")
SEED, STEPS = 23, 4
DROPOUTS = {k: 0.1 for k in ("attn_pdrop", "resid_pdrop", "embd_pdrop")}


def _rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _class_config():
    """The tiny class-conditional config of tests/test_torch_class_cond.py."""
    try:
        from tests.test_torch_class_cond import class_config
    except ImportError:  # pytest without the suite's conftest: tests/ itself is on the path
        from test_torch_class_cond import class_config
    return class_config(load_config([TINY]))


@pytest.fixture(scope="module")
def class_yml(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "dqtransformer-class-tiny.yml"
    path.write_text(dump_yaml(_class_config()))
    return str(path)


def _yml(mode, class_yml):
    return {"cached": TINY, "inline": TINY, "class": class_yml, "stage1": TINY1}[mode]


# ---------------------------------------------------------------- JAX loop
def _shared_draw(pool_rows, noise_shape):
    """The codebook restart's draw, shared by both loops (as
    tests/test_torch_loop_stage1.py)."""
    perm = np.random.default_rng(pool_rows).permutation(pool_rows)
    noise = (None if noise_shape is None else
             np.random.default_rng(7).uniform(size=noise_shape).astype(np.float32))
    return noise, perm


def _port_draw(pool_rows, noise_shape, generator, device):
    noise, perm = _shared_draw(pool_rows, noise_shape)
    return (None if noise is None else torch.from_numpy(noise)), torch.from_numpy(perm)


def _jax_loop(mode, k, class_yml, root):
    """(metric rows, final state, initial state in the port's names) of the
    JAX loop at K steps a dispatch, one epoch of STEPS steps."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload
    from dynamicvectorquantization_tpu.parallel.mesh import make_mesh
    from dynamicvectorquantization_tpu.train import loop as jloop
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst

    from dynamicvectorquantization_torch.utils.weights import (
        dualformer_state_dict_from_flax,
        stage1_state_from_flax,
    )

    cfg = jload([_yml(mode, class_yml)])
    model, data = jinst(cfg["model"]), jinst(cfg["data"])
    logdir = str(root / f"jax-{mode}-{k}")
    trainer = jloop.Trainer(logdir, max_epochs=1, seed=SEED, log_every=1, save_top_k=1,
                            mesh=make_mesh(1), max_steps_per_epoch=STEPS, resume=False,
                            steps_per_dispatch=k,
                            cached_codes="off" if mode == "inline" else "on")
    trainer.images.should_log = lambda *a, **kw: False  # no sampling: losses only
    mp = pytest.MonkeyPatch()
    if mode == "stage1":
        model.learning_rate = 8 * cfg["model"]["base_learning_rate"]
        model.min_learning_rate = 0.0
        x0 = next(iter(data.train_dataloader(seed=SEED).epoch(0)))["image"]
        probe = jloop.Stage1Trainer(model, learning_rate=model.learning_rate, warmup_steps=0,
                                    max_steps=STEPS)
        start = probe.init_state(jax.random.PRNGKey(SEED), jnp.asarray(x0[:1]))
        initial = stage1_state_from_flax(jax.device_get(start))
        mp.setattr(jloop.Stage1Trainer, "init_state", lambda self, *a, **kw: start)
        mp.setattr(jax.random, "permutation",
                   lambda key, n: jnp.asarray(_shared_draw(n, None)[1]))
        mp.setattr(jax.random, "uniform",
                   lambda key, shape, *a, **kw: jnp.asarray(_shared_draw(1, shape)[0]))
    else:
        model.learning_rate = cfg["model"]["learning_rate"]
        model.min_learning_rate = cfg["model"]["min_learning_rate"]
    try:
        with trainer.mesh:
            state = jax.device_get(trainer.fit(model, data))
    finally:
        mp.undo()
    if mode != "stage1":  # the state the JAX loop starts from (`_fit_stage2`)
        fs_vars = model.first_stage_model.init(jax.random.PRNGKey(SEED + 5))
        initial = dualformer_state_dict_from_flax(
            jax.device_get(model.init(jax.random.PRNGKey(SEED), fs_vars)))
    return _rows(logdir), state, initial


# --------------------------------------------------------------- port loop
def _port_model(yml, dropouts=False):
    cfg = load_config([yml])
    if dropouts:
        cfg["model"]["params"]["transformer_config"]["params"].update(DROPOUTS)
    return instantiate_from_config(cfg["model"]), instantiate_from_config(cfg["data"]), cfg


def _port_fit(mode, logdir, class_yml, initial=None, dropouts=False, **kw):
    """(the trainer's final step object, its metric rows) of the port's
    loop; from `initial` (the JAX loop's starting state) when given, else
    from the seeded weights the loop draws itself."""
    model, data, cfg = _port_model(_yml(mode, class_yml), dropouts)
    opts = dict(max_epochs=1, seed=SEED, log_every=1, image_log_frequency=0, save_top_k=1,
                device="cpu", max_steps_per_epoch=STEPS, resume=False,
                init_weights=initial is None)
    if mode == "stage1":
        from dynamicvectorquantization_torch.utils.weights import load_stage1_state

        if initial is not None:
            load_stage1_state(Stage1Trainer(model, 1e-3, device="cpu"), initial)
        model.quantize._draw_restart = _port_draw
        model.learning_rate = 8 * cfg["model"]["base_learning_rate"]
    else:
        if initial is not None:
            model.load_state_dict(initial)
        model.learning_rate = cfg["model"]["learning_rate"]
        model.min_learning_rate = cfg["model"]["min_learning_rate"]
        opts["cached_codes"] = "off" if mode == "inline" else "on"
    opts.update(kw)
    return Trainer(str(logdir), **opts).fit(model, data), _rows(str(logdir))


def _train_rows(rows):
    return [r for r in rows if r["split"] == "train"]


@pytest.mark.parametrize("mode,k", [("cached", 2), ("cached", 4), ("inline", 4), ("class", 2)])
def test_port_loop_at_k_matches_the_jax_loop(class_yml, tmp_path_factory, mode, k):
    from dynamicvectorquantization_torch.utils.weights import (
        adamw_state_from_optax,
        stackgpt_state_dict_from_flax,
    )

    root = tmp_path_factory.mktemp("fits")
    want, jstate, initial = _jax_loop(mode, k, class_yml, root)
    step_obj, got = _port_fit(mode, root / f"port-{mode}-{k}", class_yml, initial,
                              steps_per_dispatch=k)
    steps = [(i, "train") for i in range(k, STEPS + 1, k)] + [(STEPS, "val")]
    assert [(r["step"], r["split"]) for r in got] == [(r["step"], r["split"]) for r in want] \
        == steps
    compared = 0
    for a, b in zip(got, want):
        names = [n for n in b if n.endswith("_loss") or n in ("lr", "train_aeloss")]
        assert set(names) <= set(a) and names
        for n in names:
            np.testing.assert_allclose(a[n], b[n], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{mode} K={k} step {a['step']} {n}")
            compared += 1
    assert compared >= 5 * len(steps)
    assert step_obj.count == int(jstate.step) == STEPS and step_obj.epoch == 1
    count, m, _ = adamw_state_from_optax(jstate.opt)
    params = stackgpt_state_dict_from_flax(jstate.params)
    assert count == STEPS and sorted(params) == sorted(step_obj.masters)
    lr = step_obj.schedule(0)
    for name, p in step_obj.masters.items():
        # within Adam's reach of STEPS updates of at most lr (1 + wd |p|) each; the
        # first moments (sums of gradients) within f32 summation order
        torch.testing.assert_close(p, params[name], atol=STEPS * 2.1 * lr, rtol=0, msg=name)
        torch.testing.assert_close(step_obj.m[name], m[name], atol=1e-5, rtol=1e-3, msg=name)


def test_auto_rule_and_the_dropped_trailing_group(class_yml, tmp_path):
    """None: K = min(8, steps an epoch) on cached codes, so 3 at 3 steps and
    8 at 12, whose trailing group of 4 is dropped; 1 with the inline encode
    and in stage 1."""
    for budget, want_k, want_steps in ((3, 3, 3), (12, 8, 8)):
        loop = Trainer(str(tmp_path / f"a{budget}"), max_epochs=1, seed=SEED, log_every=1,
                       image_log_frequency=0, save_top_k=1, device="cpu",
                       max_steps_per_epoch=budget, resume=False)
        model, data, cfg = _port_model(TINY)
        model.learning_rate = cfg["model"]["learning_rate"]
        step_obj = loop.fit(model, data)
        assert loop.steps_per_dispatch == want_k and step_obj.count == want_steps
        assert [r["step"] for r in _train_rows(_rows(str(tmp_path / f"a{budget}")))] == \
            [want_k * (i + 1) for i in range(want_steps // want_k)]
    step_obj, rows = _port_fit("inline", tmp_path / "inline", class_yml, max_steps_per_epoch=3,
                               cached_codes="off")
    assert step_obj.count == 3 and [r["step"] for r in _train_rows(rows)] == [1, 2, 3]
    loop = Trainer(str(tmp_path / "s1"), device="cpu")
    assert loop.steps_per_dispatch == 1 and loop._steps_per_dispatch_auto
    with pytest.raises(ValueError):
        Trainer(str(tmp_path / "zero"), device="cpu", steps_per_dispatch=0)


def test_cadences_count_optimizer_steps(class_yml, tmp_path):
    """K = 2 over 8 steps, rows every 3 steps and grids every 4: a dispatch
    logs when one of its steps lands on the cadence, the last step of the
    group (the JAX loop's `(bi * K) % every < K`)."""
    step_obj, rows = _port_fit("cached", tmp_path, class_yml, max_steps_per_epoch=8,
                               steps_per_dispatch=2, log_every=3, image_log_frequency=4)
    assert step_obj.count == 8
    assert [r["step"] for r in _train_rows(rows)] == [2, 6, 8]  # bi = 0, 2, 3
    grids = sorted(os.listdir(tmp_path / "images" / "train"))
    assert {g.split("_Step_")[1].split("_")[0] for g in grids} == {"2", "6"}  # bi = 0, 2


def _state(step_obj):
    """A trainer's whole state, tensors by name."""
    if isinstance(step_obj, Stage1Trainer):
        sd = step_obj.state_dict()
        return {**{f"model.{n}": t for n, t in sd["model"].items()},
                **{f"{o}.{n}": t for o in ("ae_opt", "disc_opt")
                   for n, t in _flat(sd[o]).items()}, "generator": sd["generator"]}
    return {f"{part}.{n}": t for part in ("masters", "m", "v")
            for n, t in getattr(step_obj, part).items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}.").items()}
    return {prefix: tree} if isinstance(tree, torch.Tensor) else {}


@pytest.mark.parametrize("mode", ["cached", "inline", "class", "stage1"])
def test_k_steps_a_dispatch_equal_one_step_a_dispatch_bit_for_bit(class_yml, tmp_path, mode):
    """The whole state (stage 2: masters and both moments, every dropout at
    0.1) and every logged value at K = 2 and 4 equal those at K = 1 to the
    bit, at the steps both log."""
    drop = mode != "stage1"
    ref, ref_rows = _port_fit(mode, tmp_path / "k1", class_yml, dropouts=drop,
                              steps_per_dispatch=1)
    by_step = {r["step"]: r for r in _train_rows(ref_rows)}
    want = _state(ref)
    for k in (2, 4):
        got, rows = _port_fit(mode, tmp_path / f"k{k}", class_yml, dropouts=drop,
                              steps_per_dispatch=k)
        state = _state(got)
        assert sorted(state) == sorted(want) and len(want) > 10
        for name, t in want.items():
            assert torch.equal(state[name], t), (k, name)
        assert [r["step"] for r in _train_rows(rows)] == list(range(k, STEPS + 1, k))
        for r in _train_rows(rows):
            for n, v in r.items():
                if n.startswith("train_") or n == "lr":
                    assert v == by_step[r["step"]][n], (k, r["step"], n)
        assert [_untimed(r) for r in rows if r["split"] == "val"] == \
            [_untimed(r) for r in ref_rows if r["split"] == "val"]


def _untimed(row):
    return {n: v for n, v in row.items() if n != "time"}


def test_resumed_run_at_k4_equals_the_uninterrupted_one(class_yml, tmp_path):
    kw = dict(dropouts=True, steps_per_dispatch=4, max_epochs=2)
    whole, whole_rows = _port_fit("cached", tmp_path / "whole", class_yml, **kw)
    first, _ = _port_fit("cached", tmp_path / "part", class_yml, stop_epoch=1, **kw)
    assert first.epoch == 1 and first.count == STEPS
    resumed, rows = _port_fit("cached", tmp_path / "part", class_yml, resume=True, **kw)
    assert resumed.epoch == whole.epoch == 2 and resumed.count == whole.count == 2 * STEPS
    for name in whole.masters:
        for a, b in ((whole.masters, resumed.masters), (whole.m, resumed.m),
                     (whole.v, resumed.v)):
            assert torch.equal(a[name], b[name]), name

    def strip(r):
        return {n: v for n, v in r.items() if n not in ("time", "images_per_sec",
                                                        "cache_encode_seconds")}

    assert [strip(r) for r in rows] == [strip(r) for r in whole_rows]
    assert [r["step"] for r in _train_rows(rows)] == [STEPS, 2 * STEPS]


# -------------------------------------------------------- the static step
def _stage2_trainer(dtype=None, **overrides):
    cfg = load_config([TINY])["model"]
    cfg["params"]["transformer_config"]["params"].update(overrides)
    model = instantiate_from_config(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    return Stage2Trainer(model.eval(), 1e-3, warmup_steps=0, max_steps=50, compute_dtype=dtype,
                         device="cpu", seed=3)


def _tiny_streams(trainer, b=4):
    r = np.random.default_rng(1)
    x = r.uniform(-1, 1, size=(2 * b, 64, 64, 3)).astype(np.float32)
    x[:, :, :32] = (0.2 + 0.01 * x[:, :, :32]).astype(np.float32)
    z = trainer.encode_dataset(x, batch=b)
    return [{n: v[i:i + b] for n, v in z.items()} for i in (0, b)]


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_static_step_equals_the_eager_step_bit_for_bit(dtype):
    """`train_step` on cached streams (the static-state step the card
    captures: seed table and AdamW triple read from tensors) against
    `compute_grads` + `apply_update` (int seeds, float scalars), every
    dropout at 0.1, three steps."""
    a, b = _stage2_trainer(dtype, **DROPOUTS), _stage2_trainer(dtype, **DROPOUTS)
    streams = _tiny_streams(a)
    for i in range(3):
        got = a.train_step(streams[i % 2])
        want, grads = b.compute_grads(streams[i % 2])
        b.apply_update(grads)
        assert sorted(got) == sorted(want)
        for n in want:
            assert torch.equal(got[n], want[n]), (i, n)
    for name in a.masters:
        for x, y in ((a.masters, b.masters), (a.m, b.m), (a.v, b.v)):
            assert torch.equal(x[name], y[name]), name
        assert torch.equal(a.params[name].data, b.params[name].data), name
    assert not graphs.runners_of(a)  # the CPU captures nothing


def test_seed_table_holds_each_layers_mixed_seed():
    trainer = _stage2_trainer(**DROPOUTS)
    trainer.count = 5
    table = trainer.seed_table()
    assert table.dtype == np.int64 and len(table) == trainer.n_layers == 4
    want = [mix_seed(attention_seed(trainer.base_seed, 5, 0), i) for i in range(4)]
    assert table.view(np.uint64).tolist() == want
    trainer.count = 6
    assert not np.array_equal(trainer.seed_table(), table)


def test_logs_are_copies_the_next_step_leaves_alone():
    trainer = _stage2_trainer(**DROPOUTS)
    streams = _tiny_streams(trainer)
    first = trainer.train_step(streams[0])
    kept = {n: float(v) for n, v in first.items()}
    trainer.train_step(streams[1])
    assert {n: float(v) for n, v in first.items()} == kept


# ------------------------------------------- device seeds and scalars (CPU)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [77, 2 ** 63 + 5])
def test_tensor_seed_equals_int_seed_through_the_plain_attention(dtype, seed):
    g = torch.Generator().manual_seed(0)
    b, t, n_head, hd = 2, 37, 2, 16
    q, k, v = (torch.randn((b, t, n_head * hd), generator=g).to(dtype).requires_grad_()
               for _ in range(3))
    as_tensor = torch.tensor(np.array([seed], dtype=np.uint64).view(np.int64)[0])
    outs = []
    for s in (seed, as_tensor):
        y = fused_causal_attention(q, k, v, n_head, rate=0.25, seed=s)
        grads = torch.autograd.grad(y.float().square().sum(), (q, k, v))
        y2, lse = fused_attention_forward(q.detach(), k.detach(), v.detach(), n_head, None, True,
                                          0.25, True, s)
        back = fused_attention_backward(q.detach(), k.detach(), v.detach(), y2, lse,
                                        torch.ones_like(y2), n_head, rate=0.25, seed=s)
        outs.append((y, *grads, y2, lse, *back))
    for a, c in zip(*outs):
        assert torch.equal(a, c)
    with pytest.raises(ValueError):
        fused_attention_forward(q, k, v, n_head, rate=0.25, seed=torch.tensor([1, 2]))
    with pytest.raises(ValueError):
        fused_attention_forward(q, k, v, n_head, rate=0.25, seed=torch.tensor(1.0))


@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("count", [0, 7])
def test_tensor_lr_c1_c2_equal_floats_through_the_plain_adamw(gdtype, count):
    g = torch.Generator().manual_seed(count)
    shape = (33, 20)
    grad = torch.randn(shape, generator=g).to(gdtype)
    state = [torch.randn(shape, generator=g), 0.1 * torch.randn(shape, generator=g),
             torch.rand(shape, generator=g)]
    scalars = adamw_scalars(count, lambda c: 3e-4 * (1 + c), 0.9, 0.95)
    runs = []
    for triple in (scalars, (torch.tensor(scalars, dtype=torch.float32), None, None)):
        p, m, v = (x.clone() for x in state)
        copy = torch.empty(shape, dtype=torch.bfloat16)
        fused_adamw_step(grad, p, m, v, *triple, 0.9, 0.95, 1e-8, 0.01, copy=copy)
        runs.append((p, m, v, copy))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        fused_adamw_step_plain(grad, *state, torch.zeros(2), None, None)


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (dtype, hd, family): one shape per family of `ops/attention.py` `_route`
FAMILIES = [(torch.float32, 32, "square tiles"), (torch.bfloat16, 32, "square tiles"),
            (torch.float32, 256, "wide f32"), (torch.float32, 128, "f32 tensor cores"),
            (torch.bfloat16, 128, "tensor cores"), (torch.bfloat16, 256, "tensor cores wide")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,family", FAMILIES,
                         ids=[f"{f[2]}-{f[1]}-{str(f[0])[6:]}" for f in FAMILIES])
def test_device_seed_entries_equal_the_by_value_entries_on_cuda(cuda, dtype, hd, family):
    """Forward (with lse) and backward at rate 0.1 through each family's
    `_device_seed` entry equal the by-value entry bit for bit; the forward's
    kept set equals `dropout_keep_mask`."""
    g = torch.Generator(device=cuda).manual_seed(hd)
    b, t, n_head, seed, rate = 2, 150, 2, 2 ** 63 + 77, 0.1
    q, k, v, dy = (torch.randn((b, t, n_head * hd), generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    table = torch.tensor(np.array([seed], dtype=np.uint64).view(np.int64), device=cuda)
    fwd_seen, bwd_seen = (fused_attention_forward.device_seed_launches,
                          fused_attention_backward.device_seed_launches)
    outs = []
    for s in (seed, table[0]):
        y, lse = fused_attention_forward(q, k, v, n_head, None, True, rate, True, s)
        outs.append((y, lse, *fused_attention_backward(q, k, v, y, lse, dy, n_head, rate=rate,
                                                       seed=s)))
    for a, c in zip(*outs):
        assert torch.equal(a, c)
    assert fused_attention_forward.device_seed_launches == fwd_seen + 1
    assert fused_attention_backward.device_seed_launches == bwd_seen + 1
    # the kept set: uniform probabilities, V rows unit vectors (hd >= t's first hd columns)
    n = min(hd, t)
    ones = torch.zeros((b, t, n_head, hd), device=cuda)
    ones[:, torch.arange(n), :, torch.arange(n)] = 1.0
    zero = torch.zeros_like(q)
    y = fused_attention_forward(zero, zero, ones.reshape(b, t, -1).to(dtype).contiguous(),
                                n_head, None, False, rate, seed=table[0])
    kept = y.view(b, t, n_head, hd).transpose(1, 2)[..., :n] > 0
    assert torch.equal(kept, dropout_keep_mask(seed, b, n_head, t, rate, cuda)[..., :n])


@pytest.mark.cuda
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
def test_device_scalar_adamw_equals_the_by_value_entry_on_cuda(cuda, gdtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    n = 4096 * 33 + 3  # a vectorised body and a scalar tail
    grad = torch.randn(n, generator=g, device=cuda).to(gdtype)
    state = [torch.randn(n, generator=g, device=cuda), torch.randn(n, generator=g, device=cuda),
             torch.rand(n, generator=g, device=cuda)]
    scalars = adamw_scalars(4, 5e-4)
    before = fused_adamw_step.device_scalar_launches
    runs = []
    for triple in (scalars, (torch.tensor(scalars, device=cuda), None, None)):
        p, m, v = (x.clone() for x in state)
        copy = torch.empty(n, dtype=torch.bfloat16, device=cuda)
        fused_adamw_step(grad, p, m, v, *triple, 0.9, 0.95, 1e-8, 0.01, copy=copy)
        runs.append((p, m, v, copy))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert fused_adamw_step.device_scalar_launches == before + 1


def _cuda_trainer(cuda, dtype, labelled=False, b=4):
    cfg = (_class_config() if labelled else load_config([TINY]))["model"]
    cfg["params"]["transformer_config"]["params"].update(DROPOUTS)
    cfg["params"]["transformer_config"]["params"]["n_embd"] = 128  # two heads of 64
    model = instantiate_from_config(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    trainer = Stage2Trainer(model.eval(), 1e-3, warmup_steps=0, max_steps=50,
                            compute_dtype=dtype, device=cuda, seed=3)
    streams = _tiny_streams(trainer, b)
    labels = [np.array([1, 4, 0, 9][:b]), np.array([2, 2, 7, 5][:b])] if labelled else [None] * 2
    return trainer, streams, labels


def _run(trainer, streams, labels, eager, n=3):
    logs = [trainer.train_step(streams[i % 2], c=labels[i % 2], eager=eager) for i in range(n)]
    return logs, {name: (trainer.masters[name].clone(), trainer.m[name].clone(),
                         trainer.v[name].clone()) for name in trainer.masters}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,labelled", [("bfloat16", False), (None, False),
                                            ("bfloat16", True)], ids=["bf16", "f32", "class"])
def test_graph_step_equals_the_eager_step_on_cuda(cuda, dtype, labelled):
    graph, streams, labels = _cuda_trainer(cuda, dtype, labelled)
    eager = _cuda_trainer(cuda, dtype, labelled)[0]
    got, got_state = _run(graph, streams, labels, False)
    want, want_state = _run(eager, streams, labels, True)
    runner = graphs.runner_for(graph, cuda)
    assert runner.captures == 1 and runner.replays == 2
    for a, b in zip(got, want):
        for n in b:
            assert torch.equal(a[n], b[n]), n
    for name, tensors in want_state.items():
        for a, b in zip(got_state[name], tensors):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_new_parameter_storage_captures_a_new_graph_on_cuda(cuda):
    trainer, streams, labels = _cuda_trainer(cuda, "bfloat16")
    control = _cuda_trainer(cuda, "bfloat16")[0]
    runner = graphs.runner_for(trainer, cuda)
    _run(trainer, streams, labels, False, n=2)
    _run(control, streams, labels, True, n=2)
    assert runner.captures == 1
    for p in trainer.params.values():  # the working copy moves to new storage
        p.data = p.data.clone()
    got = _run(trainer, streams, labels, False, n=2)
    want = _run(control, streams, labels, True, n=2)
    assert runner.captures == 2
    for name in want[1]:
        for a, b in zip(got[1][name], want[1][name]):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_launches_counted_through_replays_on_cuda(cuda):
    trainer, streams, labels = _cuda_trainer(cuda, "bfloat16")
    layers, leaves = trainer.n_layers, len(trainer.params)
    counted = [(fused_attention_forward, "device_seed_launches"),
               (fused_attention_backward, "device_seed_launches"),
               (fused_adamw_step, "device_scalar_launches"), (fused_adamw_step, "launches")]
    per_step = []
    for eager in (True, False, False, False):  # eager, capture, replay, replay
        before = [getattr(w, n) for w, n in counted]
        trainer.train_step(streams[0], eager=eager)
        per_step.append([getattr(w, n) - b for (w, n), b in zip(counted, before)])
    assert per_step == [[layers, layers, leaves, leaves]] * 4
    assert graphs.runner_for(trainer, cuda).replays == 2
