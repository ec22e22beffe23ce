"""Model parallelism of the stage-2 trainer (`--tp`, `--sp`, `--pp`) against
the JAX package's, and within the port.

Two module-scoped jobs of gloo processes on the CPU, one rank each, started
together (`torch.multiprocessing`):

  * two ranks: ring attention over an sp group of 2 and the GPipe schedule
    over a pp group of 2 on given inputs (outputs and gradients); the tiny
    config's trainer step (global batch 4, two steps) as tp 2, sp 2 and pp 2
    with dropout 0, and as tp 2 with the three dropouts at 0.1; the loop
    through `cli.main` with `--tp 2`: a whole run, and the same run ended
    with `--stop_epoch 1` and resumed;
  * four ranks: dp 2 x tp 2, plain, ZeRO-1 and FSDP.

Meanwhile this process takes the references: JAX `ring_attention` in
`shard_map` on a 2-device mesh, JAX `gpipe_apply` on a 2-device mesh, the
JAX dense step and the JAX dp 2 x tp 2 step (`make_mesh_2d`,
`stage2_param_shardings` and `tree_shardings_like` as the JAX loop places
the state), four compiles in all, and the port's one-process steps.
JAX's own slow tests hold its sp and pp steps to its dense step, so the
port's sp and pp steps are held to that one.

Tolerances: ring attention and the pipeline rtol 1e-5 / atol 1e-6 (f32, two
orders of summation); losses 1e-5, as `test_torch_distributed.py`;
parameters within one Adam update (2.1 lr) a step, 5e-5 on the mean, as
there; ZeRO-1 / FSDP bit-equal to plain dp 2 x tp 2; the tp step with
dropout against the one-process step as the others (the head offset gives
it the one-process masks). JAX is imported inside the fixtures.
"""
import os
import time

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.parallel import dist
from dynamicvectorquantization_torch.parallel import mesh as port_mesh
from dynamicvectorquantization_torch.parallel.pipeline import gpipe_apply, sequential_apply
from dynamicvectorquantization_torch.parallel.ring_attention import ring_attention
from dynamicvectorquantization_torch.train import cli
from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY2 = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")
LR, MAX_STEPS = 1e-3, 50
GLOBAL_BATCH = 4
MIN_ELEMENTS = 1024  # shard the tiny model's larger leaves
SHARDS = (None, "zero1", "fsdp")
JOB_SECONDS = 300
FIT = ["--base", TINY2, "--device", "cpu", "--max_steps_per_epoch", "2", "--log_every", "1",
       "--save_n", "1", "--image_log_every", "0", "--steps_per_dispatch", "1", "--max_epochs",
       "2", "--tp", "2"]
RING = dict(b=2, h=2, t=16, hd=16)  # ring attention's inputs, (B, H, T, hd)
PIPE = dict(m=2, mb=3, d=8, layers=4)  # the pipeline's microbatches and blocks
DROPOUTS = ("attn_pdrop", "resid_pdrop", "embd_pdrop")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ shared inputs
def _model(state_dict, dropout=0.0):
    cfg = load_config([TINY2])["model"]
    for k in DROPOUTS:
        cfg["params"]["transformer_config"]["params"][k] = dropout
    model = instantiate_from_config(cfg)
    model.load_state_dict(state_dict)
    return model.eval()


def _state_dict():
    """The tiny stage-2 model seeded, perturbed so zero tables carry signal."""
    model = instantiate_from_config(load_config([TINY2])["model"])
    model.init_weights(torch.Generator().manual_seed(0))
    r = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.transformer.parameters():
            p.add_(torch.from_numpy(r.normal(0.0, 0.05, tuple(p.shape)).astype(np.float32)))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _streams(seed, b=GLOBAL_BATCH, lc=5, lf=10):
    """Cached-codes streams with T = lc + lf + 1 = 16 (divisible by sp 2), the
    last entry of each stream a pad, as in the JAX package's parallel tests."""
    g = np.random.default_rng(seed)

    def padded(hi, n, pad):
        a = g.integers(0, hi, (b, n))
        a[:, -1] = pad
        return a

    return {"coarse_content": padded(64, lc, 64), "coarse_position": padded(16, lc, 16),
            "coarse_segment": np.zeros((b, lc), np.int64),
            "fine_content": padded(64, lf, 64), "fine_position": padded(64, lf, 64),
            "fine_segment": np.ones((b, lf), np.int64)}


def _ring_inputs():
    r = np.random.default_rng(3)
    shape = (RING["b"], RING["h"], RING["t"], RING["hd"])
    return [r.normal(size=shape).astype(np.float32) for _ in range(4)]  # q, k, v, dy


def _port_layout(a):
    """(B, H, T, hd) -> the port's (B, T, H * hd)."""
    b, h, t, hd = a.shape
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b, t, h * hd)))


def _pipe_inputs():
    r = np.random.default_rng(5)
    d = PIPE["d"]
    layers = [(r.normal(0, 0.4, (d, d)).astype(np.float32), r.normal(0, 0.1, d).astype(np.float32))
              for _ in range(PIPE["layers"])]
    x = r.normal(size=(PIPE["m"], PIPE["mb"], d)).astype(np.float32)
    dy = r.normal(size=x.shape).astype(np.float32)
    return layers, x, dy


def _block(layer, x):
    w, b = layer
    return torch.tanh(x @ w + b)


def _rows(x, world):
    return {k: v[world.rows(len(v))] for k, v in x.items()}


# --------------------------------------------------------------- the ranks
def _step_run(inp, world, dropout=0.0, shard=None, **axis):
    trainer = Stage2Trainer(_model(inp["state"], dropout), LR, warmup_steps=0,
                            max_steps=MAX_STEPS, device="cpu", world=world, shard=shard,
                            shard_min_elements=MIN_ELEMENTS, **axis)
    logs = [{k: float(v) for k, v in trainer.train_step(_rows(z, trainer.dp_world)).items()}
            for z in inp["streams"]]
    kept = None if trainer.buckets is None else list(trainer.buckets.sharded)
    return {"logs": logs, "state": trainer.state_dict(), "sharded": kept,
            "tp_dims": dict(trainer.tp_dims),
            "moment_numel": sum(t.numel() for t in trainer.m.values())}


def _ring_run(world):
    _, sp = dist.split_world(world, 2)
    q, k, v, dy = (_port_layout(a) for a in _ring_inputs())
    n = RING["t"] // 2
    rows = slice(sp.rank * n, (sp.rank + 1) * n)
    qs, ks, vs = (z[:, rows].clone().requires_grad_(True) for z in (q, k, v))
    y = ring_attention(qs, ks, vs, RING["h"], sp)
    y.backward(dy[:, rows])
    return [t.detach() for t in (y, qs.grad, ks.grad, vs.grad)]


def _pipe_run(world):
    _, pp = dist.split_world(world, 2)
    layers, x, dy = _pipe_inputs()
    per = PIPE["layers"] // 2
    mine = [tuple(torch.from_numpy(a).requires_grad_(True) for a in layer)
            for layer in layers[pp.rank * per:(pp.rank + 1) * per]]
    xs = torch.from_numpy(x).requires_grad_(True)
    y = gpipe_apply(lambda h, mb: sequential_apply(_block, mine, h), xs, pp,
                    [t for layer in mine for t in layer])
    (y * torch.from_numpy(dy)).sum().backward()
    return {"y": y.detach(), "dx": xs.grad, "grads": [[t.grad for t in layer] for layer in mine]}


def _shift_run(world):
    """`ring_shift` and its backward: rank r receives rank r - 1's tensor, and
    the gradient of what it received goes back to rank r - 1."""
    t = (torch.arange(3.0) + 10 * world.rank).requires_grad_(True)
    y = dist.ring_shift(t, world)
    (y * (world.rank + 2.0)).sum().backward()
    return y.detach(), t.grad


def _job2(rank, size, init, tmp):
    torch.set_num_threads(1)
    world = dist.init_world("cpu", rank, size, init)
    try:
        inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        out = {"ring": _ring_run(world), "pipe": _pipe_run(world), "shift": _shift_run(world)}
        out["steps"] = {"tp": _step_run(inp, world, tp=2), "sp": _step_run(inp, world, sp=2),
                        "pp": _step_run(inp, world, pp=2),
                        "tp_dropout": _step_run(inp, world, 0.1, tp=2)}
        whole = cli.main(FIT, world=world, logdir=os.path.join(tmp, "whole"))
        cli.main(FIT + ["--stop_epoch", "1"], world=world, logdir=os.path.join(tmp, "part"))
        resumed = cli.main(FIT + ["--resume", os.path.join(tmp, "part")], world=world)
        out["fit"] = {"whole": whole.state_dict(), "resumed": resumed.state_dict(),
                      "tp_dims": dict(whole.tp_dims)}
        torch.save(out, os.path.join(tmp, f"job2_rank{rank}.pt"))
    finally:
        dist.shutdown()


def _job4(rank, size, init, tmp):
    torch.set_num_threads(1)
    world = dist.init_world("cpu", rank, size, init)
    try:
        inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        out = {shard: _step_run(inp, world, shard=shard, tp=2) for shard in SHARDS}
        torch.save(out, os.path.join(tmp, f"job4_rank{rank}.pt"))
    finally:
        dist.shutdown()


# ------------------------------------------------------------- the fixture
def _jax_ring():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dynamicvectorquantization_tpu.parallel.mesh import make_mesh
    from dynamicvectorquantization_tpu.parallel.ring_attention import ring_attention as jring
    from dynamicvectorquantization_tpu.parallel.stackgpt_sp import shard_map

    q, k, v, dy = (jnp.asarray(a) for a in _ring_inputs())
    spec = P(None, None, "sp", None)
    fn = shard_map(jring, make_mesh(2, "sp"), (spec, spec, spec), spec)
    y, vjp = jax.vjp(jax.jit(fn), q, k, v)
    return [np.array(t) for t in (y, *vjp(dy))]


def _jax_pipe():
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.parallel.mesh import make_mesh
    from dynamicvectorquantization_tpu.parallel.pipeline import gpipe_apply as jgpipe
    from dynamicvectorquantization_tpu.parallel.pipeline import stack_layer_params

    layers, x, dy = _pipe_inputs()
    stacked = stack_layer_params([(jnp.asarray(w), jnp.asarray(b)) for w, b in layers], 2)
    mesh = make_mesh(2, "pp")

    def f(params, xx):
        return jgpipe(lambda p, h: jnp.tanh(h @ p[0] + p[1]), params, xx, mesh)

    y, vjp = jax.vjp(jax.jit(f), stacked, jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(dy))
    per = PIPE["layers"] // 2
    grads = [[np.array(g[s, i]) for g in dparams] for s in range(2) for i in range(per)]
    return {"y": np.array(y), "dx": np.array(dx), "grads": grads}


def _jax_steps(state_dict, streams):
    """(dense, dp 2 x tp 2): the JAX trainer's two steps each way,
    [{"logs", "params"}, ...]."""
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload
    from dynamicvectorquantization_tpu.parallel.mesh import (
        batch_sharding,
        make_mesh_2d,
        replicated,
        stage2_param_shardings,
        tree_shardings_like,
    )
    from dynamicvectorquantization_tpu.train.stage2 import Stage2Trainer as JTrainer
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import (
        convert_dqvae_state_dict,
        convert_stackgpt_state_dict,
    )

    from dynamicvectorquantization_torch.utils.weights import stackgpt_state_dict_from_flax

    model = jinst(jload([TINY2])["model"])
    sd = {k: v.numpy() for k, v in state_dict.items()}
    fs = {k[len("first_stage_model."):]: v for k, v in sd.items()
          if k.startswith("first_stage_model.")}
    fs["quantize.codebook.cluster_size_ema"] = np.zeros(
        fs["quantize.codebook.weight"].shape[0] - 1, np.float32)
    fs["quantize.codebook.embed_ema"] = fs["quantize.codebook.weight"][:-1]
    variables = {"transformer": convert_stackgpt_state_dict(sd, prefix="transformer."),
                 "first_stage": convert_dqvae_state_dict(fs)}
    trainer = JTrainer(model, LR, warmup_steps=0, max_steps=MAX_STEPS, fused_adamw=False)
    state0 = trainer.init_state(variables)
    zs = [{k: jnp.asarray(v, jnp.int32) for k, v in z.items()} for z in streams]

    def run(step, state, place=lambda z: z):
        out = []
        for i, z in enumerate(zs):
            state, logs = step(state, variables, place(z), place(z), jax.random.PRNGKey(i))
            out.append({"logs": {k: float(v) for k, v in logs.items()},
                        "params": stackgpt_state_dict_from_flax(jax.device_get(state.params))})
        return out

    dense = run(jax.jit(trainer.train_step), state0)
    mesh = make_mesh_2d(2, 2)
    p_sh = stage2_param_shardings(mesh, state0.params)
    st_sh = jax.tree_util.tree_map(lambda _: replicated(mesh), state0)._replace(
        params=p_sh, opt=tree_shardings_like(mesh, state0.opt, state0.params, p_sh))
    b_sh = batch_sharding(mesh)
    with mesh:
        step = jax.jit(trainer.train_step, in_shardings=(st_sh, None, b_sh, b_sh, None),
                       out_shardings=(st_sh, None))
        tp = run(step, jax.device_put(state0, st_sh), lambda z: jax.device_put(z, b_sh))
    return dense, tp, p_sh, state0.params


def _spawn(fn, n, tmp):
    return torch.multiprocessing.start_processes(
        fn, args=(n, f"tcp://127.0.0.1:{dist.free_port()}", tmp), nprocs=n, join=False,
        start_method="spawn")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    tmp = str(tmp_path_factory.mktemp("model_parallel"))
    state = _state_dict()
    streams = [_streams(11), _streams(12)]
    inputs = {"state": state, "streams": streams}
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    jobs = [_spawn(_job2, 2, tmp), _spawn(_job4, 4, tmp)]
    try:
        ring = _jax_ring()
        pipe = _jax_pipe()
        dense, tp, p_sh, jparams = _jax_steps(state, streams)
        one = {}
        for dropout in (0.0, 0.1):
            trainer = Stage2Trainer(_model(state, dropout), LR, warmup_steps=0,
                                    max_steps=MAX_STEPS, device="cpu")
            one[dropout] = ([{k: float(v) for k, v in trainer.train_step(z).items()}
                             for z in streams], trainer.state_dict())
        specs = jax.tree_util.tree_map(lambda sh, leaf: (sh.spec, leaf.shape), p_sh, jparams,
                                       is_leaf=lambda x: hasattr(x, "spec"))
    finally:
        deadline = time.monotonic() + JOB_SECONDS
        for ctx in jobs:
            while not ctx.join(timeout=2):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.terminate()
                    raise TimeoutError(f"the gloo ranks did not end within {JOB_SECONDS} s")
    job2 = [torch.load(os.path.join(tmp, f"job2_rank{r}.pt"), weights_only=False)
            for r in range(2)]
    job4 = [torch.load(os.path.join(tmp, f"job4_rank{r}.pt"), weights_only=False)
            for r in range(4)]
    return {"job2": job2, "job4": job4, "ring": ring, "pipe": pipe, "dense": dense, "tp": tp,
            "one": one, "specs": specs, "inputs": inputs, "tmp": tmp}


# ------------------------------------------------------------------- tests
def _close_params(got: dict, want: dict, steps=2):
    assert sorted(got) == sorted(want)
    for name, p in got.items():  # `steps` Adam updates of at most lr (1 + wd |p|) each
        torch.testing.assert_close(p, want[name], atol=steps * 2.1 * LR, rtol=0, msg=name)
    d = torch.cat([(p - want[name]).abs().flatten() for name, p in got.items()])
    assert float(d.mean()) < 5e-5


def _close_logs(got, want, atol=1e-5):
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=atol, rtol=0, err_msg=key)


def test_ring_attention_matches_jax(runs):
    """Each rank's rows of the output and of dQ, dK, dV against JAX
    `ring_attention` in `shard_map` over sp 2."""
    t = RING["t"] // 2
    for rank, got in enumerate(r["ring"] for r in runs["job2"]):
        for name, g, w in zip(("y", "dq", "dk", "dv"), got, runs["ring"]):
            want = _port_layout(w)[:, rank * t:(rank + 1) * t]
            torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6, msg=name)


def test_gpipe_matches_jax(runs):
    """The pipeline's outputs on both ranks, the input's gradient on both
    (summed from stage 0) and each stage's layer gradients against JAX
    `gpipe_apply` on a 2-device mesh."""
    want = runs["pipe"]
    per = PIPE["layers"] // 2
    for rank, got in enumerate(r["pipe"] for r in runs["job2"]):
        torch.testing.assert_close(got["y"], torch.from_numpy(want["y"]), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got["dx"], torch.from_numpy(want["dx"]), rtol=1e-5, atol=1e-6)
        for i, grads in enumerate(got["grads"]):
            for g, w in zip(grads, want["grads"][rank * per + i]):
                torch.testing.assert_close(g, torch.from_numpy(w), rtol=1e-5, atol=1e-6)


def test_split_rule_matches_jax_stage2_param_shardings(runs):
    """The leaves the port splits over tp (and by which dim of its (out, in)
    weights) are the leaves JAX's rule shards, on the tiny StackGPT."""
    import jax

    from dynamicvectorquantization_torch.utils.weights import stackgpt_state_dict_from_flax

    def code(entry):
        spec, shape = entry
        parts = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        dims = [i for i, a in enumerate(parts) if a == "tp"]
        return np.full(shape, -1 if not dims else dims[0], np.float32)

    coded = jax.tree_util.tree_map(code, runs["specs"], is_leaf=lambda x: isinstance(x, tuple))
    sd = stackgpt_state_dict_from_flax(coded)
    want = {}
    for name, t in sd.items():
        jdim = int(t.flatten()[0])
        if jdim >= 0:  # a JAX kernel (in, out) is the port's (out, in)
            want[name] = 1 - jdim if t.dim() == 2 else jdim
    shapes = {k: v.shape for k, v in _model(runs["inputs"]["state"]).transformer.state_dict()
              .items()}
    assert port_mesh.tp_split_dims(shapes, 2) == want
    assert runs["job2"][0]["steps"]["tp"]["tp_dims"] == want
    # per block: query, key, value and mlp.0 (weight and bias), proj and mlp.2 (weight)
    assert len(want) == 4 * 10


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("axis", ["tp", "sp", "pp"])
def test_model_axis_step_matches_jax_and_one_process(runs, axis, step):
    """Each rank's logs against the JAX dense step (JAX's own tests hold its
    sp / pp steps to it) and the port's one-process step; tp also against
    the JAX dp 2 x tp 2 step (from the four-rank job)."""
    ranks = [r["steps"][axis]["logs"][step] for r in runs["job2"]]
    assert ranks[0] == ranks[1]
    _close_logs(ranks[0], runs["dense"][step]["logs"])
    _close_logs(ranks[0], runs["one"][0.0][0][step])
    if axis == "tp":
        for r in runs["job4"]:
            _close_logs(r[None]["logs"][step], runs["tp"][step]["logs"])


@pytest.mark.parametrize("axis", ["tp", "sp", "pp"])
def test_model_axis_parameters_match_jax(runs, axis):
    """Whole leaves (`state_dict` gathers the tp shards) after two steps
    against the JAX dense step's and the port's one-process step's."""
    masters = runs["job2"][0]["steps"][axis]["state"]["masters"]
    _close_params(masters, runs["dense"][1]["params"])
    _close_params(masters, runs["one"][0.0][1]["masters"])
    for key in ("masters", "m", "v"):  # the ranks of a model group hold the same state
        for k, t in masters.items() if key == "masters" else \
                runs["job2"][0]["steps"][axis]["state"][key].items():
            assert torch.equal(runs["job2"][1]["steps"][axis]["state"][key][k], t), (key, k)


def test_dp2_tp2_matches_jax_dp2_tp2(runs):
    masters = runs["job4"][0][None]["state"]["masters"]
    _close_params(masters, runs["tp"][1]["params"])
    _close_params(masters, runs["one"][0.0][1]["masters"])


def test_tp_step_with_dropout_equals_one_process(runs):
    """tp 2 with attention, residual and embedding dropout at 0.1: the head
    offset gives each rank's heads the one-process step's attention masks,
    and the replicated dropouts draw alike on both ranks."""
    one_logs, one_state = runs["one"][0.1]
    for step in (0, 1):
        for r in runs["job2"]:
            _close_logs(r["steps"]["tp_dropout"]["logs"][step], one_logs[step])
    # dropout changes the step: the comparison is not the dropout-free one
    assert abs(one_logs[0]["train_loss"] - runs["one"][0.0][0][0]["train_loss"]) > 1e-3
    _close_params(runs["job2"][0]["steps"]["tp_dropout"]["state"]["masters"],
                  one_state["masters"])


@pytest.mark.parametrize("shard", ["zero1", "fsdp"])
def test_dp2_tp2_sharded_steps_are_bit_equal_to_plain(runs, shard):
    for rank in runs["job4"]:
        base, run = rank[None], rank[shard]
        assert run["logs"] == base["logs"]
        # the tp shards stay whole under ZeRO-1 / FSDP; the replicated leaves are cut
        assert run["sharded"] and not set(run["sharded"]) & set(run["tp_dims"])
        assert run["moment_numel"] < base["moment_numel"]
        for key in ("masters", "m", "v"):
            for k, t in base["state"][key].items():
                assert torch.equal(run["state"][key][k], t), (shard, key, k)


def test_tp_cli_run_resumes_equal_and_loads_in_one_process(runs):
    """`cli.main --tp 2`: the run stopped after one epoch and resumed equals
    the whole run bit for bit; its whole-leaf checkpoint loads into a
    one-process trainer, and that trainer's state is the checkpoint's."""
    from dynamicvectorquantization_torch.utils.checkpoint import CheckpointManager

    fit = runs["job2"][0]["fit"]
    for key in ("masters", "m", "v"):
        for k, t in fit["whole"][key].items():
            assert torch.equal(fit["resumed"][key][k], t), (key, k)
    assert fit["whole"]["count"] == fit["resumed"]["count"] == 4
    mngr = CheckpointManager(os.path.join(runs["tmp"], "whole", "checkpoints"))
    state = mngr.restore()
    one = Stage2Trainer(_model(runs["inputs"]["state"]), LR, device="cpu")
    one.load_state_dict(state["trainer"])
    got = one.state_dict()
    for key in ("masters", "m", "v"):
        for k, t in fit["whole"][key].items():
            assert got[key][k].shape == t.shape and torch.equal(got[key][k], t), (key, k)
    assert fit["tp_dims"]  # the run held shards


def test_ring_shift_hops_forward_and_its_gradient_hops_back(runs):
    for rank, r in enumerate(runs["job2"]):
        y, grad = r["shift"]
        other = 1 - rank
        assert torch.equal(y, torch.arange(3.0) + 10 * other)
        assert torch.equal(grad, torch.full((3,), other + 2.0))


def test_split_world_keeps_model_groups_inside_a_host():
    world = dist.World(0, 4, "cpu", "gloo", hosts=["a", "a", "b", "b"])
    with pytest.raises(ValueError, match="does not divide"):
        dist.split_world(world, 3)
    world = dist.World(0, 4, "cpu", "gloo", hosts=["a", "a", "a", "b"])
    with pytest.raises(ValueError, match="inside one host"):
        dist.split_world(world, 2)
