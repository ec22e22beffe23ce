"""Training over several ranks (`parallel/`) against the JAX package's
multi-device steps, and checkpoints written off the training thread.

One module-scoped job: two gloo processes on the CPU, one rank each, spawned
once (`torch.multiprocessing`), which take from the same states and batches:

  * the stage-2 cached-codes step (the tiny config, dropout 0, two steps over
    global batches of 4 whose two halves hold different padding) as plain
    DDP, ZeRO-1 and FSDP, in f32 and with the bf16 working copy;
  * the stage-1 step (the 32^2 configuration of `test_torch_stage1_train.py`,
    two steps over global batches of 4, the codebook restart given the same
    shared draw as there) as DDP, ZeRO-1 and FSDP;
  * ActNorm's data-dependent init from each rank's rows;
  * the stage-2 loop through `cli.main` at world 2: a whole run of two
    epochs, and the same run ended with `--stop_epoch 1` and resumed.

`shard_min_elements` is small here, so that the tiny models' larger leaves
are sharded. While the job runs, this process takes the JAX package's steps
on a 2-device mesh (`parallel/mesh.py` `make_mesh(2)`, the global batch
sharded over "dp": the JAX step over the global batch) and the port's
one-process step over the global batch. Tolerances: losses 1e-5, as
`test_torch_train.py` holds the one-process step; stage 1's logs, EMA
buffers and BatchNorm statistics rtol 1e-4 / atol 1e-5, as
`tests/test_multidevice.py` holds dp8 against dp1 (the first step against
JAX dp-2, the second against the port's one-process step, see
`test_stage1_two_ranks_match_jax_dp2`); parameters, as there,
within one Adam update (2.1 lr) a step each, 5e-5 on the mean, and under 1 %
of the entries more than 1e-5 apart (f32 rounding flips an update only where
a gradient is near zero); ZeRO-1 and FSDP bit-equal to DDP.

JAX is imported inside the fixtures.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import load_config
from dynamicvectorquantization_torch.data.pipeline import PrefetchLoader
from dynamicvectorquantization_torch.models.dqvae import DualGrainVQModel
from dynamicvectorquantization_torch.nn.discriminator import ActNorm
from dynamicvectorquantization_torch.parallel import dist
from dynamicvectorquantization_torch.train import cli
from dynamicvectorquantization_torch.train.loop import Trainer
from dynamicvectorquantization_torch.train.stage1 import Stage1Trainer
from dynamicvectorquantization_torch.train.stage2 import Stage2Trainer
from dynamicvectorquantization_torch.utils import checkpoint as ckpt_mod
from dynamicvectorquantization_torch.utils.checkpoint import CheckpointManager
from dynamicvectorquantization_torch.utils.instantiate import instantiate_from_config
from dynamicvectorquantization_torch.utils.weights import load_stage1_state

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY2 = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")
LR, MAX_STEPS = 1e-3, 50
WORLD = 2
GLOBAL_BATCH = 4
MIN_ELEMENTS = 1024  # shard the tiny models' larger leaves
SHARDS = (None, "zero1", "fsdp")
JOB_SECONDS = 600  # the ranks' wait for the parent's inputs, and the parent's for the ranks
FIT = ["--base", TINY2, "--device", "cpu", "--max_steps_per_epoch", "2", "--log_every", "1",
       "--save_n", "1", "--image_log_every", "0", "--steps_per_dispatch", "1", "--max_epochs",
       "2"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ shared inputs
def _stage2_model(state_dict):
    model = instantiate_from_config(load_config([TINY2])["model"])
    model.load_state_dict(state_dict)
    return model.eval()


def _stage2_state_dict():
    """The tiny stage-2 model seeded, perturbed so zero tables carry signal."""
    model = instantiate_from_config(load_config([TINY2])["model"])
    model.init_weights(torch.Generator().manual_seed(0))
    r = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.transformer.parameters():
            p.add_(torch.from_numpy(r.normal(0.0, 0.05, tuple(p.shape)).astype(np.float32)))
        cb = model.first_stage_model.quantize.codebook.weight
        cb[:-1] = torch.from_numpy((0.5 * r.normal(size=tuple(cb[:-1].shape))).astype(np.float32))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _stage2_images():
    """Eight 64^2 images: smooth left halves, and a mostly smooth or mostly
    noisy image each, so the two halves of a batch hold different padding."""
    r = np.random.default_rng(1)
    x = r.uniform(-1, 1, size=(8, 64, 64, 3)).astype(np.float32)
    x[:, :, :32] = (0.2 + 0.01 * x[:, :, :32]).astype(np.float32)
    x[[0, 1, 4, 5], 8:] = (0.1 + 0.01 * x[[0, 1, 4, 5], 8:]).astype(np.float32)
    return x


def _stage1_images(seed):
    from tests.test_torch_stage1_train import _images

    return _images(seed, b=GLOBAL_BATCH)


def _port_draw(pool_rows, noise_shape, generator, device):
    """The shared restart draw of `test_torch_stage1_train.py`."""
    perm = np.random.default_rng(pool_rows).permutation(pool_rows)
    noise = (None if noise_shape is None else
             np.random.default_rng(7).uniform(size=noise_shape).astype(np.float32))
    return (None if noise is None else torch.from_numpy(noise)), torch.from_numpy(perm)


def _rank_rows(x, world):
    if world is None:
        return x
    if isinstance(x, dict):
        return {k: v[world.rows(len(v))] for k, v in x.items()}
    return x[world.rows(len(x))]


# --------------------------------------------------------------- the ranks
def _stage2_run(inp, world, shard, dtype):
    trainer = Stage2Trainer(_stage2_model(inp["s2_state"]), LR, warmup_steps=0,
                            max_steps=MAX_STEPS, device="cpu", world=world, shard=shard,
                            shard_min_elements=MIN_ELEMENTS, compute_dtype=dtype)
    logs = [{k: float(v) for k, v in trainer.train_step(_rank_rows(z, world)).items()}
            for z in inp["streams"]]
    sharded = None if trainer.buckets is None else list(trainer.buckets.sharded)
    return {"logs": logs, "state": trainer.state_dict(), "sharded": sharded,
            "moment_numel": sum(t.numel() for t in trainer.m.values())}


def _stage1_run(inp, world, shard):
    trainer = Stage1Trainer(DualGrainVQModel(**inp["s1_config"]), LR, warmup_steps=0,
                            max_steps=100, device="cpu", world=world, shard=shard,
                            shard_min_elements=MIN_ELEMENTS)
    load_stage1_state(trainer, inp["s1_state"])
    trainer.model.quantize._draw_restart = _port_draw
    out = []
    for x in inp["s1_images"]:
        logs = trainer.train_step(_rank_rows(x, world), torch.Generator().manual_seed(0))
        out.append({"logs": {k: float(v) for k, v in logs.items()},
                    "state": _cloned(trainer.state_dict())})
    return out


def _cloned(obj):
    """A copy of a state dict (the trainer's holds its live tensors)."""
    if isinstance(obj, dict):
        return {k: _cloned(v) for k, v in obj.items()}
    return obj.clone() if isinstance(obj, torch.Tensor) else obj


def _job(rank, size, init, tmp):
    torch.set_num_threads(1)
    world = dist.init_world("cpu", rank, size, init)
    try:
        inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        out = {"host_groups": world.host_groups(), "rows": world.rows(8)}
        out["stage2"] = {(dtype, shard): _stage2_run(inp, world, shard, dtype)
                         for dtype in (None, "bfloat16") for shard in SHARDS}
        norm = ActNorm(3)
        with dist.global_stats(world):
            norm.initialize(_rank_rows(inp["actnorm_x"], world))
        out["actnorm"] = (norm.loc.detach().clone(), norm.scale.detach().clone())
        whole = cli.main(FIT, world=world, logdir=os.path.join(tmp, "whole"))
        cli.main(FIT + ["--stop_epoch", "1"], world=world, logdir=os.path.join(tmp, "part"))
        resumed = cli.main(FIT + ["--resume", os.path.join(tmp, "part")], world=world)
        out["fit"] = {"whole": whole.state_dict(), "resumed": resumed.state_dict(),
                      "lr": whole.schedule(0)}
        # the stage-1 inputs come from the JAX init, which runs meanwhile
        s1, deadline = os.path.join(tmp, "stage1.pt"), time.monotonic() + JOB_SECONDS
        while not os.path.exists(s1):
            if os.path.exists(os.path.join(tmp, "failed")) or time.monotonic() > deadline:
                raise RuntimeError("the stage-1 inputs never came from the parent")
            time.sleep(0.1)
        inp.update(torch.load(s1, weights_only=False))
        out["stage1"] = {shard: _stage1_run(inp, world, shard) for shard in SHARDS}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.shutdown()


# ------------------------------------------------------------- the fixture
def _jax_stage2(state_dict, streams):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload
    from dynamicvectorquantization_tpu.parallel.mesh import batch_sharding, make_mesh, replicate
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
    trainer = JTrainer(model, LR, warmup_steps=0, max_steps=MAX_STEPS)
    mesh = make_mesh(WORLD)
    b_sh = batch_sharding(mesh)
    state = replicate(mesh, trainer.init_state(variables))
    out = []
    with mesh:
        step = jax.jit(trainer.train_step, in_shardings=(None, None, b_sh, b_sh, None))
        for i, z in enumerate(streams):
            z = jax.device_put({k: jnp.asarray(v, jnp.int32) for k, v in z.items()}, b_sh)
            state, logs = step(state, replicate(mesh, variables), z, z, jax.random.PRNGKey(i))
            out.append({"logs": {k: float(v) for k, v in logs.items()},
                        "params": stackgpt_state_dict_from_flax(jax.device_get(state.params))})
    return out


def _jax_stage1(jtrainer, state, batches):
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.parallel.mesh import batch_sharding, make_mesh, replicate
    from tests.test_torch_stage1_train import _shared_draw

    from dynamicvectorquantization_torch.utils.weights import stage1_state_from_flax

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(_shared_draw(n, None)[1]))
    mp.setattr(jax.random, "uniform",
               lambda key, shape, *a, **k: jnp.asarray(_shared_draw(1, shape)[0]))
    mesh = make_mesh(WORLD)
    b_sh = batch_sharding(mesh)
    out = []
    try:
        st = replicate(mesh, state)
        with mesh:
            step = jax.jit(jtrainer.train_step, in_shardings=(None, b_sh, None))
            for i, x in enumerate(batches):
                st, logs = step(st, jax.device_put(jnp.asarray(x), b_sh),
                                jax.random.PRNGKey(10 + i))
                out.append({"logs": {k: float(v) for k, v in logs.items()},
                            "model": stage1_state_from_flax(jax.device_get(st))["state_dict"]})
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": [rank 0's results, rank 1's], "jax2" / "jax1": JAX dp-2
    stage 2 / stage 1, "one2" / "one1": the port's one-process steps over the
    global batches, "inputs", "tmp"}."""
    import jax
    import jax.numpy as jnp

    # imported before any trace: its jnp constants are made at import
    import dynamicvectorquantization_tpu.nn.lpips  # noqa: F401
    from dynamicvectorquantization_tpu.models.dqvae import DualGrainVQModel as JModel
    from dynamicvectorquantization_tpu.train.stage1 import Stage1Trainer as JTrainer
    from tests.test_torch_stage1_train import _config

    from dynamicvectorquantization_torch.utils.weights import stage1_state_from_flax

    tmp = str(tmp_path_factory.mktemp("gloo"))
    s2_state = _stage2_state_dict()
    z = Stage2Trainer(_stage2_model(s2_state), LR, device="cpu").encode_dataset(
        _stage2_images(), batch=4)
    streams = [{k: v[i:i + GLOBAL_BATCH] for k, v in z.items()} for i in (0, GLOBAL_BATCH)]
    inputs = {"s2_state": s2_state, "streams": streams,
              "actnorm_x": torch.from_numpy(np.random.default_rng(4).normal(
                  size=(4, 3, 5, 6)).astype(np.float32))}
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    ctx = torch.multiprocessing.start_processes(
        _job, args=(WORLD, f"tcp://127.0.0.1:{dist.free_port()}", tmp), nprocs=WORLD,
        join=False, start_method="spawn")
    try:
        cfg = _config()
        jtrainer = JTrainer(JModel(**cfg), learning_rate=LR, warmup_steps=0, max_steps=100)
        # one compile instead of op by op; both sides start from its numbers
        j1_state = jax.device_get(jax.jit(jtrainer.init_state)(
            jax.random.PRNGKey(1), jnp.asarray(_stage1_images(0)[:2])))
        s1 = {"s1_config": cfg, "s1_state": stage1_state_from_flax(j1_state),
              "s1_images": [_stage1_images(1), _stage1_images(2)]}
        torch.save(s1, os.path.join(tmp, "stage1.tmp"))
        os.replace(os.path.join(tmp, "stage1.tmp"), os.path.join(tmp, "stage1.pt"))
        inputs.update(s1)
        jax2 = _jax_stage2(s2_state, streams)
        jax1 = _jax_stage1(jtrainer, j1_state, s1["s1_images"])
        one = Stage2Trainer(_stage2_model(s2_state), LR, warmup_steps=0, max_steps=MAX_STEPS,
                            device="cpu")
        one2 = ([{k: float(v) for k, v in one.train_step(x).items()} for x in streams],
                one.state_dict())
        one1 = _stage1_run(inputs, None, None)
    except BaseException:
        open(os.path.join(tmp, "failed"), "w").close()  # the ranks stop waiting for stage 1
        raise
    finally:
        deadline = time.monotonic() + JOB_SECONDS
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError(f"the gloo ranks did not end within {JOB_SECONDS} s")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "jax2": jax2, "jax1": jax1, "inputs": inputs, "tmp": tmp,
            "one2": one2, "one1": one1}


# ------------------------------------------------------------------- tests
def test_hosts_group_ranks_and_a_rank_takes_its_rows(runs):
    assert dist.group_by_host(["a", "b", "a", "c", "b"]) == [(0, 2), (1, 4), (3,)]
    r0, r1 = runs["ranks"]
    assert r0["host_groups"] == r1["host_groups"] == [(0, 1)]
    assert (r0["rows"], r1["rows"]) == (slice(0, 4), slice(4, 8))


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return {"x": np.array([i, rng.integers(1 << 30)])}


def test_a_global_batch_the_world_does_not_divide_raises():
    world = dist.World(0, 3, "cpu", "gloo")
    with pytest.raises(ValueError, match="does not divide"):
        world.rows(8)
    loader = PrefetchLoader(_Items(16), batch_size=8)
    with pytest.raises(ValueError, match="does not divide"):
        next(loader.epoch(0, part=(0, 3)))


def test_each_rank_decodes_its_rows_with_the_global_generators():
    loader = PrefetchLoader(_Items(16), batch_size=8, shuffle=True, seed=5)
    whole = list(loader.epoch(2))
    parts = [list(loader.epoch(2, part=(r, 2))) for r in range(2)]
    for b, p0, p1 in zip(whole, *parts):
        assert len(p0["x"]) == len(p1["x"]) == 4
        np.testing.assert_array_equal(np.concatenate([p0["x"], p1["x"]]), b["x"])


def test_stage2_halves_hold_different_padding(runs):
    pads = []
    for z in runs["inputs"]["streams"]:
        valid = (z["coarse_position"] != 16).sum(axis=1) + (z["fine_position"] != 64).sum(axis=1)
        pads.append((int(valid[:2].sum()), int(valid[2:].sum())))
    assert any(a != b for a, b in pads), pads


@pytest.mark.parametrize("step", [0, 1])
def test_stage2_two_ranks_equal_one_process_and_jax_dp2(runs, step):
    ours = runs["ranks"][0]["stage2"][(None, None)]["logs"][step]
    one = runs["one2"][0][step]
    ref = runs["jax2"][step]["logs"]
    assert ours == runs["ranks"][1]["stage2"][(None, None)]["logs"][step]
    for key, want in ref.items():
        np.testing.assert_allclose(ours[key], want, atol=1e-5, rtol=0, err_msg=key)
        np.testing.assert_allclose(one[key], want, atol=1e-5, rtol=0, err_msg=key)


def test_stage2_parameters_after_two_steps_match_jax_dp2(runs):
    masters = runs["ranks"][0]["stage2"][(None, None)]["state"]["masters"]
    one = runs["one2"][1]["masters"]
    want = runs["jax2"][1]["params"]
    assert sorted(masters) == sorted(want)
    start = {k[len("transformer."):]: v for k, v in runs["inputs"]["s2_state"].items()
             if k.startswith("transformer.")}
    for name, p in masters.items():
        for got in (p, one[name]):  # two Adam updates of at most lr (1 + wd |p|) each
            torch.testing.assert_close(got, want[name], atol=2 * 2.1 * LR, rtol=0, msg=name)
    # the bulk tight: rounding flips an update only where a gradient is ~0
    d = torch.cat([(p - want[name]).abs().flatten() for name, p in masters.items()])
    assert float(d.mean()) < 5e-5 and float((d > 1e-5).float().mean()) < 0.01


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("shard", ["zero1", "fsdp"])
def test_stage2_sharded_steps_are_bit_equal_to_ddp(runs, dtype, shard):
    for rank in runs["ranks"]:
        base, run = rank["stage2"][(dtype, None)], rank["stage2"][(dtype, shard)]
        assert run["logs"] == base["logs"]
        assert run["sharded"] and run["moment_numel"] < 0.7 * base["moment_numel"]
        for key in ("masters", "m", "v"):
            for k, t in base["state"][key].items():
                assert torch.equal(run["state"][key][k], t), (shard, key, k)


@pytest.mark.parametrize("step", [0, 1])
def test_stage1_two_ranks_match_jax_dp2(runs, step):
    """The first step against JAX dp-2: logs, EMA buffers, BatchNorm
    statistics. The second step starts from parameters a few Adam updates
    apart (f32 rounding flips the sign of an update where a gradient is near
    zero, as in `test_torch_stage1_train.py`), and what follows them (the
    discriminator's logits, the codebook's smallest entries) moves by up to
    ~3e-5: it is held to the port's one-process step over the same global
    batch, which the two ranks must equal, at the same tolerance. Parameters
    against JAX dp-2 at both steps."""
    ours = runs["ranks"][0]["stage1"][None][step]
    ref = runs["jax1"][step]
    held = ({"logs": ref["logs"], "model": ref["model"]} if step == 0 else
            {"logs": runs["one1"][step]["logs"], "model": runs["one1"][step]["state"]["model"]})
    assert sorted(ours["logs"]) == sorted(ref["logs"])
    for k, v in held["logs"].items():
        np.testing.assert_allclose(ours["logs"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    sd, sd_r = ours["state"]["model"], held["model"]
    for k in ("weight", "cluster_size_ema", "embed_ema"):
        key = f"quantize.codebook.{k}"
        np.testing.assert_allclose(sd[key].numpy(), sd_r[key].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    running = [k for k in sd_r if "running" in k]
    assert len(running) == 4
    for k in running:
        np.testing.assert_allclose(sd[k].numpy(), sd_r[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    sd_r = ref["model"]
    names = [k for k in sd_r if k.startswith(("encoder.", "decoder.", "quant_conv.",
                                              "post_quant_conv.", "loss.discriminator."))
             and "running" not in k and "num_batches" not in k]
    d = torch.cat([(sd[k] - sd_r[k]).abs().flatten() for k in names])
    assert float(d.max()) <= 2.1 * LR * (step + 1)
    assert float(d.mean()) < 5e-5


def test_stage1_restarts_the_same_codes_from_the_global_pool(runs):
    """Step 1 restarts every code (64 codes, 32 rows a rank): the candidates
    are the global batch's rows in rank order, tiled and jittered, with one
    permutation on both ranks, so both ranks hold JAX dp-2's codebook and
    the one-process step's."""
    ours = runs["ranks"][0]["stage1"][None][0]["state"]["model"]
    other = runs["ranks"][1]["stage1"][None][0]["state"]["model"]
    one = runs["one1"][0]["state"]["model"]
    ref = runs["jax1"][0]["model"]
    key = "quantize.codebook.cluster_size_ema"
    assert torch.equal(ours[key], torch.ones(64)) and torch.equal(ref[key], torch.ones(64))
    for k in ("weight", "embed_ema"):
        key = f"quantize.codebook.{k}"
        assert torch.equal(ours[key], other[key])
        torch.testing.assert_close(ours[key], one[key], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(ours[key], ref[key], atol=1e-5, rtol=1e-4)


def test_stage1_adaptive_weight_is_the_global_batchs(runs):
    for step in (0, 1):
        got = runs["ranks"][0]["stage1"][None][step]["logs"]["train_d_weight"]
        want = runs["jax1"][step]["logs"]["train_d_weight"]
        assert 0 < got <= 0.75 + 1e-6
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shard", ["zero1", "fsdp"])
def test_stage1_sharded_steps_are_bit_equal_to_ddp(runs, shard):
    for rank in runs["ranks"]:
        for base, run in zip(rank["stage1"][None], rank["stage1"][shard]):
            assert run["logs"] == base["logs"]
            for k, t in base["state"]["model"].items():
                assert torch.equal(run["state"]["model"][k], t), (shard, k)
            for opt in ("ae_opt", "disc_opt"):
                for key in ("m", "v"):
                    for k, t in base["state"][opt][key].items():
                        assert torch.equal(run["state"][opt][key][k], t), (shard, opt, key, k)


def test_actnorm_init_takes_the_global_rows(runs):
    x = runs["inputs"]["actnorm_x"]
    norm = ActNorm(3)
    norm.initialize(x)
    loc, scale = runs["ranks"][0]["actnorm"]
    torch.testing.assert_close(loc, norm.loc.detach(), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(scale, norm.scale.detach(), atol=1e-5, rtol=1e-5)


def test_world2_resume_is_bit_equal_and_runs_at_world1(runs, tmp_path):
    fit = runs["ranks"][0]["fit"]
    for key in ("masters", "m", "v"):
        for k, t in fit["whole"][key].items():
            assert torch.equal(fit["resumed"][key][k], t), (key, k)
    assert fit["resumed"]["count"] == fit["whole"]["count"] == 4
    # the world-2 run's rank 0 wrote the rows; the LR is the yml's fixed rate
    assert fit["lr"] == pytest.approx(1e-3)
    part = os.path.join(runs["tmp"], "part")
    assert len(os.listdir(os.path.join(part, "checkpoints"))) == 2  # newest + index.json
    one = cli.main(FIT[:-1] + ["3", "--resume", part])
    assert one.world is None if hasattr(one, "world") else True
    assert one.count == 6


def test_lr_rule_counts_the_devices():
    model = type("M", (), {})()
    cfg = {"model": {"base_learning_rate": 2e-6}, "data": {"params": {"batch_size": 8}}}
    for n in (1, 2, 8):
        cli.set_learning_rate(model, cfg, 3, n)
        assert model.learning_rate == pytest.approx(3 * n * 8 * 2e-6)


# ----------------------------------------------------- checkpoint writer
def _slow_save(monkeypatch, seconds):
    real = torch.save

    def slow(obj, path):
        time.sleep(seconds)
        real(obj, path)

    monkeypatch.setattr(ckpt_mod.torch, "save", slow)


def test_save_returns_before_a_slow_write_and_the_next_save_waits(tmp_path, monkeypatch):
    real = torch.save
    gate = threading.Event()

    def held(obj, path):
        gate.wait(10)
        real(obj, path)

    monkeypatch.setattr(ckpt_mod.torch, "save", held)
    mngr = CheckpointManager(str(tmp_path), save_top_k=2, monitor="val_loss")
    w = torch.ones(3)
    t0 = time.perf_counter()
    mngr.save(1, {"w": w}, {"val_loss": 1.0})
    assert time.perf_counter() - t0 < 1.0
    w.fill_(5.0)  # the snapshot was taken at the save
    assert not os.path.exists(mngr.path(1))
    threading.Timer(0.3, gate.set).start()
    t0 = time.perf_counter()
    mngr.save(2, {"w": w}, {"val_loss": 0.5})
    assert time.perf_counter() - t0 >= 0.25 and os.path.exists(mngr.path(1))
    assert mngr.all_steps() == [1, 2]
    assert float(mngr.restore(1)["w"][0]) == 1.0 and float(mngr.restore()["w"][0]) == 5.0


def test_fit_waits_for_the_last_write(tmp_path, monkeypatch):
    _slow_save(monkeypatch, 0.5)
    step = cli.main(FIT[:-1] + ["1", "--logdir", str(tmp_path)])
    (run,) = os.listdir(tmp_path)
    ckpts = os.path.join(tmp_path, run, "checkpoints")
    assert f"step_{step.count}.pt" in os.listdir(ckpts)
    assert not [n for n in os.listdir(ckpts) if n.endswith(".tmp")]
    buckets = __import__("json").load(open(os.path.join(tmp_path, run, "loop_buckets.json")))
    assert buckets["buckets"]["checkpoint_wait"] >= 0.3
    assert buckets["buckets"]["checkpoint"] < buckets["buckets"]["checkpoint_wait"]


def test_preemption_waits_for_the_emergency_write(tmp_path, monkeypatch, capsys):
    _slow_save(monkeypatch, 0.5)
    cfg = load_config([TINY2])
    model = instantiate_from_config(cfg["model"])
    model.learning_rate = 1e-3
    loop = Trainer(str(tmp_path), max_epochs=1, seed=1, log_every=1, image_log_frequency=0,
                   save_top_k=1, device="cpu", steps_per_dispatch=1)
    real_fit = loop._run_epochs

    def fit_with_signal(step_obj, *args):
        args = list(args)
        step_fn = args[4]

        def stepping(x):
            if step_obj.count == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return step_fn(x)

        args[4] = stepping
        return real_fit(step_obj, *args)

    loop._run_epochs = fit_with_signal
    stopped = loop.fit(model, instantiate_from_config(cfg["data"]))
    assert stopped.count == 2
    assert "emergency checkpoint saved at step 2" in capsys.readouterr().out
    assert "step_2.pt" in os.listdir(tmp_path / "checkpoints")


def test_global_batchnorm_equals_batch_norm():
    """At world size 1 the global-statistics BatchNorm (two differentiable
    sums over the ranks) gives `F.batch_norm`'s output, input gradient and
    running statistics, in f64."""
    from dynamicvectorquantization_torch.nn.discriminator import BatchNorm2d

    world = dist.init_world("cpu", 0, 1, f"tcp://127.0.0.1:{dist.free_port()}")
    try:
        g = torch.Generator().manual_seed(0)
        x = torch.randn(8, 16, 7, 7, dtype=torch.float64, generator=g)
        dy = torch.randn(8, 16, 7, 7, dtype=torch.float64, generator=g)
        out = []
        for scope in (None, world):
            bn = BatchNorm2d(16).double()
            with torch.no_grad():
                bn.weight.copy_(torch.linspace(0.5, 1.5, 16, dtype=torch.float64))
                bn.bias.copy_(torch.linspace(-1.0, 1.0, 16, dtype=torch.float64))
            xi = x.clone().requires_grad_(True)
            with dist.global_stats(scope):
                y = bn(xi, train=True)
            grads = torch.autograd.grad((y * dy).sum(), [xi, bn.weight, bn.bias])
            out.append((y.detach(), *grads, bn.running_mean.clone(), bn.running_var.clone()))
        for a, b in zip(*out):
            torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-12)
    finally:
        dist.shutdown()
