"""The campaign's stage-1 leg at a cut width on the CPU, in the JAX package:
the reference half of `tools/stage1_causes.py`'s `cpu_pair` leg.

    JAX_PLATFORMS=cpu python tests/fixtures/stage1/jax_cpu_pair.py <out dir> \\
        [--nudge --batches <out dir of the first run>]

The recipe is the campaign's (`artifacts/campaign_r05/stage1_argv.json`): the
yml `configs/stage1/dqvae-entropy-dual-r05_imagenet.yml`, batch 8, seed 23,
the campaign's threshold table, the committed JPEG tree
`artifacts/campaign_r05/data`, lr 8 x 4.5e-6 = 3.6e-5 over 6 epochs of 384
steps (warm-up int(0.1 x 384) = 38 steps, cosine to 0 at step 2,304), the
JAX loop's `Stage1Trainer.init_state(PRNGKey(23), x0[:1])` and its per-step
key `fold_in(PRNGKey(23), step)`. Cut (`CUTS`): the towers' `ch` 128 -> 32,
`z_channels` and the decoder's `in_ch` / `quant_before_dim` 256 -> 64, the
discriminator's `ndf` 64 -> 16, and the resolution 256^2 -> 128^2 (the
decoder's `latent_size` 32 -> 16): at 256^2 a step takes ~10 s on an 8-core
CPU, 384 steps over an hour a run. The codebook (1,024 x 256), the LPIPS
net, the router's threshold table and everything else stay.

Draws the two packages cannot share are fed from here: the training batches
(the JAX loader's epoch 0, written once to `<out>/batches.npy` and read back
by every run) and the codebook restart's permutation and jitter, which both
packages take from `restart_draw(step, ...)` of the port's
`tools/stage1_causes.py` (numpy, seeded by the step). Nothing else draws:
dropout is 0 and the entropy router has no Gumbel noise.

Writes `<out>/step0.pt` (the initial state converted by
`utils.weights.stage1_state_from_flax`), `<out>/config.json` (the merged
config) and `<out>/metrics.jsonl` (one row of the step's logs per step, then
a `val` row: the mean of `eval_step` over the 256 validation images, also
kept in `<out>/val.npy`). `--nudge` is the control: the decoder's `conv_out`
kernel moved by one f32 ulp (`np.nextafter` towards +inf) before step 1,
with the batches of `--batches`.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, REPO)

from tests.fixtures.stage1.jax_campaign_init import OVERRIDES, SEED, YML  # noqa: E402

CUTS = ("model.params.encoderconfig.params.ch=32",
        "model.params.encoderconfig.params.z_channels=64",
        "model.params.decoderconfig.params.ch=32",
        "model.params.decoderconfig.params.in_ch=64",
        "model.params.quant_before_dim=64",
        "model.params.lossconfig.params.disc_config.params.ndf=16",
        "model.params.encoderconfig.params.resolution=128",
        "model.params.decoderconfig.params.resolution=128",
        "model.params.decoderconfig.params.latent_size=16",
        "data.params.train.params.config.size=128",
        "data.params.validation.params.config.size=128")
LR, WARMUP, MAX_STEPS = 8 * 4.5e-6, 38, 2304
STEPS = 384  # the campaign's first epoch, up to its first validation
NUDGED = ("decoder", "conv_out", "kernel")


def overrides():
    return [o.replace("json_path=artifacts/", f"json_path={REPO}/artifacts/")
            for o in OVERRIDES] + list(CUTS)


def write_batches(data, model, out, steps, seed=SEED):
    """The loader's first `steps` training batches and every validation
    batch as float32 arrays."""
    path = os.path.join(out, "batches.npy")
    arr = None
    it = data.train_dataloader(seed=seed).epoch(0)
    for i in range(steps):
        x = np.asarray(model.get_input(next(it), model.image_key), np.float32)
        if arr is None:
            arr = np.lib.format.open_memmap(path, "w+", np.float32, (steps, *x.shape))
        arr[i] = x
    arr.flush()
    val = [np.asarray(model.get_input(b, model.image_key), np.float32)
           for b in data.val_dataloader(seed=seed).epoch(0)]
    np.save(os.path.join(out, "val.npy"), np.stack(val))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out")
    p.add_argument("--nudge", action="store_true")
    p.add_argument("--batches", default=None, help="a run directory holding batches.npy")
    opt = p.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("DQVQ_IMAGENET_ROOT", os.path.join(REPO, "artifacts/campaign_r05/data"))
    import jax
    import jax.numpy as jnp
    import torch

    import dynamicvectorquantization_tpu.nn.lpips  # noqa: F401  (constants before tracing)
    from dynamicvectorquantization_tpu.config.yaml_config import load_config
    from dynamicvectorquantization_tpu.train.stage1 import Stage1Trainer
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config
    from dynamicvectorquantization_torch.tools.stage1_causes import restart_draw
    from dynamicvectorquantization_torch.utils.weights import stage1_state_from_flax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(opt.out, exist_ok=True)
    config = load_config([os.path.join(REPO, YML)], overrides())
    with open(os.path.join(opt.out, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    model = instantiate_from_config(config["model"])
    src = opt.batches or opt.out
    if not os.path.exists(os.path.join(src, "batches.npy")):
        write_batches(instantiate_from_config(config["data"]), model, src, STEPS)
    batches = np.load(os.path.join(src, "batches.npy"), mmap_mode="r")
    val = np.load(os.path.join(src, "val.npy"))

    trainer = Stage1Trainer(model, learning_rate=LR, warmup_steps=WARMUP, max_steps=MAX_STEPS)
    state = trainer.init_state(jax.random.PRNGKey(SEED), jnp.asarray(batches[0][:1]))
    state = jax.device_get(state)
    converted = stage1_state_from_flax(state)
    torch.save(converted, os.path.join(opt.out, "step0.pt"))
    if opt.nudge:
        params = jax.tree_util.tree_map(np.asarray, state.ae_params)
        node = params
        for k in NUDGED[:-1]:
            node = node[k]
        node[NUDGED[-1]] = np.nextafter(node[NUDGED[-1]], np.float32(np.inf))
        state = state._replace(ae_params=params)

    # the restart's draws come in as arguments, so one compiled step serves
    # every step with that step's draw
    drawn = {}
    mp_perm, mp_uniform = jax.random.permutation, jax.random.uniform

    def permutation(key, n, *a, **k):
        return drawn["perm"] if drawn.get("perm") is not None and n == drawn["perm"].shape[0] \
            else mp_perm(key, n, *a, **k)

    def uniform(key, shape=(), *a, **k):
        noise = drawn.get("noise")
        if noise is not None and tuple(shape) == tuple(noise.shape):
            return noise
        return mp_uniform(key, shape, *a, **k)

    jax.random.permutation, jax.random.uniform = permutation, uniform

    pool = {"uniform": []}

    def probe_perm(key, n, *a, **k):  # the restart pool, read while tracing once
        pool["rows"] = n
        return mp_perm(key, n, *a, **k)

    def probe_uniform(key, shape=(), *a, **k):
        pool["uniform"].append(tuple(shape))
        return mp_uniform(key, shape, *a, **k)

    jax.random.permutation, jax.random.uniform = probe_perm, probe_uniform
    jax.eval_shape(trainer.train_step, state, jnp.asarray(batches[0]), jax.random.PRNGKey(0))
    jax.random.permutation, jax.random.uniform = permutation, uniform
    rows = pool["rows"]
    jitter = [s for s in pool["uniform"] if s and s[0] == rows]
    noise_shape = jitter[0] if jitter else None
    print(f"restart pool {rows} rows, jitter {noise_shape}", flush=True)

    def stepped(state, x, rng, perm, noise):
        drawn["perm"], drawn["noise"] = perm, noise
        try:
            return trainer.train_step(state, x, rng)
        finally:
            drawn.clear()

    step = jax.jit(stepped)
    base = jax.random.PRNGKey(SEED)
    with open(os.path.join(opt.out, "metrics.jsonl"), "w") as f:
        t0 = time.time()
        for i in range(STEPS):
            noise, perm = restart_draw(i + 1, rows, noise_shape)
            state, logs = step(state, jnp.asarray(batches[i]), jax.random.fold_in(base, i),
                               jnp.asarray(perm), None if noise is None else jnp.asarray(noise))
            row = {"step": i + 1, "split": "train", **{k: float(v) for k, v in logs.items()}}
            f.write(json.dumps(row) + "\n")
            f.flush()
            if (i + 1) % 32 == 0 or i < 4:
                print(f"step {i + 1}: {time.time() - t0:.1f} s", flush=True)
        ev = jax.jit(trainer.eval_step)
        outs = [jax.device_get(ev(state, jnp.asarray(x))) for x in val]
        row = {"step": STEPS, "split": "val",
               **{k: float(np.mean([o[k] for o in outs])) for k in outs[0]}}
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row))


if __name__ == "__main__":
    main()
