"""Writes the initial stage-1 state of the JAX package's campaign runs (r04 /
r05: `train.py --seed 23` on `configs/stage1/dqvae-entropy-dual-r05_imagenet.yml`
with the campaign's overrides) as a step-0 run directory of the port, which
`python -m dynamicvectorquantization_torch.train --resume <dir>` continues
(`tools/stage1_causes.py --legs jax_init --jax_init <dir>`).

    JAX_PLATFORMS=cpu DQVQ_IMAGENET_ROOT=artifacts/campaign_r05/data \\
        python tests/fixtures/stage1/jax_campaign_init.py build/f14_init/jax_init \\
        [--carry build/f14_init/carry.pt] [--base <yml>] [--seed 23] [key.path=value ...]

The JAX loop (`train/loop.py` `_fit_stage1`) starts stage 1 from
`Stage1Trainer.init_state(PRNGKey(seed), x0[:1])`, x0 the first batch of
`data.train_dataloader(seed=seed).epoch(0)`, run eagerly; this script does the
same, converts the state with the port's `utils.weights.stage1_state_from_flax`
(the DQ-VAE's parameters and EMA codebook, the discriminator's parameters and
BatchNorm statistics, the LPIPS backbone and lin heads) and writes it with
`tools.stage1_causes.write_initial_run` on the CPU. `--carry` also writes the
tensors outside the DQ-VAE's towers (the EMA codebook, the discriminator, the
LPIPS net: ~73 MB at full width) as one state-dict file, from which the
`jax_init` leg writes its step-0 run itself where the whole state is too large
to take along. Needs the JAX package; not committed output (~0.65 GB at full
width, zero Adam moments included).
"""
import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
YML = "configs/stage1/dqvae-entropy-dual-r05_imagenet.yml"
SEED = 23
# the campaign's stage-1 overrides (artifacts/campaign_torch_r02/stage1_argv.json)
OVERRIDES = ("model.params.encoderconfig.params.router_config.params.json_path="
             "artifacts/campaign_r05/thresholds/entropy_thresholds_imagenet_train_patch-16.json",
             "data.params.batch_size=8", "data.params.num_workers=2")
TOWERS = ("encoder.", "decoder.", "quant_conv.", "post_quant_conv.")
sys.path.insert(0, REPO)


def jax_initial_state(base, seed, overrides):
    """(the JAX `Stage1State` the loop starts from, x0) for `base` + `overrides`."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    import dynamicvectorquantization_tpu.nn.lpips  # noqa: F401  (constants before tracing)
    from dynamicvectorquantization_tpu.config.yaml_config import load_config
    from dynamicvectorquantization_tpu.train.stage1 import Stage1Trainer
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config

    jax.config.update("jax_platforms", "cpu")
    config = load_config([base], list(overrides))
    model = instantiate_from_config(config["model"])
    data = instantiate_from_config(config["data"])
    sample = next(iter(data.train_dataloader(seed=seed).epoch(0)))
    x0 = model.get_input(sample, model.image_key)
    trainer = Stage1Trainer(model, learning_rate=1e-4)  # the rate enters no state at step 0
    return trainer.init_state(jax.random.PRNGKey(seed), x0[:1]), x0


def export(run_dir, base=YML, seed=SEED, overrides=OVERRIDES, carry=None):
    """Write the step-0 run (and `carry`); returns the converted state
    (`stage1_state_from_flax`)."""
    import torch

    from dynamicvectorquantization_torch.tools.stage1_causes import write_initial_run
    from dynamicvectorquantization_torch.utils.weights import stage1_state_from_flax

    base = os.path.join(REPO, base)
    overrides = [o.replace("json_path=artifacts/", f"json_path={REPO}/artifacts/")
                 for o in overrides]
    state, _ = jax_initial_state(base, seed, overrides)
    converted = stage1_state_from_flax(state)
    sd = {k: torch.as_tensor(v) for k, v in converted["state_dict"].items()}
    path = write_initial_run(run_dir, [base], overrides, seed, sd, device="cpu")
    if carry:
        torch.save({k: v for k, v in sd.items() if not k.startswith(TOWERS)}, carry)
    print(f"{path}: {sum(v.numel() for v in sd.values())} model values"
          + (f"; {carry}" if carry else ""))
    return converted


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run_dir")
    p.add_argument("--carry", default=None)
    p.add_argument("--base", default=YML)
    p.add_argument("--seed", type=int, default=SEED)
    opt, extra = p.parse_known_args(argv)
    export(opt.run_dir, opt.base, opt.seed, list(OVERRIDES) + extra, opt.carry)


if __name__ == "__main__":
    main()
