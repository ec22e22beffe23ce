"""Trainer command line (counterpart of the repository's root `train.py`):

    python -m dynamicvectorquantization_torch.train \\
        --base configs/stage2/uncond_imagenet_p6c18.yml --max_epochs 50 [key.path=value ...]

  * N base YAMLs merged left to right, then `key.path=value` overrides;
  * logdir `<--logdir>/<name>-<timestamp>/{configs,checkpoints,images}` with a
    snapshot of the merged config (`configs/merged-project.yaml`, in the YAML
    subset this package reads back) and `argv.json`;
  * the LR rule `lr = accumulate_grad_batches x devices x batch_size x
    base_learning_rate` (or the config's fixed `learning_rate`);
  * `--resume <logdir>` reads the snapshot back, merges any further `--base`
    files and overrides on top, restores the newest checkpoint and continues
    (to `--max_epochs`, which the command line gives again; the LR schedule
    spans `--max_epochs`, so a run meant to be continued exactly is ended
    with `--stop_epoch`, not with a smaller `--max_epochs`);
  * `--device` (default: the CUDA card; `cpu` runs the plain versions);
  * `--profile_steps N`: a `torch.profiler` trace of the first N optimizer
    steps in `<logdir>/profile/`;
  * any other `--flag` the parser does not know is an error.

  * `--steps_per_dispatch K`: K optimizer steps a dispatch, the log and image
    cadences in optimizer steps, a trailing incomplete group dropped; unset,
    8 on the stage-2 cached-codes path (capped by the epoch's steps) and 1
    elsewhere, as the JAX launcher. On the card each cached-codes step
    replays a CUDA graph; on the CPU the same step runs eagerly.

Training over several devices is not ported: those flags raise and name
their ROADMAP.md item (`--pp_microbatches` only with `--pp`).
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys


def get_parser():
    p = argparse.ArgumentParser(description="dqvq trainer (PyTorch + CUDA)")
    p.add_argument("--base", nargs="*", default=[], metavar="cfg.yml",
                   help="base config YAMLs, merged left-to-right")
    p.add_argument("-t", "--train", type=str, default="True")
    p.add_argument("--max_epochs", type=int, default=50)
    p.add_argument("--devices", "--gpus", type=int, default=1,
                   help="number of cards; only 1 (or -1 / 0: what is there) is ported")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card, `cpu` for the plain versions")
    p.add_argument("--resume", type=str, default=None,
                   help="logdir to resume (restores configs + latest ckpt)")
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--logdir", type=str, default="logs")
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--save_n", type=int, default=3, help="checkpoint top-k")
    p.add_argument("--stop_epoch", type=int, default=None,
                   help="end this run once that many epochs are done, the LR schedule still "
                        "laid out for --max_epochs; --resume continues it exactly")
    p.add_argument("--max_steps_per_epoch", type=int, default=None, help="cap steps (smoke runs)")
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--steps_per_dispatch", type=int, default=None,
                   help="optimizer steps per dispatch (default: 8 on the stage-2 cached-codes "
                        "path, capped by the epoch's steps; else 1)")
    p.add_argument("--cached_codes", choices=("auto", "on", "off"), default="auto",
                   help="stage-2 cached-codes training: pre-encode each epoch's batches "
                        "through the frozen first stage once, then train on token streams. "
                        "auto = on when accumulate_grad_batches == 1")
    p.add_argument("--log_every", type=int, default=50,
                   help="train-metric logging cadence in optimizer steps")
    p.add_argument("--image_log_every", type=int, default=50,
                   help="image-grid logging cadence in optimizer steps (stage-2 grids "
                        "SAMPLE; 0 turns them off)")
    p.add_argument("--logtype", type=str, default="csv",
                   help="metric sinks besides metrics.jsonl / .csv: tensorboard (<logdir>/tb), "
                        "wandb (skipped where it is not installed), all (tensorboard)")
    p.add_argument("--activate_ddp_share", action="store_true", help="not ported")
    p.add_argument("--activate_fsdp", action="store_true", help="not ported")
    p.add_argument("--tp", type=int, default=1, help="not ported")
    p.add_argument("--sp", type=int, default=1, help="not ported")
    p.add_argument("--pp", type=int, default=1, help="not ported")
    p.add_argument("--pp_microbatches", type=int, default=None,
                   help="pipeline microbatches; needs --pp, which is not ported")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="write a torch.profiler trace of the first N optimizer steps into "
                        "<logdir>/profile (0: off)")
    return p


def set_learning_rate(model, config, accumulate_grad_batches: int, n_devices: int = 1):
    """The reference launcher's LR rule; sets `model.learning_rate` and
    `model.min_learning_rate`."""
    mcfg = config["model"]
    bs = config["data"]["params"]["batch_size"]
    if "base_learning_rate" in mcfg:
        base_lr = mcfg["base_learning_rate"]
        model.learning_rate = accumulate_grad_batches * n_devices * bs * base_lr
        print(f"Setting learning rate to {model.learning_rate:.2e} = "
              f"{accumulate_grad_batches} (accum) * {n_devices} (devices) * "
              f"{bs} (batchsize) * {base_lr:.2e} (base_lr)")
    elif "learning_rate" in mcfg:
        model.learning_rate = mcfg["learning_rate"]
        print("Using default learning_rate", model.learning_rate)
    else:
        raise SystemExit("Please set a learning rate in the model config!")
    model.min_learning_rate = mcfg.get("min_learning_rate", 0.0)


def main(argv=None):
    """Run the trainer; returns the step object (`Stage2Trainer` or
    `Stage1Trainer`) in its final state."""
    import torch

    from ..config.yaml_config import dump_yaml, load_config
    from ..utils.device import resolve_device
    from ..utils.instantiate import instantiate_from_config
    from .loop import Trainer

    argv = list(sys.argv[1:] if argv is None else argv)
    parser = get_parser()
    opt, unknown = parser.parse_known_args(argv)
    dropped = [u for u in unknown if "=" not in u or u.startswith("-")]
    if dropped:  # only key.path=value overrides pass through; nothing is dropped in silence
        parser.error(f"unrecognized arguments: {' '.join(dropped)}")
    if opt.pp_microbatches is not None and opt.pp <= 1:
        parser.error("--pp_microbatches needs --pp > 1")

    base_configs = list(opt.base)
    if opt.resume:
        logdir = opt.resume.rstrip("/")
        cfg_dir = os.path.join(logdir, "configs")
        base_configs = [os.path.join(cfg_dir, f) for f in sorted(os.listdir(cfg_dir))
                        if f.endswith((".yml", ".yaml"))] + base_configs
    else:
        now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
        name = opt.name or (os.path.splitext(os.path.basename(base_configs[0]))[0]
                            if base_configs else "run")
        logdir = os.path.join(opt.logdir, f"{name}-{now}")
    config = load_config(base_configs, unknown)

    os.makedirs(os.path.join(logdir, "configs"), exist_ok=True)
    with open(os.path.join(logdir, "configs", "merged-project.yaml"), "w") as f:
        f.write(dump_yaml(config) + "\n")
    with open(os.path.join(logdir, "argv.json"), "w") as f:
        json.dump(["train"] + argv, f)

    device = resolve_device(opt.device)
    trainer = Trainer(
        logdir=logdir, max_epochs=opt.max_epochs, seed=opt.seed, save_top_k=opt.save_n,
        device=device, max_steps_per_epoch=opt.max_steps_per_epoch, resume=bool(opt.resume),
        accumulate_grad_batches=opt.accumulate_grad_batches,
        steps_per_dispatch=opt.steps_per_dispatch, cached_codes=opt.cached_codes,
        devices=opt.devices, opt_sharding=opt.activate_ddp_share, fsdp=opt.activate_fsdp,
        tp=opt.tp, sp=opt.sp, pp=opt.pp, logtype=opt.logtype, log_every=opt.log_every,
        image_log_frequency=opt.image_log_every, stop_epoch=opt.stop_epoch,
        profile_steps=opt.profile_steps)
    with torch.device(device):
        model = instantiate_from_config(config["model"])
    data = instantiate_from_config(config["data"])
    set_learning_rate(model, config, opt.accumulate_grad_batches)
    do_train = str(opt.train).lower() not in ("false", "0", "no")
    return trainer.fit(model, data, eval_only=not do_train)
