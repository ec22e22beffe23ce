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

  * `--devices N` / `--gpus N` (default -1: every visible GPU, as the JAX
    launcher's `--devices -1`; one process on the CPU): with N > 1 the
    command spawns N workers, one per GPU (NCCL), or N gloo processes with
    `--device cpu`; under `torchrun` (`RANK` / `WORLD_SIZE` set) each process
    is one rank as launched. `data.params.batch_size` is the GLOBAL batch,
    which N must divide; the LR rule counts the N devices.
    `--activate_ddp_share` (ZeRO-1: the optimizer moments of large leaves
    sharded over the ranks) and `--activate_fsdp` (also the f32 masters)
    run over the ranks there are, one included.

  * `--tp N` / `--sp N` / `--pp N [--pp_microbatches M]` (stage 2 only; one
    of them): the ranks split into groups of N consecutive ranks on one host
    for the model axis and dp groups across them (`train/stage2.py`); N
    must divide the ranks, with `--devices`, `torchrun` or alone. Refused as
    the JAX launcher refuses them: two model axes, an axis that does not
    divide the device count, the axes on stage 1, and `--pp_microbatches`
    without `--pp`; `--sp N` also needs the sequence to divide N (at p6c18
    T = 805, so `--sp 2` raises at the first step).
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
    p.add_argument("--devices", "--gpus", type=int, default=-1,
                   help="number of devices, one process each (-1 / 0: every visible GPU; "
                        "1 with --device cpu)")
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
    p.add_argument("--activate_ddp_share", action="store_true",
                   help="ZeRO-1: shard the optimizer moments of large leaves over the ranks")
    p.add_argument("--activate_fsdp", action="store_true",
                   help="FSDP: shard the moments and the f32 masters of large leaves")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree for the stage-2 transformer ((dp, tp) split; "
                        "composes with --activate_ddp_share / --activate_fsdp)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree for the stage-2 transformer ((dp, sp) split; "
                        "ring attention: the sequence length must divide sp)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel degree for the stage-2 content stack ((dp, pp) "
                        "split, GPipe microbatch schedule)")
    p.add_argument("--pp_microbatches", type=int, default=None,
                   help="GPipe microbatches per step under --pp (default 2; must divide the "
                        "batch)")
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


def device_count(devices: int, device) -> int:
    """The ranks `--devices` asks for: -1 / 0 every visible GPU on the card
    (the default device or "cuda"), else 1; N as given."""
    import torch

    if devices not in (-1, 0, None):
        return int(devices)
    if device in (None, "cuda") and torch.cuda.is_available():
        return max(torch.cuda.device_count(), 1)
    return 1


def _spawn(n: int, argv, logdir: str, device_type: str):
    """N worker processes, one rank each, over a process group on this host."""
    import torch.multiprocessing as mp

    from ..parallel.dist import free_port

    init = f"tcp://127.0.0.1:{free_port()}"
    mp.spawn(_worker, args=(n, init, list(argv), logdir, device_type), nprocs=n, join=True)


def _worker(rank, size, init_method, argv, logdir, device_type):
    from ..parallel import dist

    world = dist.init_world(device_type, rank, size, init_method)
    try:
        main(argv, world=world, logdir=logdir)
    finally:
        dist.shutdown()


def main(argv=None, world=None, logdir=None):
    """Run the trainer; returns the step object (`Stage2Trainer` or
    `Stage1Trainer`) in its final state (None in a process that spawned
    workers). `world`: this process's rank of a started process group
    (`parallel.dist.init_world`); `logdir`: the run directory a spawning
    parent chose."""
    import torch

    from ..parallel import dist
    from .stage2 import model_axis

    argv = list(sys.argv[1:] if argv is None else argv)
    parser = get_parser()
    opt, unknown = parser.parse_known_args(argv)
    dropped = [u for u in unknown if "=" not in u or u.startswith("-")]
    if dropped:  # only key.path=value overrides pass through; nothing is dropped in silence
        parser.error(f"unrecognized arguments: {' '.join(dropped)}")
    if opt.pp_microbatches is not None and opt.pp <= 1:
        parser.error("--pp_microbatches needs --pp > 1")
    axis = model_axis(opt.tp, opt.sp, opt.pp)
    device_type = torch.device(opt.device or "cuda").type
    own_world = False
    if world is None and dist.env_world_size() is not None:  # under torchrun
        world, own_world = dist.init_world(device_type), True
    n_devices = world.size if world is not None else device_count(opt.devices, opt.device)
    if world is not None and opt.devices not in (-1, 0, world.size):
        parser.error(f"--devices {opt.devices} but {world.size} ranks were launched")

    if logdir is None and opt.resume:
        logdir = opt.resume.rstrip("/")
    elif logdir is None:
        now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
        name = opt.name or (os.path.splitext(os.path.basename(opt.base[0]))[0]
                            if opt.base else "run")
        logdir = os.path.join(opt.logdir, f"{name}-{now}")
        if world is not None and world.size > 1:  # rank 0's name for every rank
            names = [logdir]
            torch.distributed.broadcast_object_list(names, src=0)
            logdir = names[0]
    if axis is not None:
        _check_axis(axis, opt, unknown, logdir, n_devices)
    if world is None and n_devices > 1:
        _write_snapshot(logdir, opt, argv, unknown)
        return _spawn(n_devices, argv, logdir, device_type)
    if world is None and (opt.activate_ddp_share or opt.activate_fsdp):
        world = dist.init_world(device_type, 0, 1, f"tcp://127.0.0.1:{dist.free_port()}")
        own_world = True
    try:
        return _train(opt, argv, unknown, logdir, world, n_devices)
    finally:
        if own_world:
            dist.shutdown()


def _check_axis(axis, opt, unknown, logdir, n_devices):
    """The JAX launcher's refusals of a model axis before any rank starts:
    stage 1, and an axis that does not divide the devices."""
    from ..config.yaml_config import load_config
    from .loop import STAGE1_AXES

    params = load_config(_base_configs(opt, logdir), unknown)["model"].get("params", {})
    if "transformer_config" not in params:
        raise ValueError(STAGE1_AXES)
    name, n = axis
    if n_devices % n:
        raise ValueError(f"--{name} {n} does not divide {n_devices} devices")


def _base_configs(opt, logdir):
    base_configs = list(opt.base)
    if opt.resume:
        cfg_dir = os.path.join(logdir, "configs")
        base_configs = [os.path.join(cfg_dir, f) for f in sorted(os.listdir(cfg_dir))
                        if f.endswith((".yml", ".yaml"))] + base_configs
    return base_configs


def _write_snapshot(logdir, opt, argv, unknown):
    """The merged config (`configs/merged-project.yaml`) and `argv.json`."""
    from ..config.yaml_config import dump_yaml, load_config

    config = load_config(_base_configs(opt, logdir), unknown)
    os.makedirs(os.path.join(logdir, "configs"), exist_ok=True)
    with open(os.path.join(logdir, "configs", "merged-project.yaml"), "w") as f:
        f.write(dump_yaml(config) + "\n")
    with open(os.path.join(logdir, "argv.json"), "w") as f:
        json.dump(["train"] + argv, f)
    return config


def _train(opt, argv, unknown, logdir, world, n_devices):
    import torch

    from ..config.yaml_config import load_config
    from ..utils.device import resolve_device
    from ..utils.instantiate import instantiate_from_config
    from .loop import Trainer

    if world is None or world.is_main:
        config = _write_snapshot(logdir, opt, argv, unknown)
    if world is not None:
        world.barrier()  # the snapshot is on disk before the other ranks read it
    if world is not None and not world.is_main:
        config = load_config(_base_configs(opt, logdir), unknown)

    device = resolve_device(opt.device) if world is None else world.device
    trainer = Trainer(
        logdir=logdir, max_epochs=opt.max_epochs, seed=opt.seed, save_top_k=opt.save_n,
        device=device, max_steps_per_epoch=opt.max_steps_per_epoch, resume=bool(opt.resume),
        accumulate_grad_batches=opt.accumulate_grad_batches,
        steps_per_dispatch=opt.steps_per_dispatch, cached_codes=opt.cached_codes,
        devices=n_devices, opt_sharding=opt.activate_ddp_share, fsdp=opt.activate_fsdp,
        tp=opt.tp, sp=opt.sp, pp=opt.pp, pp_microbatches=opt.pp_microbatches or 2,
        logtype=opt.logtype, log_every=opt.log_every,
        image_log_frequency=opt.image_log_every, stop_epoch=opt.stop_epoch,
        profile_steps=opt.profile_steps, world=world)
    with torch.device(device):
        model = instantiate_from_config(config["model"])
    data = instantiate_from_config(config["data"])
    set_learning_rate(model, config, opt.accumulate_grad_batches, n_devices)
    do_train = str(opt.train).lower() not in ("false", "0", "no")
    return trainer.fit(model, data, eval_only=not do_train)

