"""Tell apart the candidate causes of the campaign's stage-1 gap to the JAX
runs: the campaign's stage-1 leg (`tools/campaign_product.py`, the JAX
recipe: the shipped dual-grain entropy yml, f32, batch 8, 2 workers, K 4,
seed 23, the schedule of 6 epochs) stopped after its first epoch (384 steps,
`--stop_epoch 1`), run three ways, each a process of its own:

  * `tf32_on`: as the campaign ran it (PyTorch's default keeps cuDNN's TF32
    convolutions on);
  * `tf32_off`: the same with `NVIDIA_TF32_OVERRIDE=0`, which turns TF32 off
    in cuBLAS and cuDNN for the whole process;
  * `lpips_seed2`: TF32 on, with the LPIPS VGG16 backbone read from a file
    (`DQVQ_LPIPS_VGG`) drawn as flax's default from a second seed, so the
    backbone is another draw of the same distribution;
  * `lpips_jax`: TF32 on, with the JAX runs' own seeded backbone, read from
    the file `--jax_vgg` names (written where the JAX package is installed by
    `tests/fixtures/lpips/jax_campaign_vgg16.py`);
  * `jax_init`: the whole campaign stage-1 leg (all six epochs, no
    `--stop_epoch`) continued with `--resume` from a step-0 run directory
    that holds the JAX runs' own initial stage-1 state. `--jax_init` names
    either that run directory (written where the JAX package is installed by
    `tests/fixtures/stage1/jax_campaign_init.py`) or a file of model tensors
    (a state dict, whole or in part, written by the same script's `--carry`),
    from which the leg first writes the step-0 run itself
    (`write_initial_run`: the CLI's seeded init at `--seed` on this device,
    those tensors put in place).

  * `cpu_pair`: the leg's first 384 steps on the CPU at a cut width from
    the JAX package's initial state, step for step beside the JAX package's
    own run (`tests/fixtures/stage1/jax_cpu_pair.py`, which writes the
    state, the batches and its logs to `--pair`; the port reads them and
    takes every restart draw from `restart_draw`, as that run does). It
    writes `<out>/cpu_pair/metrics.jsonl` and holds it to the JAX run and to
    the JAX control run with one parameter tensor nudged by one ulp
    (`--pair_control`) by `pair_gaps` / `pair_decision`.

Each leg except `cpu_pair` reports the mean `train_p_loss` over its rows at steps 1-40 and
`val_rec_loss` at step 384, beside the JAX runs' (r04 / r05, read from the
committed `artifacts/campaign_r0{4,5}/stage1_metrics.jsonl` by the same
function). Usage (the card; ~2.5 min a leg):

    python -m dynamicvectorquantization_torch.tools.stage1_causes --out <dir> \\
        [--legs tf32_on,tf32_off,lpips_seed2,lpips_jax --jax_vgg <file>] \
        [--legs jax_init --jax_init <run dir | tensors.pt>] \
        [--data_root artifacts/campaign_r05/data]

writes `<dir>/causes.json` and prints it as its last line.

    python -m dynamicvectorquantization_torch.tools.stage1_causes --out <dir> \
        --legs cpu_pair --pair <JAX run dir> --pair_control <JAX control dir>
    python -m dynamicvectorquantization_torch.tools.stage1_causes \
        --pair_compare <dir>/cpu_pair/metrics.jsonl --pair <JAX run dir> \
        --pair_control <JAX control dir>

    python -m dynamicvectorquantization_torch.tools.stage1_causes \
        --compare <a stage-1 metrics.jsonl>

holds a run's stage-1 train rows to r04 / r05 step by step: per metric, the
first logged step whose value lies outside [min - d, max + d] of the two JAX
runs' values at that step, d = max(|r04 - r05|, 10 % of their mean) (the
rule of `PERF.md`'s campaign bands, applied per row), how many rows lie
outside, and the three runs' means over the windows ending at 40, 384, 768,
..., 2,304 steps; printed as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .campaign_product import REPO, STAGE1_BASE, THRESHOLDS_NAME, read_metrics, run

LEGS = ("tf32_on", "tf32_off", "lpips_seed2", "lpips_jax", "jax_init", "cpu_pair")
EARLY_STEPS = 40
JAX_RUNS = ("campaign_r04", "campaign_r05")


def early_p_loss(rows, last_step=EARLY_STEPS):
    """The mean `train_p_loss` of the train rows at steps 1..last_step."""
    vals = [r["train_p_loss"] for r in rows if r["split"] == "train" and r["step"] <= last_step]
    return sum(vals) / len(vals) if vals else None


def first_val(rows, key="val_rec_loss"):
    """(step, value) of the first validation row."""
    val = [r for r in rows if r["split"] == "val"]
    return (val[0]["step"], val[0][key]) if val else (None, None)


def summarize(rows):
    step, rec = first_val(rows)
    return {"train_p_loss_steps_1_40": early_p_loss(rows), "val_step": step,
            "val_rec_loss": rec}


COMPARED = ("train_rec_loss", "train_p_loss", "train_quant_loss", "train_g_loss",
            "train_d_weight", "train_disc_loss", "train_logits_real", "train_logits_fake",
            "train_aeloss", "train_fine_ratio")
WINDOWS = (40, 384, 768, 1152, 1536, 1920, 2304)


def _train_rows(rows):
    return {r["step"]: r for r in rows if r["split"] == "train"}


def outside(value, a, b):
    """Whether `value` lies outside the band of the JAX runs' `a`, `b`."""
    d = max(abs(a - b), 0.1 * abs(a + b) / 2)
    return value < min(a, b) - d or value > max(a, b) + d


def compare(rows, jax_rows):
    """{metric: {first_outside: [step, port, r04, r05] or None, n_outside,
    n_rows, windows: {end: [port, r04, r05] means}}} over the steps that all
    three runs logged."""
    port, (a, b) = _train_rows(rows), (_train_rows(r) for r in jax_rows)
    steps = sorted(set(port) & set(a) & set(b))
    out = {}
    for key in COMPARED:
        trio = [(s, port[s][key], a[s][key], b[s][key]) for s in steps]
        off = [t for t in trio if outside(*t[1:])]
        windows = {}
        for lo, hi in zip((0,) + WINDOWS, WINDOWS):
            sel = [t[1:] for t in trio if lo < t[0] <= hi]
            if sel:
                windows[hi] = [sum(v[i] for v in sel) / len(sel) for i in range(3)]
        out[key] = {"first_outside": list(off[0]) if off else None, "n_outside": len(off),
                    "n_rows": len(trio), "windows": windows}
    return out


def restart_draw(step: int, pool_rows: int, noise_shape=None):
    """(jitter in [0, 1) of `noise_shape` or None, a permutation of
    `pool_rows`): the codebook restart's draw at `step` (from 1), which the
    `cpu_pair` leg and the JAX run it is held to both take."""
    rng = np.random.default_rng([23, step])
    perm = rng.permutation(pool_rows)
    noise = None if noise_shape is None else rng.random(noise_shape, dtype=np.float32)
    return noise, perm


# the one-step parity tolerances of tests/test_torch_stage1_train.py (logs at
# its first and second step), held at steps 1 and 2-4
PAIR_EARLY_RTOL = (1e-5, 2e-4, 2e-4, 2e-4)
# logs the rule reads: every compared log but the quantisation loss, whose JAX
# value is XLA's f32 mean of the 4-D commitment term, on the CPU ~1e-5 of its
# value away from the f64 mean at these sizes (tests/test_torch_f14_pair.py;
# the port's torch mean 1e-7): an offset of the log, not of the run
PAIR_KEYS = tuple(k for k in COMPARED if k != "train_quant_loss")
PAIR_ATOL = 1e-6
PAIR_ENVELOPE = 10.0


def pair_gaps(rows, ref_rows, keys=COMPARED):
    """{step: the largest relative gap |a - b| / max(|b|, 1e-6) over `keys`}
    of two runs' train rows, over the steps both logged."""
    a, b = _train_rows(rows), _train_rows(ref_rows)
    out = {}
    for s in sorted(set(a) & set(b)):
        out[s] = max(abs(a[s][k] - b[s][k]) / max(abs(b[s][k]), 1e-6) for k in keys
                     if k in a[s] and k in b[s])
    return out


def pair_decision(port_rows, jax_rows, control_rows):
    """The rule of F14's CPU leg, over `PAIR_KEYS`: the port's first four
    steps within the parity tolerances of the JAX run's, and from step 5 on
    the port's gap to the JAX run within `PAIR_ENVELOPE` times the control's
    (a running maximum of each, so one quiet step of the control does not
    decide).
    {"early_ok", "first_outside": step or None, "verdict"}."""
    a, b = _train_rows(port_rows), _train_rows(jax_rows)
    early_ok = True
    for s, rtol in enumerate(PAIR_EARLY_RTOL, start=1):
        if s not in a or s not in b:
            early_ok = False
            continue
        for k in PAIR_KEYS:
            if abs(a[s][k] - b[s][k]) > PAIR_ATOL + rtol * abs(b[s][k]):
                early_ok = False
    port = pair_gaps(port_rows, jax_rows, PAIR_KEYS)
    control = pair_gaps(control_rows, jax_rows, PAIR_KEYS)
    first, run_p, run_c = None, 0.0, 0.0
    for s in sorted(set(port) & set(control)):
        run_p, run_c = max(run_p, port[s]), max(run_c, control[s])
        if s > len(PAIR_EARLY_RTOL) and run_p > PAIR_ENVELOPE * run_c and first is None:
            first = s
    verdict = "draw difference" if early_ok and first is None else "fault located"
    return {"early_ok": early_ok, "first_outside": first, "verdict": verdict}


PAIR_REPORT_STEPS = (1, 2, 3, 4, 5, 6, 7, 8, 16, 32, 64, 128, 192, 256, 320, 384)


def pair_report(port_rows, jax_rows, control_rows):
    """The decision (`pair_decision`), the gaps of the port and of the
    control to the JAX run at `PAIR_REPORT_STEPS` over `PAIR_KEYS` and over
    every compared log, the largest ratio of their running maxima after step
    4, and each run's validation row."""
    port, control = (pair_gaps(r, jax_rows, PAIR_KEYS) for r in (port_rows, control_rows))
    port_all, control_all = (pair_gaps(r, jax_rows) for r in (port_rows, control_rows))
    ratio, run_p, run_c = {}, 0.0, 0.0
    for s in sorted(set(port) & set(control)):
        run_p, run_c = max(run_p, port[s]), max(run_c, control[s])
        ratio[s] = run_p / run_c if run_c else float("inf")
    late = {s: r for s, r in ratio.items() if s > len(PAIR_EARLY_RTOL)}
    worst = max(late, key=late.get) if late else None

    def val(rows):
        return next((r for r in rows if r["split"] == "val"), None)

    return {"decision": pair_decision(port_rows, jax_rows, control_rows),
            "gaps": {s: {"port": port[s], "control": control[s], "port_all_logs": port_all[s],
                         "control_all_logs": control_all[s], "running_ratio": ratio[s]}
                     for s in PAIR_REPORT_STEPS if s in port and s in control},
            "worst_running_ratio_after_step_4": [worst, late.get(worst)],
            "val": {"port": val(port_rows), "jax": val(jax_rows), "control": val(control_rows)}}


def run_cpu_pair(pair_dir, out_dir):
    """The port's half of the `cpu_pair` leg (the module docstring): returns
    its rows, also written to `<out_dir>/metrics.jsonl`."""
    import torch

    from ..train.stage1 import Stage1Trainer
    from ..utils.instantiate import instantiate_from_config
    from ..utils.weights import load_stage1_state

    with open(os.path.join(pair_dir, "config.json")) as f:
        config = json.load(f)
    batches = np.load(os.path.join(pair_dir, "batches.npy"), mmap_mode="r")
    val = np.load(os.path.join(pair_dir, "val.npy"))
    steps = batches.shape[0]
    model = instantiate_from_config(config["model"])
    trainer = Stage1Trainer(model, PAIR_LR, warmup_steps=PAIR_WARMUP, max_steps=PAIR_MAX_STEPS,
                            device="cpu")
    load_stage1_state(trainer, torch.load(os.path.join(pair_dir, "step0.pt"),
                                          weights_only=False))
    current = {}

    def draw(pool_rows, noise_shape, generator, device):
        noise, perm = restart_draw(current["step"], pool_rows, noise_shape)
        return (None if noise is None else torch.from_numpy(noise)), torch.from_numpy(perm)

    model.quantize._draw_restart = draw
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    with open(os.path.join(out_dir, "metrics.jsonl"), "w") as f:
        t0 = time.time()
        for i in range(steps):
            current["step"] = i + 1
            logs = trainer.train_step(torch.from_numpy(np.array(batches[i])),
                                      torch.Generator().manual_seed(i))
            rows.append({"step": i + 1, "split": "train",
                         **{k: float(v) for k, v in logs.items()}})
            f.write(json.dumps(rows[-1]) + "\n")
            f.flush()
            if (i + 1) % 32 == 0:
                print(f"cpu_pair step {i + 1}: {time.time() - t0:.1f} s", flush=True)
        with torch.no_grad():
            outs = [trainer.eval_step(torch.from_numpy(x)) for x in val]
        rows.append({"step": steps, "split": "val",
                     **{k: float(np.mean([float(o[k]) for o in outs])) for k in outs[0]}})
        f.write(json.dumps(rows[-1]) + "\n")
    return rows


# the campaign's stage-1 schedule: lr 8 x 4.5e-6, warm-up int(0.1 x 384)
# steps, 6 epochs of 384 steps
PAIR_LR, PAIR_WARMUP, PAIR_MAX_STEPS = 8 * 4.5e-6, 38, 2304


def _read_rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def write_vgg16(path, seed):
    """A torchvision `vgg16` state dict of the 13 feature convs, drawn as
    `nn/lpips.py` draws its seeded backbone (flax's lecun-normal, zero
    bias), from `seed`."""
    import torch

    from ..nn.lpips import LPIPS

    lp = LPIPS()
    lp.init_weights(torch.Generator().manual_seed(seed))
    sd = {}
    for slice_ in lp.net.children():
        for idx, mod in slice_.named_children():
            if isinstance(mod, torch.nn.Conv2d):
                sd[f"features.{idx}.weight"] = mod.weight.detach().clone()
                sd[f"features.{idx}.bias"] = mod.bias.detach().clone()
    torch.save(sd, path)


def write_initial_run(run_dir, base, overrides, seed, tensors=None, device=None):
    """A run directory that `train.cli --resume` continues, holding the
    configs snapshot and a checkpoint of step 0: the state the CLI's
    stage-1 run starts from at `seed` on `device` (the seeded init,
    ActNorm from the first training image, zero moments, as
    `train/loop.py` `_fit_stage1` builds it) with the model tensors of
    `tensors` (a state dict, whole or in part) put in place. The checkpoint
    carries no generator state: the resumed trainer keeps its freshly
    seeded one, as a run from scratch does at step 0. Returns the
    checkpoint's path."""
    import torch

    from ..config.yaml_config import dump_yaml, load_config
    from ..train.cli import set_learning_rate
    from ..train.stage1 import Stage1Trainer
    from ..utils.checkpoint import CheckpointManager
    from ..utils.device import resolve_device
    from ..utils.instantiate import instantiate_from_config

    config = load_config(list(base), list(overrides))
    os.makedirs(os.path.join(run_dir, "configs"), exist_ok=True)
    with open(os.path.join(run_dir, "configs", "merged-project.yaml"), "w") as f:
        f.write(dump_yaml(config) + "\n")
    dev = resolve_device(device)
    with torch.device(dev):
        model = instantiate_from_config(config["model"])
    data = instantiate_from_config(config["data"])
    set_learning_rate(model, config, 1)
    trainer = Stage1Trainer(model, model.learning_rate, device=dev, seed=seed + 1)
    batches = data.train_dataloader(seed=seed).epoch(0)
    x0 = next(batches)[model.image_key][:1]
    batches.close()
    trainer.init_state(torch.Generator(device=dev).manual_seed(int(seed)), x0)
    tensors = dict(tensors or {})
    own = model.state_dict()
    unknown = sorted(set(tensors) - set(own))
    if unknown:
        raise KeyError(f"tensors the model does not hold: {unknown[:5]}")
    with torch.no_grad():
        for k, v in tensors.items():
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)}, the model's {tuple(own[k].shape)}")
            own[k].copy_(v)
    state = trainer.state_dict()
    state.pop("generator")
    mngr = CheckpointManager(os.path.join(run_dir, "checkpoints"), monitor=model.monitor)
    path = mngr.save(0, {"stage": 1, "trainer": state})
    mngr.wait()
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="the legs' directory (required to run legs)")
    p.add_argument("--legs", default=",".join(LEGS[:3]))
    p.add_argument("--jax_vgg", default=None, help="the JAX runs' backbone (leg lpips_jax)")
    p.add_argument("--jax_init", default=None,
                   help="leg jax_init: a step-0 run directory, or a file of model tensors")
    p.add_argument("--pair", default=None,
                   help="leg cpu_pair: the JAX run directory of tests/fixtures/stage1/jax_cpu_pair.py")
    p.add_argument("--pair_control", default=None,
                   help="leg cpu_pair: the JAX control run (one tensor nudged by one ulp)")
    p.add_argument("--pair_compare", default=None,
                   help="a cpu_pair metrics.jsonl: print `pair_report` against --pair and "
                        "--pair_control (no leg runs)")
    p.add_argument("--data_root", default="artifacts/campaign_r05/data")
    p.add_argument("--thresholds", default=os.path.join("artifacts/campaign_r05/thresholds",
                                                        THRESHOLDS_NAME))
    p.add_argument("--device", default=None)
    p.add_argument("--compare", default=None,
                   help="a stage-1 metrics.jsonl to hold to r04 / r05 step by step (no leg runs)")
    opt = p.parse_args(argv)
    if opt.pair_compare:
        rows = [_read_rows(path) for path in (
            opt.pair_compare, os.path.join(opt.pair, "metrics.jsonl"),
            os.path.join(opt.pair_control, "metrics.jsonl"))]
        print(json.dumps(pair_report(*rows)), flush=True)
        return 0
    if opt.compare:
        jax_rows = []
        for name in JAX_RUNS:
            with open(os.path.join(REPO, "artifacts", name, "stage1_metrics.jsonl")) as f:
                jax_rows.append([json.loads(line) for line in f])
        with open(opt.compare) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        print(json.dumps(compare(rows, jax_rows)), flush=True)
        return 0
    if not opt.out:
        p.error("--out is required to run legs")
    out = os.path.abspath(opt.out)
    os.makedirs(out, exist_ok=True)
    dev = ["--device", opt.device] if opt.device else []
    base_env = {"DQVQ_IMAGENET_ROOT": os.path.abspath(opt.data_root)}
    result = {"legs": {}, "jax": {}}
    for name in JAX_RUNS:
        with open(os.path.join(REPO, "artifacts", name, "stage1_metrics.jsonl")) as f:
            result["jax"][name] = summarize([json.loads(line) for line in f])
    for leg in opt.legs.split(","):
        if leg not in LEGS:
            raise SystemExit(f"unknown leg {leg!r}; legs: {', '.join(LEGS)}")
        if leg == "cpu_pair":
            result["legs"][leg] = _cpu_pair_leg(opt, out)
            continue
        env = dict(base_env)
        if leg == "tf32_off":
            env["NVIDIA_TF32_OVERRIDE"] = "0"
        if leg == "lpips_seed2":
            vgg = os.path.join(out, "vgg16_seed2.pt")
            write_vgg16(vgg, seed=2)
            env["DQVQ_LPIPS_VGG"] = vgg
        if leg == "lpips_jax":
            if not opt.jax_vgg:
                raise SystemExit("leg lpips_jax needs --jax_vgg")
            env["DQVQ_LPIPS_VGG"] = os.path.abspath(opt.jax_vgg)
        logroot = os.path.join(out, "logs")
        overrides = ["model.params.encoderconfig.params.router_config.params.json_path="
                     f"{os.path.abspath(opt.thresholds)}", "data.params.batch_size=8",
                     "data.params.num_workers=2"]
        common = ["--max_epochs", "6", "--log_every", "8", "--steps_per_dispatch", "4",
                  "--seed", "23", "--image_log_every", "0", *dev]
        t0 = time.time()
        if leg == "jax_init":
            rundir = _jax_init_run(opt.jax_init, os.path.join(logroot, "jax_init-step0"),
                                   overrides, opt.device, env)
            run([sys.executable, "-m", "dynamicvectorquantization_torch.train", "--resume",
                 rundir, *common, *overrides], env, leg, retries=0)
        else:
            run([sys.executable, "-m", "dynamicvectorquantization_torch.train", "--base",
                 *STAGE1_BASE, "--stop_epoch", "1", "--name", leg, "--logdir", logroot, *common,
                 *overrides], env, leg, retries=0)
            rundir = os.path.join(logroot, sorted(d for d in os.listdir(logroot)
                                                  if d.startswith(f"{leg}-"))[-1])
        result["legs"][leg] = {**summarize(read_metrics(rundir)),
                               "seconds": time.time() - t0, "env": env, "run": rundir}
    with open(os.path.join(out, "causes.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


def _cpu_pair_leg(opt, out):
    if not opt.pair:
        raise SystemExit("leg cpu_pair needs --pair")
    t0 = time.time()
    rows = run_cpu_pair(opt.pair, os.path.join(out, "cpu_pair"))
    result = {**summarize(rows), "seconds": time.time() - t0}
    jax_rows = _read_rows(os.path.join(opt.pair, "metrics.jsonl"))
    result["jax"] = summarize(jax_rows)
    if opt.pair_control:
        control = _read_rows(os.path.join(opt.pair_control, "metrics.jsonl"))
        result["control"] = summarize(control)
        result["decision"] = pair_decision(rows, jax_rows, control)
    return result


def _jax_init_run(source, step0_dir, overrides, device, env):
    """The step-0 run directory of leg `jax_init`: `source` itself when it is
    a run directory, else one written from the tensors in the file `source`
    (with the leg's environment, which names the data)."""
    if not source:
        raise SystemExit("leg jax_init needs --jax_init")
    source = os.path.abspath(source)
    if os.path.isdir(source):
        return source
    import torch

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        write_initial_run(step0_dir, [os.path.join(REPO, STAGE1_BASE[0])], overrides, 23,
                          torch.load(source, map_location="cpu", weights_only=True), device)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return step0_dir


if __name__ == "__main__":
    sys.exit(main())
