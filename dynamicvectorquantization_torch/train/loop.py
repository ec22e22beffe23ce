"""Epoch training loop on one device (counterpart of
`dynamicvectorquantization_tpu/train/loop.py` `Trainer`).

Per step one `Stage2Trainer.train_step` / `Stage1Trainer.train_step`, periodic
metric rows under the reference metric names, PNG image grids every
`image_log_frequency` steps, a validation pass and a checkpoint each epoch
(the `save_top_k` best by the model's monitored metric plus the newest),
resume from the newest checkpoint, and a guard that turns SIGTERM / SIGUSR1
into an emergency checkpoint and a clean return.

Stage 2 trains on cached codes by default: each epoch's batches go once
through the frozen first stage (`_encode_epoch_codes`, int16 streams on the
host) and the steps consume token streams. Metric rows are flushed one step
late, when the next step is already queued, so logging adds no device sync to
a step.

A resumed run repeats the uninterrupted one: data order and augmentation are
functions of (seed, epoch, batch, example), dropout of (seed, step,
microbatch, layer), and a checkpoint holds the whole trainer state.

Stage-2 validation and image grids run on the trainer's f32 masters, as the
JAX loop's run on `state.params`. `profile_steps` writes a `torch.profiler`
trace of a fresh run's first steps into `<logdir>/profile/`.

What the JAX loop does over a device mesh is not ported: `devices > 1`,
`opt_sharding` (ZeRO-1), `fsdp`, `tp` / `sp` / `pp` and `steps_per_dispatch >
1` raise and name their ROADMAP.md item. Checkpoints are written
synchronously with `torch.save`.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from ..data.pipeline import device_prefetch
from ..utils.checkpoint import CheckpointManager
from ..utils.device import resolve_device
from ..utils.logging import ImageLogger, MetricLogger, draw_grain_map_color
from ..utils.model_loading import load_first_stage
from .stage1 import Stage1Trainer
from .stage2 import Stage2Trainer

MULTI_GPU_ITEM = "ROADMAP.md item 10.3, Multi-GPU: DDP, ZeRO-1, FSDP, tp / sp / pp"
DISPATCH_ITEM = "ROADMAP.md item 10.2, steps_per_dispatch as a CUDA graph of the step"


def _is_stage2(model) -> bool:
    return hasattr(model, "transformer") and hasattr(model, "first_stage_model")


def _add(buckets, key, t0):
    buckets[key] = buckets.get(key, 0.0) + time.perf_counter() - t0


class PreemptionGuard:
    """Installs SIGTERM / SIGUSR1 handlers for the duration of a fit. When the
    runtime signals shutdown the loop finishes the step in flight, saves an
    emergency checkpoint and returns; a resume then continues mid-epoch
    state instead of rewinding to the last epoch boundary."""

    def __init__(self):
        self._hit: Optional[str] = None
        self._prev = {}

    def __enter__(self):
        try:
            for sig in (signal.SIGTERM, signal.SIGUSR1):
                self._prev[sig] = signal.signal(sig, self._on_signal)
        except ValueError:
            pass  # not in the main thread: stays a no-op
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False

    def _on_signal(self, signum, frame):
        self._hit = signal.Signals(signum).name

    @property
    def should_stop(self) -> bool:
        return self._hit is not None

    @property
    def reason(self) -> Optional[str]:
        return self._hit


class _LaggedLogs:
    """Metric rows written one step late: `push` stacks a step's 0-d log
    tensors on the device and first writes the row pushed before it, whose
    values are ready by then, so reading them does not drain the queue."""

    def __init__(self, metrics: MetricLogger, schedule, buckets):
        self.metrics, self.schedule, self.buckets = metrics, schedule, buckets
        self.pending = None

    def push(self, step, logs, images_per_sec, extra):
        keys = sorted(logs)
        packed = torch.stack([logs[k].detach().float() for k in keys])
        self.flush()
        self.pending = (step, keys, packed, images_per_sec, extra)

    def flush(self):
        if self.pending is None:
            return
        t0 = time.perf_counter()
        step, keys, packed, ips, extra = self.pending
        self.pending = None
        row = dict(zip(keys, packed.tolist()))  # one device -> host copy
        row["lr"] = self.schedule(step)
        row["images_per_sec"] = ips
        row.update(extra)
        self.metrics.log(step, row, "train")
        _add(self.buckets, "log_sync", t0)


class Trainer:
    def __init__(self, logdir: str, max_epochs: int = 1, seed: int = 23, log_every: int = 50,
                 image_log_frequency: int = 50, save_top_k: int = 3, device=None,
                 max_steps_per_epoch: Optional[int] = None, resume: bool = True,
                 accumulate_grad_batches: int = 1, steps_per_dispatch: Optional[int] = None,
                 cached_codes: str = "auto", devices: int = 1, opt_sharding: bool = False,
                 fsdp: bool = False, tp: int = 1, sp: int = 1, pp: int = 1,
                 logtype: str = "csv", init_weights: bool = True,
                 stop_epoch: Optional[int] = None, profile_steps: int = 0):
        if devices not in (-1, 0, 1, None) or opt_sharding or fsdp or max(tp, sp, pp) > 1:
            raise NotImplementedError(
                f"training over several devices is not ported (see {MULTI_GPU_ITEM})")
        if steps_per_dispatch not in (None, 1):
            raise NotImplementedError(
                f"steps_per_dispatch > 1 is not ported (see {DISPATCH_ITEM})")
        if cached_codes not in ("auto", "on", "off"):
            raise ValueError(f"cached_codes must be auto, on or off, got {cached_codes!r}")
        self.logdir = logdir
        self.max_epochs = max_epochs
        self.seed = seed
        self.log_every = log_every
        self.save_top_k = save_top_k
        self.device = resolve_device(device)
        self.max_steps_per_epoch = max_steps_per_epoch
        self.resume = resume
        # each optimizer step consumes `accum` loader batches, stacked to
        # (accum, B, ...); a trailing incomplete group is dropped
        self.accum = int(accumulate_grad_batches)
        self.cached_codes = cached_codes
        # False: train from the weights the model was given (tests carry a
        # state across from the JAX package this way)
        self.init_weights = init_weights
        # end this run once `stop_epoch` epochs are done, with the schedules
        # still laid out for `max_epochs`: a job with a time limit that a
        # later `resume` continues exactly
        self.stop_epoch = stop_epoch
        # a torch.profiler trace of the first `profile_steps` optimizer steps
        # of a fresh run into <logdir>/profile, as the JAX loop's jax.profiler
        self.profile_steps = int(profile_steps or 0)
        self._profiler = None
        os.makedirs(logdir, exist_ok=True)
        self.metrics = MetricLogger(logdir, logtype=logtype)
        self.images = ImageLogger(logdir, batch_frequency=image_log_frequency)

    # ------------------------------------------------------------- helpers
    def _generator(self, seed):
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _group_microbatches(self, gen):
        """Pass-through at accum = 1, else groups of `accum` consecutive
        items stacked on the host to (accum, B, ...)."""
        if self.accum == 1:
            yield from gen
            return
        buf = []
        for item in gen:
            buf.append(item)
            if len(buf) == self.accum:
                if isinstance(item, dict):
                    yield {k: np.stack([b[k] for b in buf]) for k in item}
                else:
                    yield np.stack(buf)
                buf = []

    def _ckpt_manager(self, monitor):
        return CheckpointManager(os.path.join(self.logdir, "checkpoints"), self.save_top_k,
                                 monitor)

    def _emergency_save(self, mngr, step, state, reason):
        try:
            mngr.save(step, state)
            print(f"[preempt:{reason}] emergency checkpoint saved at step {step}")
        except Exception as e:  # never mask the shutdown on a save failure
            print(f"[preempt:{reason}] emergency save FAILED: {e}")

    def _maybe_profile(self, global_step: int, end: bool = False):
        """Start the trace before step 0 of a fresh run; stop it and write
        `<logdir>/profile/trace.json` once `profile_steps` steps are done (or
        the run ends first)."""
        if not self.profile_steps:
            return
        if self._profiler is None and global_step == 0 and not end:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()
        elif self._profiler is not None and (end or global_step >= self.profile_steps):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._profiler.stop()
            out = os.path.join(self.logdir, "profile")
            os.makedirs(out, exist_ok=True)
            self._profiler.export_chrome_trace(os.path.join(out, "trace.json"))
            self._profiler = None
            print(f"profiler trace written to {out}")

    def _write_buckets(self, buckets, wall, gs):
        """Host-loop attribution -> <logdir>/loop_buckets.json. "device_wait"
        is the wall time no measured host bucket accounts for: where the host
        waits for (or runs ahead of) the device."""
        accounted = sum(v for k, v in buckets.items() if k != "transfer")  # part of "pull"
        out = {"wall_seconds": round(wall, 3), "global_step": gs,
               "buckets": {k: round(v, 3) for k, v in sorted(buckets.items())},
               "device_wait_seconds": round(max(wall - accounted, 0.0), 3)}
        with open(os.path.join(self.logdir, "loop_buckets.json"), "w") as f:
            json.dump(out, f, indent=1)

    def _mean_over(self, loader, key, eval_step):
        """Mean of `eval_step`'s logs over the validation batches, summed on
        the device with one host sync at the end."""
        acc, n = None, 0
        for bi, batch in enumerate(device_prefetch(loader.epoch(0), self.device)):
            if self.max_steps_per_epoch and bi >= self.max_steps_per_epoch:
                break
            logs = eval_step(batch[key])
            acc = logs if acc is None else {k: acc[k] + v for k, v in logs.items()}
            n += 1
        if acc is None:
            return {}
        keys = sorted(acc)
        values = (torch.stack([acc[k].float() for k in keys]) / n).tolist()
        return dict(zip(keys, values))

    # ------------------------------------------------------------------ fit
    def fit(self, model, data, eval_only: bool = False):
        train_loader = data.train_dataloader(seed=self.seed)
        steps_per_epoch = len(train_loader)
        if self.max_steps_per_epoch:
            steps_per_epoch = min(steps_per_epoch, self.max_steps_per_epoch)
        model.steps_per_epoch = steps_per_epoch
        model.training_steps = max(steps_per_epoch * self.max_epochs, 1)
        warmup_steps = int(steps_per_epoch * (model.warmup_epochs or 0))
        fit = self._fit_stage2 if _is_stage2(model) else self._fit_stage1
        return fit(model, data, train_loader, warmup_steps, eval_only=eval_only)

    def _run_epochs(self, trainer, mngr, state_fn, schedule, epoch_inputs, step_fn, validate,
                    log_images, global_step, batch_size_of):
        """The epoch loop both stages share. `epoch_inputs(epoch, buckets)` ->
        (iterator of step inputs, extra columns for the epoch's first row);
        `state_fn()` -> the checkpoint's content."""
        gs = global_step
        buckets = {}
        t_fit = time.perf_counter()
        with PreemptionGuard() as guard:
            for epoch in range(trainer.epoch, min(self.max_epochs,
                                                  self.stop_epoch or self.max_epochs)):
                inputs, first_row_extra = epoch_inputs(epoch, buckets)
                lagged = _LaggedLogs(self.metrics, schedule, buckets)
                t0 = time.time()
                it = iter(inputs)
                bi = -1
                while True:
                    t_p = time.perf_counter()
                    try:
                        x = next(it)
                    except StopIteration:
                        break
                    _add(buckets, "pull", t_p)
                    bi += 1
                    if self.max_steps_per_epoch and bi >= self.max_steps_per_epoch:
                        break
                    self._maybe_profile(gs)
                    t_d = time.perf_counter()
                    logs = step_fn(x)
                    _add(buckets, "dispatch", t_d)
                    gs += 1
                    lagged.flush()
                    self._maybe_profile(gs)
                    if guard.should_stop:
                        self._maybe_profile(gs, end=True)
                        self._emergency_save(mngr, gs, state_fn(), guard.reason)
                        return trainer
                    if bi % self.log_every == 0:
                        ips = (self.accum * batch_size_of(x) * (bi + 1)
                               / max(time.time() - t0, 1e-9))
                        lagged.push(gs, logs, ips, first_row_extra if bi == 0 else {})
                    if self.images.should_log(bi):
                        t_i = time.perf_counter()
                        log_images(x, gs, epoch, bi)
                        _add(buckets, "image_log", t_i)
                if hasattr(it, "close"):
                    it.close()  # stops the loader's thread when the epoch was capped
                lagged.flush()
                trainer.epoch += 1

                t_v = time.perf_counter()
                val_metrics = validate()
                self.metrics.log(gs, val_metrics, "val")
                _add(buckets, "validate", t_v)
                t_c = time.perf_counter()
                mngr.save(gs, state_fn(), metrics=val_metrics)
                _add(buckets, "checkpoint", t_c)
                print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in val_metrics.items()),
                      flush=True)
        self._maybe_profile(gs, end=True)
        self._write_buckets(buckets, time.perf_counter() - t_fit, gs)
        return trainer

    # --------------------------------------------------------------- stage 1
    def _fit_stage1(self, model, data, train_loader, warmup_steps, eval_only=False):
        trainer = Stage1Trainer(
            model, learning_rate=model.learning_rate,
            min_learning_rate=getattr(model, "min_learning_rate", 0.0),
            warmup_steps=warmup_steps, max_steps=model.training_steps, accum=self.accum,
            device=self.device, seed=self.seed + 1)
        trainer.init_state(self._generator(self.seed) if self.init_weights else None)

        mngr = self._ckpt_manager(model.monitor)
        if self.resume and mngr.latest() is not None:
            trainer.load_state_dict(mngr.restore(map_location=self.device)["trainer"])
            print(f"Resumed from checkpoint step {mngr.latest()}")

        def validate():
            return self._validate_stage1(model, data, trainer)

        if eval_only:
            val_metrics = validate()
            self.metrics.log(trainer.step, val_metrics, "val")
            print("eval: " + " ".join(f"{k}={v:.4f}" for k, v in val_metrics.items()))
            return trainer

        def epoch_inputs(epoch, buckets):
            batches = (b[model.image_key] for b in train_loader.epoch(epoch))
            return device_prefetch(self._group_microbatches(batches), self.device,
                                   timings=buckets), {}

        def log_images(x, gs, epoch, bi):
            self._log_stage1_images(model, x if self.accum == 1 else x[0], "train", gs, epoch, bi)

        return self._run_epochs(
            trainer, mngr, lambda: {"stage": 1, "trainer": trainer.state_dict()},
            trainer.ae_opt.schedule, epoch_inputs, trainer.train_step, validate, log_images,
            trainer.step, lambda x: x.shape[-4])

    def _validate_stage1(self, model, data, trainer):
        return self._mean_over(data.val_dataloader(seed=self.seed), model.image_key,
                               trainer.eval_step)

    @torch.no_grad()
    def _log_stage1_images(self, model, x, split, gs, epoch, bi):
        x = x[:4].float()
        xrec, _, grains, _, x_entropy = model(x)
        x_np = x.cpu().numpy()
        imgs = {"inputs": x_np, "reconstructions": xrec.cpu().numpy(),
                "grain_map": draw_grain_map_color(x_np, grains.cpu().numpy())}
        if x_entropy is not None:
            e = x_entropy.cpu().numpy()
            e = (e - e.min()) / max(e.max() - e.min(), 1e-5)
            imgs["entropy_map"] = draw_grain_map_color(x_np, e)
        self.images.log(imgs, split, gs, epoch, bi)

    # --------------------------------------------------------------- stage 2
    def _fit_stage2(self, model, data, train_loader, warmup_steps, eval_only=False):
        use_cached = self.cached_codes == "on" or (
            self.cached_codes == "auto" and self.accum == 1)
        if use_cached and self.accum != 1:
            raise ValueError("--cached_codes on requires accumulate_grad_batches=1")
        # cached token streams carry image codes only; any other conditioning
        # would silently train without its condition
        if use_cached and model.cond_stage_key != "image":
            if self.cached_codes == "on":
                raise ValueError(
                    "--cached_codes on supports image conditioning only "
                    f"(cond_stage_key={model.cond_stage_key!r})")
            print(f"cached_codes auto: OFF (cond_stage_key={model.cond_stage_key!r} needs "
                  "per-step conditioning)")
            use_cached = False

        # weights before the trainer takes its f32 masters from them: the
        # first stage from its config's ckpt_path where that exists, else
        # seeded; the transformer seeded
        model.to(self.device)
        if self.init_weights:
            model.transformer.init_weights(self._generator(self.seed))
            fs = model.first_stage_model
            if fs.ckpt_path and os.path.exists(str(fs.ckpt_path)):
                load_first_stage(fs, str(fs.ckpt_path))
            else:
                fs.init_weights(self._generator(self.seed + 5))
        trainer = Stage2Trainer(
            model, learning_rate=model.learning_rate,
            min_learning_rate=getattr(model, "min_learning_rate", 0.0),
            warmup_steps=warmup_steps, max_steps=model.training_steps, accum=self.accum,
            compute_dtype=model.compute_dtype, device=self.device, seed=self.seed + 1)

        mngr = self._ckpt_manager(model.monitor)
        if self.resume and mngr.latest() is not None:
            state = mngr.restore(map_location=self.device)
            trainer.load_state_dict(state["trainer"])
            model.first_stage_model.load_state_dict(state["first_stage"])
            trainer.refresh_first_stage()
            print(f"Resumed from checkpoint step {mngr.latest()}")

        def validate():
            return self._validate_stage2(model, data, trainer)

        if eval_only:
            val_metrics = validate()
            self.metrics.log(trainer.count, val_metrics, "val")
            print("eval: " + " ".join(f"{k}={v:.4f}" for k, v in val_metrics.items()))
            return trainer

        vis = {}

        def epoch_inputs(epoch, buckets):
            if not use_cached:
                batches = (b[model.first_stage_key]
                           for b in train_loader.epoch(epoch))
                return device_prefetch(self._group_microbatches(batches), self.device,
                                       timings=buckets), {}
            t_enc = time.perf_counter()
            cached, vis["x"] = self._encode_epoch_codes(model, trainer, train_loader, epoch)
            enc_secs = time.perf_counter() - t_enc
            buckets["encode"] = buckets.get("encode", 0.0) + enc_secs
            return (device_prefetch(iter(cached), self.device, timings=buckets),
                    {"cache_encode_seconds": enc_secs})

        def log_images(x, gs, epoch, bi):
            x_img = vis["x"] if use_cached else (x if self.accum == 1 else x[0])
            with trainer.master_weights():
                self._log_stage2_images(model, x_img, "train", gs, epoch, bi)

        def batch_size_of(x):
            leaf = next(iter(x.values())) if isinstance(x, dict) else x
            return leaf.shape[1 if self.accum > 1 else 0]

        def state_fn():
            return {"stage": 2, "trainer": trainer.state_dict(),
                    "first_stage": model.first_stage_model.state_dict()}

        return self._run_epochs(trainer, mngr, state_fn, trainer.schedule, epoch_inputs,
                                trainer.train_step, validate, log_images, trainer.count,
                                batch_size_of)

    @torch.no_grad()
    def _encode_epoch_codes(self, model, trainer, train_loader, epoch):
        """Cached-codes pre-encode: one pass of the trainer's training encode
        (`Stage2Trainer.encode`: the frozen first stage in the trainer's
        compute dtype, the JAX loop's `make_encode_fn`) over this epoch's
        (augmented) batches, giving one permuter-stream dict per batch. The
        streams are held on the host as int16 when every token id fits (the
        largest is 1026 at the shipped geometry, ~5 KB an image), else int32.
        Returns (the list of stream dicts, the first batch's first 4 images
        for the image logger). The host copy of a batch is made after the
        next batch's encode is queued."""
        max_id = max(model.vocab_size, model.fine_position_size,
                     model.coarse_position_pad_code, model.coarse_position_eos_code,
                     model.content_pad_code, model.content_eos_code,
                     model.content_sos_code or 0, model.fine_position_sos_code or 0)
        cache_dtype = np.int16 if max_id < 2 ** 15 else np.int32
        cached, vis, pending = [], None, None

        def to_host(z):
            return {k: v.cpu().numpy().astype(cache_dtype) for k, v in z.items()}

        for bi, batch in enumerate(device_prefetch(train_loader.epoch(epoch), self.device)):
            if self.max_steps_per_epoch and bi >= self.max_steps_per_epoch:
                break
            x = batch[model.first_stage_key].float()
            z = trainer.encode(x)
            if vis is None:
                vis = x[:4].clone()
            if pending is not None:
                cached.append(to_host(pending))
            pending = z
        if pending is not None:
            cached.append(to_host(pending))
        return cached, vis

    def _log_stage2_images(self, model, x, split, gs, epoch, bi):
        """Sample grids during stage-2 training, from a generator seeded
        with the global step (apart from the training streams); the caller
        puts the f32 masters in place, as the JAX loop samples with
        `state.params`."""
        imgs = model.log_images(x, generator=self._generator(gs))
        self.images.log(imgs, split, gs, epoch, bi)

    def _validate_stage2(self, model, data, trainer):
        return self._mean_over(data.val_dataloader(seed=self.seed), model.first_stage_key,
                               trainer.eval_step)
