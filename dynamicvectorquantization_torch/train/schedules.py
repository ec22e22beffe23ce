"""LR schedules: linear warmup and linear-warmup + cosine decay (counterpart
of `dynamicvectorquantization_tpu/train/schedules.py`).

Each maker returns a function of the optimizer step (a Python int) that
returns the learning rate as a Python float. The arithmetic runs in
`numpy.float32`, as the JAX schedules run in f32, so the two agree to
rounding. Reference multiplier semantics: LambdaLR multipliers on the base
LR, floored at `multiplier_min`."""
from __future__ import annotations

import numpy as np

_f = np.float32


def linear_warmup(base_lr: float, warmup_steps: int):
    def schedule(step):
        warm = np.minimum(_f(step) / _f(max(warmup_steps, 1)), _f(1.0))
        return float(_f(base_lr) * warm)

    return schedule


def warmup_cosine(base_lr: float, warmup_steps: int, max_steps: int, multiplier_min: float = 0.0):
    def schedule(step):
        if step < warmup_steps:
            mult = _f(step) / _f(max(warmup_steps, 1))
        else:
            progress = _f(step - warmup_steps) / _f(max(max_steps - warmup_steps, 1))
            cos = _f(0.5) * (np.cos(_f(np.pi) * progress) + _f(1.0))
            mult = np.maximum(cos, _f(multiplier_min))
        return float(_f(base_lr) * mult)

    return schedule


def lambda_warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float, lr_start: float,
                         max_decay_steps: int):
    """A *multiplier* schedule ("use with a base_lr of 1.0"): linear
    lr_start -> lr_max over warm_up_steps, then cosine lr_max -> lr_min over
    (max_decay_steps - warm_up_steps). No shipped config reaches it."""

    def schedule(step):
        if step < warm_up_steps:
            return float(_f((lr_max - lr_start) / max(warm_up_steps, 1)) * _f(step) + _f(lr_start))
        t = _f(step - warm_up_steps) / _f(max(max_decay_steps - warm_up_steps, 1))
        t = np.minimum(t, _f(1.0))
        return float(_f(lr_min) + _f(0.5 * (lr_max - lr_min)) * (_f(1.0) + np.cos(t * _f(np.pi))))

    return schedule


def gradual_warmup(base_lr: float, steps: int, buffer_steps: int, multiplier: float,
                   cosine_steps: int, min_lr: float = 0.0, start_from_zero: bool = True):
    """Warmup to multiplier * base_lr over `steps`, hold through
    `buffer_steps`, then cosine-anneal to `min_lr` over `cosine_steps`. No
    shipped config reaches it."""

    def schedule(step):
        if step <= steps + buffer_steps:
            ramp = np.minimum(_f(1.0), _f(step) / _f(max(steps, 1)))
            m = _f(multiplier) * ramp if start_from_zero else _f(1.0) + _f(multiplier - 1) * ramp
            return float(_f(base_lr) * m)
        t = np.clip(_f(step - steps - buffer_steps) / _f(max(cosine_steps, 1)), _f(0.0), _f(1.0))
        peak = base_lr * multiplier
        return float(_f(min_lr) + _f(0.5 * (peak - min_lr)) * (_f(1.0) + np.cos(t * _f(np.pi))))

    return schedule


def make_schedule(scheduler_type: str, base_lr, warmup_steps, max_steps, min_lr=0.0):
    floor = min_lr / max(base_lr, 1e-20)
    if scheduler_type == "linear-warmup":
        return linear_warmup(base_lr, warmup_steps)
    if scheduler_type == "linear-warmup_cosine-decay":
        return warmup_cosine(base_lr, warmup_steps, max_steps, floor)
    if scheduler_type == "lambda-warmup-cosine":
        mult = lambda_warmup_cosine(warmup_steps, floor, 1.0, 0.0, max_steps)
        return lambda step: float(_f(base_lr) * _f(mult(step)))
    if scheduler_type == "gradual-warmup":
        return gradual_warmup(base_lr, warmup_steps, 0, 1.0, max_steps - warmup_steps, min_lr)
    raise NotImplementedError(scheduler_type)
