"""LR schedules with torch parity: the port of `clibd_tpu/engine/schedules.py`
(`:18-94`; reference scripts/train_cl.py:223-250), as plain Python
functions of the step that return a float.

All schedules step per batch (the reference calls scheduler.step() every
batch, epoch/train_epoch.py:62-63, ExponentialLR/StepLR included).  LR
scaling by total_batch/500 (util/util.py:753-756) is applied by
`build_schedule` when the config asks for it.  The arithmetic is float64
here and float32 in the JAX package; the two agree to float32 rounding.
"""

from __future__ import annotations

import math
from typing import Callable

from ..config.schema import OptimConfig


def scale_learning_rate(lr: float, batch_size: int, base_batch_size: int = 500,
                        world_size: int = 1) -> float:
    return lr * (batch_size * world_size) / base_batch_size


def one_cycle_lr(max_lr: float, total_steps: int, pct_start: float = 0.3,
                 div_factor: float = 25.0, final_div_factor: float = 1e4) -> Callable[[int], float]:
    """torch OneCycleLR(anneal_strategy='cos', cycle_momentum=False) parity:
    initial = max/div_factor, min = initial/final_div_factor;
    phase 1 ends at float(pct_start·total) − 1, cosine ramp up then down."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    end1 = float(pct_start * total_steps) - 1.0
    end2 = float(total_steps) - 1.0

    def _cos(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    def schedule(step: int) -> float:
        if step <= end1:
            return _cos(initial_lr, max_lr, min(max(step / max(end1, 1e-9), 0.0), 1.0))
        pct = min(max((step - end1) / max(end2 - end1, 1e-9), 0.0), 1.0)
        return _cos(max_lr, min_lr, pct)

    return schedule


def exponential_lr(lr: float, gamma: float = 0.95) -> Callable[[int], float]:
    return lambda step: lr * gamma ** step


def step_lr(lr: float, step_size: int = 10, gamma: float = 0.5) -> Callable[[int], float]:
    return lambda step: lr * gamma ** math.floor(step / step_size)


def cosine_lr(lr: float, total_steps: int, min_lr: float = 1e-9) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        pct = step / max(total_steps, 1)
        return min_lr + (lr - min_lr) * (1.0 + math.cos(math.pi * pct)) / 2.0

    return schedule


def build_schedule(cfg: OptimConfig, total_steps: int, batch_size: int,
                   world_size: int = 1) -> Callable[[int], float]:
    lrc = cfg.lr_config
    base = cfg.base_batch_size

    def scaled(x):
        return scale_learning_rate(x, batch_size, base, world_size) if cfg.scale_lr_by_batch else x

    name = cfg.lr_scheduler
    if name == "one_cycle":
        return one_cycle_lr(scaled(lrc.max_lr), total_steps, lrc.pct_start, lrc.div_factor,
                            lrc.final_div_factor)
    if name == "exponential":
        return exponential_lr(scaled(lrc.lr), lrc.gamma)
    if name == "step":
        return step_lr(scaled(lrc.lr), lrc.step_size, lrc.step_gamma)
    if name == "cosine":
        return cosine_lr(scaled(lrc.lr), total_steps, scaled(lrc.min_lr))
    if name in ("none", "", None):
        lr = scaled(lrc.lr)
        return lambda step: lr
    raise ValueError(f"Unknown lr_scheduler {name!r}")
