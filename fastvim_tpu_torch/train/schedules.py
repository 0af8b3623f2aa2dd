"""LR / WD schedules as closed-form functions of the step.

Counterpart of ``fastvim_tpu/train/schedules.py``: the same values, as
plain Python functions ``step -> float`` that the optimizer applies to its
parameter groups before each update.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable


def scale_lr(lr: float, batch_size: int, world_size: int,
             rule: str = "deit") -> float:
    """World-size-aware LR scaling: "linear" lr·eff/256, "deit" lr·eff/512,
    "sqrt" lr·√(eff/1024), "none"; eff = batch_size · world_size."""
    eff = batch_size * world_size
    if rule == "linear":
        return lr * eff / 256.0
    if rule == "deit":
        return lr * eff / 512.0
    if rule == "sqrt":
        return lr * math.sqrt(eff / 1024.0)
    if rule == "none":
        return lr
    raise ValueError(f"unknown scaling rule {rule!r}")


def cosine_with_warmup(base_value: float, final_value: float,
                       total_steps: int, warmup_steps: int = 0,
                       warmup_initial_value: float = 0.0
                       ) -> Callable[[float], float]:
    """value(step): linear warmup that reaches ``base_value`` at step
    ``warmup_steps - 1`` (np.linspace endpoint semantics), then cosine
    decay to ``final_value`` at ``total_steps``."""
    decay_steps = max(total_steps - warmup_steps, 1)

    def schedule(step: float) -> float:
        step = float(step)
        if step < warmup_steps:
            frac = step / (warmup_steps - 1) if warmup_steps > 1 else 1.0
            return (warmup_initial_value
                    + (base_value - warmup_initial_value) * min(frac, 1.0))
        t = min(max(step - warmup_steps, 0.0), decay_steps) / decay_steps
        return final_value + 0.5 * (base_value - final_value) * (
            1 + math.cos(math.pi * t))

    return schedule


def warmup_multistep(base_value: float, warmup_steps: int,
                     milestones: Iterable[int], gamma: float = 0.1,
                     warmup_start_factor: float = 0.001
                     ) -> Callable[[float], float]:
    """Linear warmup from ``warmup_start_factor``·base over
    ``warmup_steps``, times ``gamma`` at each milestone reached."""
    milestones = tuple(sorted(milestones))

    def schedule(step: float) -> float:
        step = float(step)
        frac = (min(max(step / warmup_steps, 0.0), 1.0)
                if warmup_steps > 0 else 1.0)
        warm = warmup_start_factor + (1.0 - warmup_start_factor) * frac
        decay = gamma ** sum(step >= m for m in milestones)
        return base_value * warm * decay

    return schedule


def constant(value: float) -> Callable[[float], float]:
    return lambda step: float(value)
