"""Learning-rate schedules — counterpart of ``dgraph_tpu/train/schedules.py``.

GraphCast's three-phase schedule as a function of the update count: linear
warm-up from 0 to ``peak_lr`` over ``warmup_steps`` updates, cosine decay to
``floor_lr`` over ``decay_steps``, then constant (the reference's optax
``join_schedules`` of ``linear_schedule``, ``cosine_decay_schedule`` with
``alpha = floor_lr / peak_lr`` and ``constant_schedule``). Evaluated in
Python floats; optax evaluates in f32, within 1e-7 relative of these values
away from the cancellations near the start of the warm-up.

Drive a torch optimizer with it through ``LambdaLR`` and a base lr of 1:
update k (from 0) then runs at ``schedule(k)``, as optax's count does, so
the first update's lr is 0.
"""

from __future__ import annotations

import math
from typing import Callable


def graphcast_three_phase(
    peak_lr: float = 1e-3,
    warmup_steps: int = 1000,
    decay_steps: int = 100_000,
    floor_lr: float = 3e-7,
) -> Callable[[int], float]:
    alpha = floor_lr / peak_lr

    def schedule(count: int) -> float:
        if count < warmup_steps:
            # optax's polynomial form: (init - end) * (1 - count / steps) + end
            return -peak_lr * (1.0 - count / warmup_steps) + peak_lr
        k = count - warmup_steps
        if k < decay_steps:
            cosine = 0.5 * (1.0 + math.cos(math.pi * k / decay_steps))
            return peak_lr * ((1.0 - alpha) * cosine + alpha)
        return floor_lr

    return schedule
