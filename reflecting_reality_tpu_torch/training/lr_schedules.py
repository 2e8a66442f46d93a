"""LR schedules (counterpart of `reflecting_reality_tpu/training/lr_schedules.py`;
reference: src/diffusers/optimization.py:361 and train_brushnet_mirror.py:1257-1264).

`get_schedule` returns a plain function of the number of optimizer updates
applied so far, as optax evaluates a schedule: the first update reads
step 0, so under warm-up it runs at lr 0.  Every schedule warms up linearly
from 0 over `num_warmup_steps`, as the diffusers LambdaLR multipliers do.
"""

from __future__ import annotations

import math
from typing import Callable, Optional


def get_schedule(
    name: str,
    learning_rate: float,
    num_warmup_steps: int = 0,
    num_training_steps: Optional[int] = None,
    num_cycles: float = 0.5,
    power: float = 1.0,
    lr_end: float = 1e-7,
) -> Callable[[int], float]:
    w = max(int(num_warmup_steps), 0)

    def warm(step: int) -> float:
        return min(step / max(w, 1), 1.0) if w > 0 else 1.0

    if name in ("constant", "constant_with_warmup"):
        return lambda step: learning_rate * warm(step)

    if num_training_steps is None:
        raise ValueError(f"{name} needs num_training_steps")
    t = int(num_training_steps)

    def clip01(x: float) -> float:
        return min(max(x, 0.0), 1.0)

    def progress(step: int) -> float:
        return (step - w) / max(t - w, 1)

    if name == "linear":
        def decay(step):
            return clip01((t - step) / max(t - w, 1))
    elif name == "cosine":
        def decay(step):
            return clip01(0.5 * (1.0 + math.cos(math.pi * 2.0 * num_cycles * progress(step))))
    elif name == "cosine_with_restarts":
        def decay(step):
            if progress(step) >= 1.0:
                return 0.0
            return 0.5 * (1.0 + math.cos(math.pi * ((num_cycles * progress(step)) % 1.0) * 2.0))
    elif name == "polynomial":
        def fn(step):
            if step < w:
                return learning_rate * warm(step)
            pct = clip01((t - step) / max(t - w, 1))
            return (learning_rate - lr_end) * pct ** power + lr_end
        return fn
    else:
        raise ValueError(f"unknown lr scheduler {name!r}")
    return lambda step: learning_rate * (warm(step) if step < w else decay(step))
