"""Learning-rate schedules: plain functions of an int step.

Counterpart of ``tf_face_toolbox_tpu/train/schedule.py``. Boundaries are
absolute global steps, and warmup is the same linear ``(step + 1) /
warmup_steps`` ramp on top of the schedule.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def staircase(base_lr: float, boundaries: Sequence[int],
              decay: float = 0.1, warmup_steps: int = 0) -> Schedule:
    """base_lr, times ``decay`` at each boundary step, optional warmup."""
    bnd = sorted(int(b) for b in boundaries)

    def sched(step: int) -> float:
        step = int(step)
        lr = base_lr * decay ** sum(step >= b for b in bnd)
        if warmup_steps > 0:
            lr *= min(1.0, (step + 1) / warmup_steps)
        return lr

    return sched


def cosine(base_lr: float, total_steps: int, warmup_steps: int = 0,
           final_scale: float = 0.0) -> Schedule:
    """Half-cosine decay base_lr -> final_scale * base_lr over
    ``total_steps``, with the staircase's warmup. Steps past
    ``total_steps`` hold the final value."""
    if total_steps <= 0:
        raise ValueError("cosine schedule needs total_steps > 0 "
                         f"(got {total_steps})")

    def sched(step: int) -> float:
        step = int(step)
        frac = min(max(step / total_steps, 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        lr = base_lr * (final_scale + (1.0 - final_scale) * cos)
        if warmup_steps > 0:
            lr *= min(1.0, (step + 1) / warmup_steps)
        return lr

    return sched
