"""Noam learning-rate schedule (counterpart of
`vampnet_tpu/train/scheduler.py`):
lr(step) = factor * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5),
with step clamped to at least 1 and the arithmetic in fp32, as the JAX
schedule computes it."""
from __future__ import annotations

from typing import Callable

import numpy as np


def noam_schedule(d_model: int, factor: float = 1.0,
                  warmup: int = 4000) -> Callable[[int], float]:
    scale = np.float32(factor * d_model ** -0.5)
    ramp = np.float32(warmup ** -1.5)

    def schedule(step) -> float:
        s = np.float32(max(float(step), 1.0))
        return float(scale * np.minimum(s ** np.float32(-0.5), s * ramp))

    return schedule
