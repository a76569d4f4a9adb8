"""Audio inputs made from the seed.

`clip` is the JAX package's bench signal (two detuned partials and noise)
with its frequencies and noise drawn from the seed; `train_rows` are rows of
noise cut to whole codec frames, as the port's card check trains on.
"""
from __future__ import annotations

import math

import numpy as np


def clip(rng: np.random.Generator, sr: int, seconds: float) -> np.ndarray:
    """(samples,) float32: 0.4 sin(f0) + 0.2 sin(2 f0 with a slow vibrato)
    + 0.05 noise, f0 drawn in 80-220 Hz."""
    t = np.arange(int(round(seconds * sr))) / sr
    f0 = rng.uniform(80.0, 220.0)
    wobble = rng.uniform(0.2, 1.0)
    wav = (0.4 * np.sin(2 * np.pi * f0 * t)
           + 0.2 * np.sin(2 * np.pi * 2 * f0 * t * (1 + 0.1 * np.sin(2 * np.pi * wobble * t)))
           + 0.05 * rng.standard_normal(len(t)))
    return wav.astype(np.float32)


def train_rows(rng: np.random.Generator, sr: int, hop: int, seconds: float,
               rows: int) -> np.ndarray:
    """(rows, n, 1) float32 noise at 0.1 rms, n a whole number of frames."""
    n = math.ceil(seconds * sr / hop) * hop
    return (0.1 * rng.standard_normal((rows, n, 1))).astype(np.float32)
