"""Host audio arithmetic in numpy: ITU-R BS.1770-4 integrated loudness, the
codec's input preparation and the output's loudness match, as VampNet's
interface does them (audiotools' `AudioSignal`)."""
from __future__ import annotations

import math

import numpy as np
import scipy.signal


def _k_weighting(sr: int):
    """The K-weighting's two biquads (high shelf, high pass), redesigned for
    `sr` by the bilinear transform (pyloudnorm's constants)."""
    db, f0, q = 3.999843853973347, 1681.974450955533, 0.7071752369554196
    k = math.tan(math.pi * f0 / sr)
    vh = 10.0 ** (db / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    shelf = (np.array([(vh + vb * k / q + k * k) / a0, 2.0 * (k * k - vh) / a0,
                       (vh - vb * k / q + k * k) / a0]),
             np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]))
    f0, q = 38.13547087602444, 0.5003270373238773
    k = math.tan(math.pi * f0 / sr)
    a0 = 1.0 + k / q + k * k
    hp = (np.array([1.0, -2.0, 1.0]),
          np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]))
    return shelf, hp


def loudness(x: np.ndarray, sr: int) -> np.ndarray:
    """Integrated loudness in LUFS of (b, ch, t) audio: K-weighting, 400 ms
    blocks every 100 ms, the absolute gate at -70 and the relative gate 10
    below."""
    b, ch, t = x.shape
    (bs, as_), (bh, ah) = _k_weighting(sr)
    y = scipy.signal.lfilter(bh, ah, scipy.signal.lfilter(bs, as_, x, axis=-1), axis=-1)
    block, step = int(0.4 * sr), int(0.1 * sr)
    if t < block:
        y = np.pad(y, ((0, 0), (0, 0), (0, block - t)))
        t = block
    n_blocks = 1 + (t - block) // step
    out = np.empty((b,), dtype=np.float64)
    for i in range(b):
        e = np.stack([(y[i, :, j * step:j * step + block].astype(np.float64) ** 2).mean(-1)
                      for j in range(n_blocks)])  # (n_blocks, ch)
        z = e.sum(-1)
        lk = -0.691 + 10 * np.log10(np.maximum(z, 1e-12))
        keep = lk > -70.0
        if not keep.any():
            out[i] = -70.0
            continue
        l_abs = -0.691 + 10 * np.log10(max(z[keep].mean(), 1e-12))
        rel = lk > max(l_abs - 10.0, -70.0)
        zz = z[rel] if rel.any() else z[keep]
        out[i] = -0.691 + 10 * np.log10(max(zz.mean(), 1e-12))
    return out.astype(np.float32)


def match_loudness(x: np.ndarray, sr: int, target_db) -> np.ndarray:
    """(b, ch, t) audio scaled to `target_db` LUFS per row."""
    gain = 10.0 ** ((np.asarray(target_db, dtype=np.float32) - loudness(x, sr)) / 20.0)
    return (x * gain.reshape(-1, 1, 1)).astype(np.float32)


def codec_input(samples: np.ndarray, sr: int, hop: int, target_db: float = -24.0):
    """One mono clip (t,) -> (1, 1, t') float32 as the codec takes it:
    loudness-normalised to -24 LUFS, the peak capped at 1, zero-padded to a
    whole number of hops."""
    x = match_loudness(samples.astype(np.float32)[None, None], sr, target_db)
    peak = np.abs(x).max()
    if peak > 1.0:
        x = (x / peak).astype(np.float32)
    pad = (-x.shape[-1]) % hop
    return np.pad(x, ((0, 0), (0, 0), (0, pad)))
