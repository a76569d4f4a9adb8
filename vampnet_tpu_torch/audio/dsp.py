"""Host-side DSP extras (counterpart of `vampnet_tpu/audio/dsp.py`): a
phase-vocoder time stretch and the pitch shift built on it, in numpy and
scipy. A shift by n semitones time-stretches by 2^(n/12) and resamples back
to the original length.
"""
from __future__ import annotations

import numpy as np
import scipy.signal

from .signal import AudioSignal


def time_stretch(x: np.ndarray, rate: float, n_fft: int = 2048, hop: int = 512) -> np.ndarray:
    """Phase-vocoder time stretch of a 1-D signal by `rate` (> 1: shorter)."""
    if rate == 1.0:
        return x.copy()
    _, _, Z = scipy.signal.stft(x, nperseg=n_fft, noverlap=n_fft - hop, boundary="zeros",
                                padded=True)
    n_frames = Z.shape[1]
    t_steps = np.arange(0, n_frames - 1, rate)
    mag = np.abs(Z)
    phase = np.angle(Z)
    # each bin's expected phase advance per hop
    omega = 2 * np.pi * hop * np.arange(Z.shape[0]) / n_fft

    out = np.zeros((Z.shape[0], len(t_steps)), dtype=np.complex128)
    phase_acc = phase[:, 0].copy()
    for i, t in enumerate(t_steps):
        j = int(t)
        frac = t - j
        nxt = min(j + 1, n_frames - 1)
        m = (1 - frac) * mag[:, j] + frac * mag[:, nxt]
        out[:, i] = m * np.exp(1j * phase_acc)
        dphase = phase[:, nxt] - phase[:, j] - omega
        dphase = dphase - 2 * np.pi * np.round(dphase / (2 * np.pi))
        phase_acc = phase_acc + omega + dphase
    _, y = scipy.signal.istft(out, nperseg=n_fft, noverlap=n_fft - hop)
    return y.astype(np.float32)


def pitch_shift(sig: AudioSignal, n_semitones: int) -> AudioSignal:
    """Shift the pitch by `n_semitones`, keeping the duration; the first
    batch item's channels."""
    if n_semitones == 0:
        return sig
    rate = 2.0 ** (n_semitones / 12.0)
    out = sig.clone()
    chans = []
    for c in range(out.num_channels):
        y = time_stretch(out.samples[0, c], 1.0 / rate)
        chans.append(scipy.signal.resample(y, out.length).astype(np.float32))
    out.samples = np.stack(chans)[None]
    out._loudness = None
    return out
