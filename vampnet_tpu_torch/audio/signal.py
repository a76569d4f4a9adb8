"""Host-side audio signal (counterpart of `vampnet_tpu/audio/signal.py`).

What the serving paths use: WAV read and write (`scipy.io.wavfile`),
resample, to_mono, ITU-R BS.1770 loudness and normalize, ensure_max_of_audio,
zero_pad, trim, excerpt and `signal_concat`. numpy/scipy only; samples are
float32 (batch, channels, time). The port keeps its own copy so that it
imports nothing of the JAX package.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Union

import numpy as np
import scipy.signal


def _k_weighting_coeffs(sr: int):
    """ITU-R BS.1770-4 K-weighting: high-shelf then high-pass biquads,
    designed for the target sample rate (pyloudnorm-style bilinear redesign)."""
    # stage 1: spherical-head high shelf
    db = 3.999843853973347
    f0 = 1681.974450955533
    Q = 0.7071752369554196
    K = math.tan(math.pi * f0 / sr)
    Vh = 10.0 ** (db / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b_shelf = np.array(
        [
            (Vh + Vb * K / Q + K * K) / a0,
            2.0 * (K * K - Vh) / a0,
            (Vh - Vb * K / Q + K * K) / a0,
        ]
    )
    a_shelf = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    # stage 2: high-pass
    f0 = 38.13547087602444
    Q = 0.5003270373238773
    K = math.tan(math.pi * f0 / sr)
    a0 = 1.0 + K / Q + K * K
    b_hp = np.array([1.0, -2.0, 1.0])
    a_hp = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    return (b_shelf, a_shelf), (b_hp, a_hp)


def _loudness_lufs(samples: np.ndarray, sr: int) -> np.ndarray:
    """Integrated loudness (LUFS) per batch item, BS.1770-4 gating."""
    b, ch, t = samples.shape
    (bs, as_), (bh, ah) = _k_weighting_coeffs(sr)
    x = scipy.signal.lfilter(bs, as_, samples, axis=-1)
    x = scipy.signal.lfilter(bh, ah, x, axis=-1)

    block = int(0.400 * sr)
    step = int(0.100 * sr)
    if t < block:  # pad to one block
        x = np.pad(x, ((0, 0), (0, 0), (0, block - t)))
        t = block
    n_blocks = 1 + (t - block) // step
    out = np.empty((b,), dtype=np.float64)
    # channel weights (mono/stereo: 1.0 each)
    g = np.ones(ch)
    # vectorized block energies via cumulative sums
    csum = np.concatenate(
        [np.zeros((b, ch, 1)), np.cumsum(x.astype(np.float64) ** 2, axis=-1)], axis=-1
    )
    starts = np.arange(n_blocks) * step
    block_sums = csum[:, :, starts + block] - csum[:, :, starts]  # (b, ch, n_blocks)
    z_all = np.transpose(block_sums, (0, 2, 1)) / block  # (b, n_blocks, ch)
    for i in range(b):
        z = z_all[i]  # (n_blocks, ch)
        lk = -0.691 + 10 * np.log10(np.maximum((z * g).sum(axis=-1), 1e-12))
        # absolute gate
        keep = lk > -70.0
        if not keep.any():
            out[i] = -70.0
            continue
        z_abs = z[keep]
        l_abs = -0.691 + 10 * np.log10(np.maximum((z_abs * g).sum(axis=-1).mean(), 1e-12))
        # relative gate
        keep_rel = lk > max(l_abs - 10.0, -70.0)
        z_rel = z[keep_rel] if keep_rel.any() else z_abs
        out[i] = -0.691 + 10 * np.log10(
            np.maximum((z_rel * g).sum(axis=-1).mean(), 1e-12)
        )
    return out.astype(np.float32)



class AudioSignal:
    """float32 (batch, channels, time) audio + sample rate. `samples` may be
    the path of a WAV file, which then gives the sample rate too."""

    def __init__(self, samples: Union[np.ndarray, str, Path],
                 sample_rate: Optional[int] = None):
        if isinstance(samples, (str, Path)):
            samples, sample_rate = self._read(samples)
        if sample_rate is None:
            raise ValueError("sample_rate required")
        samples = np.asarray(samples, dtype=np.float32)
        if samples.ndim == 1:
            samples = samples[None, None, :]
        elif samples.ndim == 2:
            samples = samples[None, :, :]
        if samples.ndim != 3:
            raise ValueError("samples must be (batch, channels, time)")
        self.samples = samples
        self.sample_rate = int(sample_rate)
        self._loudness: Optional[np.ndarray] = None

    @staticmethod
    def _read(path):
        """A WAV file -> ((1, channels, time) float32, sample rate); integer
        PCM is scaled to [-1, 1)."""
        import scipy.io.wavfile as wavfile

        sr, data = wavfile.read(str(path))
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32)
        data = data[None, :] if data.ndim == 1 else data.T  # (channels, time)
        return data[None], sr

    def write(self, path) -> "AudioSignal":
        """The first batch item as 16-bit PCM WAV, clipped to [-1, 1]."""
        import scipy.io.wavfile as wavfile

        data = np.clip(self.samples[0], -1.0, 1.0)
        wavfile.write(str(path), self.sample_rate, (data.T * 32767.0).astype(np.int16))
        return self

    @property
    def batch_size(self) -> int:
        return self.samples.shape[0]

    @property
    def num_channels(self) -> int:
        return self.samples.shape[1]

    @property
    def length(self) -> int:
        return self.samples.shape[-1]

    @property
    def signal_length(self) -> int:
        return self.samples.shape[-1]

    @property
    def duration(self) -> float:
        return self.length / self.sample_rate

    @property
    def audio_data(self) -> np.ndarray:
        return self.samples

    def clone(self) -> "AudioSignal":
        out = AudioSignal(self.samples.copy(), self.sample_rate)
        out._loudness = self._loudness
        return out

    def resample(self, sample_rate: int) -> "AudioSignal":
        if sample_rate != self.sample_rate:
            g = math.gcd(int(sample_rate), self.sample_rate)
            self.samples = scipy.signal.resample_poly(
                self.samples, sample_rate // g, self.sample_rate // g, axis=-1
            ).astype(np.float32)
            self.sample_rate = int(sample_rate)
            self._loudness = None
        return self

    def to_mono(self) -> "AudioSignal":
        self.samples = self.samples.mean(axis=1, keepdims=True).astype(np.float32)
        self._loudness = None
        return self

    def loudness(self) -> np.ndarray:
        if self._loudness is None:
            self._loudness = _loudness_lufs(self.samples, self.sample_rate)
        return self._loudness

    def normalize(self, db: float = -24.0) -> "AudioSignal":
        """Loudness-normalize to `db` LUFS."""
        cur = self.loudness()
        gain = 10.0 ** ((db - cur) / 20.0)
        self.samples = (self.samples * gain[:, None, None]).astype(np.float32)
        self._loudness = np.full_like(cur, db)
        return self

    def ensure_max_of_audio(self, max_val: float = 1.0) -> "AudioSignal":
        peak = np.abs(self.samples).max(axis=(1, 2), keepdims=True)
        scale = np.where(peak > max_val, max_val / np.maximum(peak, 1e-12), 1.0)
        self.samples = (self.samples * scale).astype(np.float32)
        return self

    def zero_pad(self, before: int, after: int) -> "AudioSignal":
        self.samples = np.pad(self.samples, ((0, 0), (0, 0), (before, after)))
        self._loudness = None
        return self

    def trim(self, before: int, after: int) -> "AudioSignal":
        self.samples = self.samples[:, :, before:self.length - after]
        self._loudness = None
        return self

    def excerpt(self, offset_s: float, duration_s: float) -> "AudioSignal":
        lo = int(offset_s * self.sample_rate)
        hi = lo + int(duration_s * self.sample_rate)
        return AudioSignal(self.samples[:, :, lo:hi].copy(), self.sample_rate)


def signal_concat(audio_signals) -> AudioSignal:
    """Concatenate signals along time."""
    data = np.concatenate([s.audio_data for s in audio_signals], axis=-1)
    return AudioSignal(data, audio_signals[0].sample_rate)
