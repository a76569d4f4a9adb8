"""Eval metrics (counterpart of `vampnet_tpu/eval.py`): the multi-scale
mel-spectrogram loss and the Fréchet Audio Distance.

Both run on the host in numpy and scipy, as in the JAX package:

  * `mel_spectrogram_loss`: multi-scale log-mel L1, audiotools'
    formulation (window lengths 32 to 2,048, slaney mel filterbanks);
  * `FrechetAudioDistance`: the Fréchet distance between Gaussian fits of
    per-frame embeddings of two directories or two lists of signals. The
    embedding function is pluggable: the default is a log-mel frame
    embedding that needs no weights; `vggish.VGGishEmbedder` gives scores
    comparable with published FAD numbers.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import scipy.linalg
import scipy.signal

from .audio import AudioSignal

# ---------------- mel primitives ----------------


def hz_to_mel(f):
    """Slaney mel scale (librosa's and audiotools' default)."""
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3)
    return np.where(
        f >= 1000.0,
        15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
        mel,
    )


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin=0.0, fmax=None) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) triangular slaney filterbank, area-normed."""
    fmax = fmax or sr / 2
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_freqs)
    hz_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, n_freqs))
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down)) * (2.0 / (hi - lo))
    return fb.astype(np.float32)


def log_mel_spectrogram(wav: np.ndarray, sr: int, n_fft: int = 2048,
                        hop: Optional[int] = None, n_mels: int = 128) -> np.ndarray:
    """(t,) -> (n_mels, frames) log10 mel magnitudes."""
    hop = hop or n_fft // 4
    if len(wav) < n_fft:
        wav = np.pad(wav, (0, n_fft - len(wav)))
    _, _, spec = scipy.signal.stft(wav, fs=sr, nperseg=n_fft, noverlap=n_fft - hop,
                                   boundary="zeros", padded=True)
    return np.log10(mel_filterbank(sr, n_fft, n_mels) @ np.abs(spec) + 1e-5)


def mel_spectrogram_loss(
    sig1: AudioSignal,
    sig2: AudioSignal,
    n_mels: Sequence[int] = (5, 10, 20, 40, 80, 160, 320),
    window_lengths: Sequence[int] = (32, 64, 128, 256, 512, 1024, 2048),
) -> float:
    """Multi-scale log-mel L1 of the first channels, over the shorter
    length."""
    if sig1.sample_rate != sig2.sample_rate:
        raise ValueError(f"sample rates differ: {sig1.sample_rate} and {sig2.sample_rate}")
    x, y = sig1.samples[0, 0], sig2.samples[0, 0]
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    total = 0.0
    for nm, wl in zip(n_mels, window_lengths):
        mx = log_mel_spectrogram(x, sig1.sample_rate, n_fft=wl, n_mels=nm)
        my = log_mel_spectrogram(y, sig2.sample_rate, n_fft=wl, n_mels=nm)
        total += float(np.abs(mx - my).mean())
    return total / len(n_mels)


# ---------------- Fréchet audio distance ----------------


def default_embedding_fn(sig: AudioSignal, sr: int = 16000) -> np.ndarray:
    """Per-frame log-mel embeddings (frames, 64) at 16 kHz: 1,024-sample
    windows, hop 512."""
    sig = sig.clone().resample(sr).to_mono()
    return log_mel_spectrogram(sig.samples[0, 0], sr, n_fft=1024, hop=512, n_mels=64).T


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """|mu1 - mu2|^2 + Tr(c1 + c2 - 2 sqrt(c1 c2))."""
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(cov1 @ cov2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1 + cov2 - 2.0 * covmean))


class FrechetAudioDistance:
    """FAD between the audio files of two directories, or two lists of
    signals, through `embedding_fn` (AudioSignal -> (frames, dim))."""

    def __init__(self, embedding_fn: Optional[Callable[[AudioSignal], np.ndarray]] = None,
                 audio_ext: str = ".wav", verbose: bool = False):
        self.embedding_fn = embedding_fn or default_embedding_fn
        self.audio_ext = audio_ext
        self.verbose = verbose

    def _fit(self, signals):
        """Mean and covariance of the embeddings of every signal's frames."""
        embs = np.concatenate([self.embedding_fn(s) for s in signals], axis=0)
        return embs.mean(axis=0), np.atleast_2d(np.cov(embs, rowvar=False))

    def _signals(self, directory):
        files = sorted(Path(directory).glob(f"*{self.audio_ext}"))
        if not files:
            raise FileNotFoundError(f"no {self.audio_ext} files in {directory}")
        return (AudioSignal(f) for f in files)

    def score(self, baseline_dir, eval_dir) -> float:
        return frechet_distance(*self._fit(self._signals(baseline_dir)),
                                *self._fit(self._signals(eval_dir)))

    def score_signals(self, baseline: List[AudioSignal], generated: List[AudioSignal]) -> float:
        return frechet_distance(*self._fit(baseline), *self._fit(generated))
