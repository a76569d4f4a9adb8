"""Beat and onset tracking for beat-synced masks (counterpart of
`vampnet_tpu/beats.py`), numpy and scipy on the host.

The default tracker is self-contained: a spectral-flux onset envelope, an
autocorrelation tempo estimate and dynamic-programming beat tracking (Ellis
2007, the algorithm librosa uses). `WaveBeat` runs the neural dsTCN tracker
(`wavebeat.py`) from a checkpoint, its forward on the card, and falls back
to the DP tracker where the file is missing or unreadable.
`load_beat_tracker` names the trackers, as the JAX registry does (its
`madmom` entry is a stub that raises and is not carried over).
"""
from __future__ import annotations

import json
import logging
import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

import numpy as np
import scipy.signal

from .audio import AudioSignal


# ---------------- onset envelope ----------------


def onset_envelope(
    samples: np.ndarray, sr: int, hop_length: int = 512, n_fft: int = 2048
) -> np.ndarray:
    """Log-magnitude spectral-flux onset strength, one value per hop frame."""
    x = samples.reshape(-1).astype(np.float32)
    if len(x) < n_fft:
        x = np.pad(x, (0, n_fft - len(x)))
    _, _, Z = scipy.signal.stft(
        x, fs=sr, nperseg=n_fft, noverlap=n_fft - hop_length, boundary="zeros",
        padded=True,
    )
    mag = np.log1p(1000.0 * np.abs(Z))  # (freq, frames)
    flux = np.diff(mag, axis=1)
    flux = np.maximum(flux, 0.0).mean(axis=0)
    flux = np.concatenate([[0.0], flux])
    # local-mean removal
    kernel = np.ones(16) / 16
    local_mean = np.convolve(flux, kernel, mode="same")
    env = np.maximum(flux - local_mean, 0.0)
    if env.max() > 0:
        env = env / env.max()
    return env


def detect_onsets(
    sig: AudioSignal, hop_length: int = 512, delta: float = 0.07, wait_frames: int = 4
) -> np.ndarray:
    """Onset frame indices: peak picking on the flux envelope of the first
    channel."""
    env = onset_envelope(sig.samples[0], sig.sample_rate, hop_length)
    peaks, _ = scipy.signal.find_peaks(env, height=delta, distance=wait_frames)
    return peaks.astype(np.int64)


# ---------------- beat containers ----------------


@dataclass
class TimeSegment:
    start: float
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start

    def __str__(self) -> str:
        return f"{self.start} - {self.end}"


@dataclass
class Beats:
    """Beat and downbeat times in seconds."""

    beat_times: np.ndarray
    downbeat_times: np.ndarray

    def __post_init__(self):
        self.beat_times = np.asarray(self.beat_times, dtype=np.float64)
        self.downbeat_times = np.asarray(self.downbeat_times, dtype=np.float64)

    def beat_segments(self, signal: AudioSignal) -> List[TimeSegment]:
        starts = self.beat_times
        ends = np.concatenate([self.beat_times[1:], [signal.duration]])
        return [TimeSegment(s, e) for s, e in zip(starts, ends)]

    def get_beats(self) -> np.ndarray:
        return self.beat_times

    def get_downbeats(self) -> np.ndarray:
        return self.downbeat_times

    def save(self, output_dir):
        """Write `beats.json` into `output_dir`."""
        path = Path(output_dir) / "beats.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(
            json.dumps(
                {
                    "beats": self.beat_times.tolist(),
                    "downbeats": self.downbeat_times.tolist(),
                }
            )
        )
        return path

    @classmethod
    def load(cls, input_dir) -> "Beats":
        path = Path(input_dir) / "beats.json"
        data = json.loads(path.read_text())
        return cls(np.array(data["beats"]), np.array(data["downbeats"]))


# ---------------- trackers ----------------


class BeatTracker:
    def extract_beats(self, signal: AudioSignal) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (beat_times, downbeat_times) in seconds."""
        raise NotImplementedError


class DPBeatTracker(BeatTracker):
    """Ellis dynamic-programming beat tracker on the spectral-flux envelope.

    Self-contained replacement for the wavebeat model: tempo from the
    autocorrelation of the onset envelope, then DP alignment of beats to
    onset peaks; downbeats every `meter` beats starting at the strongest.
    """

    def __init__(self, hop_length: int = 512, tightness: float = 100.0, meter: int = 4):
        self.hop_length = hop_length
        self.tightness = tightness
        self.meter = meter

    def _tempo_period(self, env: np.ndarray, fps: float) -> float:
        # autocorrelation, searching 60-180 BPM
        ac = np.correlate(env, env, mode="full")[len(env) - 1 :]
        min_lag = max(1, int(fps * 60.0 / 180.0))
        max_lag = min(len(ac) - 1, int(fps * 60.0 / 60.0))
        if max_lag <= min_lag:
            return fps * 0.5  # fallback: 120 BPM
        # log-normal tempo prior around 120 BPM
        lags = np.arange(min_lag, max_lag + 1)
        bpm = 60.0 * fps / lags
        prior = np.exp(-0.5 * ((np.log2(bpm / 120.0)) / 1.0) ** 2)
        return float(lags[np.argmax(ac[min_lag : max_lag + 1] * prior)])

    def extract_beats(self, signal: AudioSignal) -> Tuple[np.ndarray, np.ndarray]:
        sr = signal.sample_rate
        env = onset_envelope(signal.samples[0], sr, self.hop_length)
        fps = sr / self.hop_length
        if env.sum() == 0 or len(env) < 4:
            return np.array([]), np.array([])
        period = self._tempo_period(env, fps)

        # DP (Ellis 2007): score[t] = env[t] + max_tau(score[t-tau] - tightness*log(tau/period)^2)
        n = len(env)
        score = np.array(env, dtype=np.float64)
        backlink = -np.ones(n, dtype=np.int64)
        window = np.arange(max(1, int(period / 2)), int(period * 2) + 1)
        penalty = -self.tightness * (np.log(window / period) ** 2)
        for t in range(len(env)):
            prev = t - window
            valid = prev >= 0
            if not valid.any():
                continue
            candidates = score[prev[valid]] + penalty[valid]
            best = np.argmax(candidates)
            if candidates[best] > 0:
                score[t] += candidates[best]
                backlink[t] = prev[valid][best]
        # backtrace from the best late score
        tail = np.argmax(score[int(n - period) :]) + int(n - period) if n > period else int(np.argmax(score))
        beats = [int(tail)]
        while backlink[beats[-1]] >= 0:
            beats.append(int(backlink[beats[-1]]))
        beats = np.array(sorted(beats), dtype=np.int64)
        beat_times = beats / fps

        # downbeats: strongest beat phase over `meter`
        if len(beats) >= self.meter:
            phase_strength = [
                env[beats[p :: self.meter]].mean() for p in range(self.meter)
            ]
            phase = int(np.argmax(phase_strength))
        else:
            phase = 0
        downbeat_times = beat_times[phase :: self.meter]
        return beat_times, downbeat_times


class WaveBeat(BeatTracker):
    """The neural dsTCN tracker (`wavebeat.py`: BatchNorms folded into the
    convs, the forward on `device`) with upstream's
    predict_beats_from_array recipe. Falls back to the classical
    DPBeatTracker only where the checkpoint file is missing or unreadable;
    an error while the model runs propagates."""

    def __init__(self, ckpt_path: str = "checkpoints/wavebeat", device="cuda"):
        from .checkpoints import load_wavebeat
        from .util import resolve_device
        from .wavebeat import WaveBeatModel

        self.device = resolve_device(device)
        self.model = None
        try:
            cfg, state = load_wavebeat(ckpt_path)
        except (OSError, EOFError, ValueError, KeyError, RuntimeError,
                pickle.UnpicklingError) as e:  # a missing or unreadable file
            logging.debug(f"wavebeat checkpoint unavailable ({e}); using DP tracker")
            self._fallback = DPBeatTracker()
            return
        self.model = WaveBeatModel(cfg, state, self.device)

    def to(self, device) -> "WaveBeat":
        """Move the model's forward to `device`."""
        from .util import resolve_device

        self.device = resolve_device(device)
        if self.model is not None:
            self.model.to(self.device)
        return self

    def extract_beats(self, signal: AudioSignal) -> Tuple[np.ndarray, np.ndarray]:
        if self.model is not None:
            return self.model.predict_beats_from_array(
                signal.samples[0], signal.sample_rate
            )
        return self._fallback.extract_beats(signal)


BEAT_TRACKER_REGISTRY = {
    "wavebeat": WaveBeat,
    "dp": DPBeatTracker,
}


def load_beat_tracker(model: str, **kwargs) -> BeatTracker:
    if model not in BEAT_TRACKER_REGISTRY:
        raise ValueError(
            f"Unknown beat tracker {model}. Available: {list(BEAT_TRACKER_REGISTRY)}"
        )
    return BEAT_TRACKER_REGISTRY[model](**kwargs)
