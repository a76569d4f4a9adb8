"""Control signals for sketch2sound conditioning (counterpart of
`vampnet_tpu/control.py`).

Feature extractors produce per-frame control tensors aligned to codec
tokens, computed on the waveform's device (the card, where the training step
and the server hold the audio):
  RMS            - windowed loudness envelope, optionally quantized (by the
                   min and max of the whole batch, as in JAX) and
                   median-filtered (the "rmsq16" family of
                   `configs/lora/lora-s2s.yml`);
  HarmonicChroma - STFT -> harmonic/percussive separation (median-filter
                   HPSS, hard mask) -> chroma filterbank -> top-n softmax.

Layout: controls are (batch, time, dim), channels-last as in the JAX
package. Where a straight translation would give other numbers than JAX:
the Hann window is the symmetric one (`jnp.hanning`), and an even median
window averages its two middle values (`jnp.median`; `torch.median` returns
the lower one).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .newmask import random_along_time


# ---------------- primitives ----------------


def frame(x: torch.Tensor, window_length: int, hop_length: int) -> torch.Tensor:
    """(..., t) -> (..., n_frames, window_length), reflect-padded by
    window_length // 2 at both ends (stft-like)."""
    pad = window_length // 2
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    return xp.reshape(*lead, -1).unfold(-1, window_length, hop_length)


def rms(wav: torch.Tensor, window_length: int = 2048, hop_length: int = 512) -> torch.Tensor:
    """Windowed RMS envelope: (b, t) -> (b, n_frames)."""
    frames = frame(wav, window_length, hop_length)
    return torch.sqrt(torch.mean(torch.square(frames), dim=-1) + 1e-12)


def median_filter_1d(x: torch.Tensor, size: int) -> torch.Tensor:
    """Median filter along the last axis, edge-padded; an even window takes
    the mean of its two middle values."""
    if size <= 1:
        return x
    half = size // 2
    lead, n = x.shape[:-1], x.shape[-1]
    xp = F.pad(x.reshape(-1, 1, n), (half, size - 1 - half), mode="replicate")
    windows = xp.reshape(*lead, -1).unfold(-1, size, 1)  # (..., n, size)
    upper = torch.kthvalue(windows, half + 1, dim=-1).values
    if size % 2:
        return upper
    lower = torch.kthvalue(windows, half, dim=-1).values
    return 0.5 * lower + 0.5 * upper


def stft_mag(wav: torch.Tensor, window_length: int, hop_length: int) -> torch.Tensor:
    """(b, t) -> magnitude spectrogram (b, n_freq, n_frames), symmetric Hann
    window."""
    frames = frame(wav, window_length, hop_length)  # (b, n_frames, w)
    win = torch.hann_window(window_length, periodic=False, dtype=torch.float64,
                            device=wav.device).to(frames.dtype)
    spec = torch.fft.rfft(frames * win, dim=-1)
    return torch.abs(spec).transpose(-1, -2)


def hpss_harmonic(spec: torch.Tensor, kernel_size: int = 51, hard: bool = True) -> torch.Tensor:
    """Harmonic component by median-filter HPSS (Fitzgerald 2010): harmonic
    = smoothed along time, percussive = smoothed along frequency."""
    harm = median_filter_1d(spec, kernel_size)  # along time (last axis)
    perc = median_filter_1d(spec.transpose(-1, -2), kernel_size).transpose(-1, -2)
    if hard:
        mask = (harm >= perc).to(spec.dtype)
    else:
        mask = torch.square(harm) / (torch.square(harm) + torch.square(perc) + 1e-12)
    return spec * mask


def chroma_filterbank(
    sample_rate: int, n_freqs: int, n_chroma: int = 12, octwidth: float = 5.0,
    tuning: float = 0.0,
) -> np.ndarray:
    """librosa-style chroma filterbank (n_chroma, n_freqs): gaussian bumps
    over wrapped log-frequency with a gaussian octave-centering window."""
    n_fft = 2 * (n_freqs - 1)
    frequencies = np.linspace(0, sample_rate, n_fft, endpoint=False)[1:n_freqs]
    frqbins = n_chroma * np.log2(frequencies / (sample_rate / 2 ** (5 - tuning / n_chroma)))
    frqbins = np.concatenate([[frqbins[0] - 1.5 * n_chroma], frqbins])
    binwidthbins = np.concatenate([np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1]])
    D = np.subtract.outer(frqbins, np.arange(0, n_chroma, dtype="d")).T
    n_chroma2 = np.round(float(n_chroma) / 2)
    D = np.remainder(D + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
    wts = np.exp(-0.5 * (2 * D / np.tile(binwidthbins, (n_chroma, 1))) ** 2)
    wts /= np.sqrt(np.sum(wts**2, axis=0, keepdims=True) + 1e-12)
    if octwidth is not None:
        ctroct = 5.0
        wts *= np.tile(
            np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)),
            (n_chroma, 1),
        )
    return np.ascontiguousarray(wts[:, :n_freqs].astype(np.float32))


# ---------------- extractors ----------------


class RMSControl:
    """The rms/rmsq* controllers."""

    def __init__(
        self,
        hop_length: int,
        window_length: int = 2048,
        n_quantize: Optional[int] = None,
        sample_rate: int = 44100,
        median_filter_size: Optional[int] = None,
    ):
        self.hop_length = hop_length
        self.window_length = window_length
        self.n_quantize = n_quantize
        self.sample_rate = sample_rate
        self.median_filter_size = median_filter_size

    @property
    def dim(self) -> int:
        return 1

    def extract(self, wav: torch.Tensor) -> torch.Tensor:
        """wav (b, t) -> (b, n_frames, 1). With `n_quantize` the envelope is
        scaled by the min and max of the whole batch, so a row's control
        depends on the other rows."""
        r = rms(wav, self.window_length, self.hop_length)[:, :-1]  # the codec's frames
        if self.n_quantize is not None:
            lo, hi = torch.min(r), torch.max(r)
            r = (r - lo) / torch.clamp(hi - lo, min=1e-9)
            r = torch.round(r * self.n_quantize) / self.n_quantize
        if self.median_filter_size is not None:
            r = median_filter_1d(r, self.median_filter_size)
        return r[:, :, None]


class HarmonicChromaControl:
    """The hchroma controllers."""

    def __init__(
        self,
        hop_length: int,
        window_length: int = 4096,
        n_chroma: int = 48,
        sample_rate: int = 44100,
        top_n: int = 0,
    ):
        self.hop_length = hop_length
        self.window_length = window_length
        self.n_chroma = n_chroma
        self.sample_rate = sample_rate
        self.top_n = top_n
        self._fb = torch.from_numpy(
            chroma_filterbank(sample_rate, window_length // 2 + 1, n_chroma))

    @property
    def dim(self) -> int:
        return self.n_chroma

    def extract(self, wav: torch.Tensor) -> torch.Tensor:
        """wav (b, t) -> (b, n_frames, n_chroma)."""
        spec = stft_mag(wav, self.window_length, self.hop_length)
        spec = hpss_harmonic(spec, kernel_size=51, hard=True)
        chroma = torch.einsum("cf,bft->bct", self._fb.to(spec.device), spec)

        # silence gating by the frame's RMS in dB
        frame_rms = torch.sqrt(torch.mean(torch.square(spec), dim=1) + 1e-12)
        rms_db = 10 * torch.log10(frame_rms + 1e-7)
        gate = (rms_db >= -40).to(chroma.dtype)[:, None, :]

        chroma = torch.where(chroma < 100, 0.0, chroma)
        if self.top_n:
            kth = torch.topk(chroma, self.top_n, dim=1).values[:, -1:, :]
            chroma = chroma * (chroma >= kth)
        chroma = chroma * gate
        if self.top_n > 0:
            sm = torch.softmax(chroma, dim=1)
            # frames all zero before the softmax stay zero (not uniform)
            allzero = torch.all(chroma == 0, dim=1, keepdim=True)
            chroma = torch.where(allzero, 0.0, sm)
        return chroma.transpose(1, 2)[:, :-1, :]  # (b, t, c), the codec's frames


CONTROLLERS = {
    "rms": RMSControl,
    "rmsq128": functools.partial(RMSControl, n_quantize=128),
    "rmsq16": functools.partial(RMSControl, n_quantize=16),
    "rms-median": functools.partial(RMSControl, median_filter_size=5),
    "rmsq16-median": functools.partial(RMSControl, n_quantize=16, median_filter_size=3),
    "hchroma": HarmonicChromaControl,
    "hchroma-12c-top2": functools.partial(HarmonicChromaControl, n_chroma=12, top_n=2),
    "hchroma-36c-top3": functools.partial(HarmonicChromaControl, n_chroma=36, top_n=3),
}


class Sketch2SoundController:
    """A set of controllers by their `CONTROLLERS` keys."""

    def __init__(self, ctrl_keys: List[str], hop_length: int, sample_rate: int):
        unknown = [k for k in ctrl_keys if k not in CONTROLLERS]
        if unknown:
            raise ValueError(f"got an unsupported control key in {ctrl_keys}!\n"
                             f"  supported: {list(CONTROLLERS)}")
        self.ctrl_keys = ctrl_keys
        self.hop_length = hop_length
        self.sample_rate = sample_rate
        self.controllers = {
            k: CONTROLLERS[k](hop_length=hop_length, sample_rate=sample_rate)
            for k in ctrl_keys
        }

    @property
    def ctrl_dims(self) -> Dict[str, int]:
        return {k: c.dim for k, c in self.controllers.items()}

    def extract(self, wav: torch.Tensor) -> Dict[str, torch.Tensor]:
        """wav (b, t) -> {key: (b, frames, dim)}."""
        return {k: c.extract(wav) for k, c in self.controllers.items()}

    def random_mask(self, ctrls: Dict[str, torch.Tensor], r,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Per control a (b, frames) mask, 1 = the control is given:
        1 - Bernoulli(gamma(r)) over time, drawn in the controls' order."""
        masks = {}
        for k, ctrl in ctrls.items():
            dummy = torch.zeros((ctrl.shape[0], 1, ctrl.shape[1]), dtype=torch.int64,
                                device=ctrl.device)
            masks[k] = 1 - random_along_time(generator, dummy, r)
        return masks

    def empty_mask(self, ctrls: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        first = next(iter(ctrls.values()))
        mask = torch.zeros(first.shape[:2], dtype=torch.int64, device=first.device)
        return {k: mask for k in ctrls}
