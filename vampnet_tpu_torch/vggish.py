"""The VGGish audio embedder (counterpart of `vampnet_tpu/vggish.py`), for
FAD scores comparable with published ones.

`VGGish` is the AudioSet CNN (conv stages 64, 128, 256 x 2, 512 x 2 with
max pools, then a 4,096 / 4,096 / 128 head over 96 x 64 log-mel patches) as
an `nn.Module` in torchvggish's own layout (`features.{0,3,6,8,11,13}`
convs, `embeddings.{0,2,4}` linears), so a torchvggish state dict loads as
it is. The convolutions run NCHW through cuDNN in fp32 (TF32 off); the head
flattens channel-last, as torchvggish permutes before its flatten.

The front end is TF VGGish's: 16 kHz mono, a 25 ms Hann window and a 10 ms
hop, 64 HTK mel bands from 125 to 7,500 Hz, log(mel + 0.01), patches of 96
frames without overlap. Pass `VGGishEmbedder(ckpt)` to
`eval.FrechetAudioDistance(embedding_fn=...)`.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import scipy.signal
import torch
from torch import nn

from .codec.layers import no_tf32
from .util import resolve_device

SAMPLE_RATE = 16000
N_FFT = 512  # the 400-sample (25 ms) window zero-padded; hop 160 (10 ms)
WIN = 400
HOP = 160
N_MELS = 64
MEL_FMIN = 125.0
MEL_FMAX = 7500.0
FRAMES = 96  # 0.96 s patches
LOG_OFFSET = 0.01

_CONV_CH = (64, 128, 256, 256, 512, 512)
_POOL_AFTER = {0, 1, 3, 5}  # a max pool after these convs


class VGGish(nn.Module):
    """(b, 1, 96, 64) log-mel patches -> (b, 128) embeddings."""

    def __init__(self, device=None):
        super().__init__()
        layers, c_in = [], 1
        for i, ch in enumerate(_CONV_CH):
            layers += [nn.Conv2d(c_in, ch, 3, padding=1, device=device), nn.ReLU()]
            if i in _POOL_AFTER:
                layers.append(nn.MaxPool2d(2, 2))
            c_in = ch
        self.features = nn.Sequential(*layers)
        self.embeddings = nn.Sequential(
            nn.Linear(512 * 6 * 4, 4096, device=device), nn.ReLU(),
            nn.Linear(4096, 4096, device=device), nn.ReLU(),
            nn.Linear(4096, 128, device=device), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)  # (b, 512, 6, 4)
        return self.embeddings(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


# ---------------- front end ----------------


def _htk_mel_filterbank() -> np.ndarray:
    """(64, 257) triangular HTK-mel filters, 125-7,500 Hz, unnormed."""
    def hz_to_htk(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def htk_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    hz_pts = htk_to_hz(np.linspace(hz_to_htk(MEL_FMIN), hz_to_htk(MEL_FMAX), N_MELS + 2))
    fb = np.zeros((N_MELS, N_FFT // 2 + 1), np.float32)
    for i in range(N_MELS):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb


def waveform_to_examples(wav: np.ndarray, sr: int) -> np.ndarray:
    """(t,) audio at any rate -> (n_examples, 96, 64) log-mel patches; a
    clip shorter than one patch repeats its last frame."""
    x = np.asarray(wav, np.float32).reshape(-1)
    if sr != SAMPLE_RATE:
        g = math.gcd(SAMPLE_RATE, int(sr))
        x = scipy.signal.resample_poly(x, SAMPLE_RATE // g, int(sr) // g)
    if len(x) < WIN:
        x = np.pad(x, (0, WIN - len(x)))
    # framed as TF VGGish frames: no centering
    n_frames = 1 + (len(x) - WIN) // HOP
    idx = np.arange(WIN)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = x[idx] * np.hanning(WIN)[None, :].astype(np.float32)
    spec = np.abs(np.fft.rfft(frames, n=N_FFT, axis=-1))
    logmel = np.log(spec @ _htk_mel_filterbank().T + LOG_OFFSET)  # (frames, 64)
    n_ex = len(logmel) // FRAMES
    if n_ex == 0:
        pad = np.tile(logmel[-1:], (FRAMES - len(logmel), 1))
        logmel, n_ex = np.concatenate([logmel, pad]), 1
    return logmel[: n_ex * FRAMES].reshape(n_ex, FRAMES, N_MELS)


# ---------------- checkpoints ----------------


def vggish_from_torch_checkpoint(path) -> Dict[str, torch.Tensor]:
    """A torchvggish state dict (`features.*`, `embeddings.*`, optionally
    under `state_dict`) as `VGGish`'s state dict; other entries (the PCA
    parameters) are left out."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.float() for k, v in obj.items()
            if k.startswith(("features.", "embeddings."))}


class VGGishEmbedder:
    """AudioSignal -> (n_examples, 128) VGGish embeddings of its channel
    mean: an `embedding_fn` for `eval.FrechetAudioDistance`."""

    def __init__(self, ckpt_path, device="cuda"):
        self.device = resolve_device(device)
        self.model = VGGish(device="meta").to_empty(device=self.device)
        self.model.load_state_dict(vggish_from_torch_checkpoint(ckpt_path))
        self.model.requires_grad_(False).eval()

    @torch.inference_mode()
    def embed(self, examples: np.ndarray) -> np.ndarray:
        """(n, 96, 64) log-mel patches -> (n, 128)."""
        x = torch.from_numpy(np.ascontiguousarray(examples, np.float32))[:, None]
        with no_tf32():
            return self.model(x.to(self.device)).cpu().numpy()

    def __call__(self, sig) -> np.ndarray:
        mono = sig.samples.mean(axis=(0, 1)) if sig.samples.ndim == 3 else sig.samples
        return self.embed(waveform_to_examples(mono, sig.sample_rate))
