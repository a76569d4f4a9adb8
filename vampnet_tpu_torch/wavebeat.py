"""WaveBeat (dsTCN) beat and downbeat tracker (counterpart of
`vampnet_tpu/wavebeat.py`).

The network of Steinmetz & Reiss ("WaveBeat: End-to-end beat and downbeat
tracking in the time domain", AES 151) as upstream's `wavebeat` package
trains it: a stack of downsampling temporal conv blocks (conv -> BatchNorm
-> PReLU, plus a strided 1x1-conv residual -> BatchNorm), then a 1x1 conv to
2 activation channels (beat, downbeat) at sample_rate / stride**nblocks
frames a second, peak-picked after a sigmoid.

For inference the BatchNorms are folded into the convs when the Lightning
checkpoint is read, so the network is conv / PReLU / add only. The port
reads the checkpoint's state dict in torch's layout directly (conv weights
(out, in, k)); `.vtpu` files hold the flax layout of the JAX package
(`checkpoints.save_wavebeat`), so the two packages read each other's files.
The forward runs on the model's device (the card unless the caller asks
for the CPU); resampling and peak picking run on the host (scipy), as in
JAX. The input is zero-padded to a multiple of 65,536 samples, as the JAX
package pads it, so that the last frames see what JAX's see.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .util import flatten_tree, resolve_device, unflatten_tree


# ---------------- config ----------------


@dataclasses.dataclass(frozen=True)
class DsTCNBlockConfig:
    in_ch: int
    out_ch: int
    kernel_size: int
    stride: int
    dilation: int


@dataclasses.dataclass(frozen=True)
class DsTCNConfig:
    """Defaults follow the published WaveBeat model: 8 blocks, stride 2
    (256x total downsample of 22.05 kHz audio -> ~86 fps activations),
    kernel 15, dilation cycle 1, 8, 1, 8, ..., channels growing by 32."""

    sample_rate: int = 22050
    noutputs: int = 2
    blocks: Tuple[DsTCNBlockConfig, ...] = ()

    @staticmethod
    def build(
        ninputs: int = 1,
        noutputs: int = 2,
        nblocks: int = 8,
        kernel_size: int = 15,
        stride: int = 2,
        dilation_growth: int = 8,
        dilation_cycle: int = 2,
        channel_growth: int = 32,
        channel_width: int = 32,
        sample_rate: int = 22050,
    ) -> "DsTCNConfig":
        blocks: List[DsTCNBlockConfig] = []
        in_ch = ninputs
        for n in range(nblocks):
            out_ch = channel_width if n == 0 else in_ch + channel_growth
            dilation = dilation_growth ** (n % dilation_cycle)
            blocks.append(DsTCNBlockConfig(in_ch, out_ch, kernel_size, stride, dilation))
            in_ch = out_ch
        return DsTCNConfig(sample_rate=sample_rate, noutputs=noutputs, blocks=tuple(blocks))

    @property
    def total_stride(self) -> int:
        return math.prod(b.stride for b in self.blocks)

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.total_stride

    @staticmethod
    def from_dict(d: Dict) -> "DsTCNConfig":
        return DsTCNConfig(sample_rate=int(d["sample_rate"]), noutputs=int(d["noutputs"]),
                           blocks=tuple(DsTCNBlockConfig(**b) for b in d["blocks"]))


# ---------------- model ----------------


class DsTCNBlock(nn.Module):
    """conv1 (BatchNorm folded) -> PReLU, plus the strided 1x1 residual
    conv; channels-first (b, c, t)."""

    def __init__(self, c: DsTCNBlockConfig, device=None):
        super().__init__()
        self.c = c
        self.conv1 = nn.Conv1d(c.in_ch, c.out_ch, c.kernel_size, stride=c.stride,
                               dilation=c.dilation, padding=((c.kernel_size - 1) // 2) * c.dilation,
                               device=device)
        self.prelu_alpha = nn.Parameter(torch.full((c.out_ch,), 0.25, device=device))
        self.res_conv = nn.Conv1d(c.in_ch, c.out_ch, 1, stride=c.stride, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        main = self.conv1(x)
        main = torch.clamp(main, min=0.0) + self.prelu_alpha[:, None] * torch.clamp(main, max=0.0)
        res = self.res_conv(x)
        # the padded main branch and the 1x1 residual can differ in length by
        # one: crop to the shorter (equal where t % stride == 0)
        t = min(main.shape[-1], res.shape[-1])
        return main[..., :t] + res[..., :t]


class DsTCN(nn.Module):
    """Inference dsTCN: (b, t) audio -> (b, t', noutputs) logits."""

    def __init__(self, config: DsTCNConfig, device=None):
        super().__init__()
        self.config = config
        for i, bc in enumerate(config.blocks):
            self.add_module(f"block_{i}", DsTCNBlock(bc, device=device))
        self.output = nn.Conv1d(config.blocks[-1].out_ch, config.noutputs, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None, :]
        for i in range(len(self.config.blocks)):
            x = getattr(self, f"block_{i}")(x)
        return self.output(x).transpose(1, 2)


# ---------------- checkpoints ----------------


def _fold_bn(w: np.ndarray, b: Optional[np.ndarray], sd: Dict[str, np.ndarray],
             base: str, eps: float = 1e-5) -> Tuple[np.ndarray, np.ndarray]:
    """Fold an inference BatchNorm1d into the preceding conv's (w (out, in,
    k), b); a conv without a norm keeps its weight and gets a zero bias where
    it had none."""
    if b is None:
        b = np.zeros(w.shape[0], w.dtype)
    if f"{base}.running_mean" not in sd:
        return w, b
    mean = sd[f"{base}.running_mean"]
    var = sd[f"{base}.running_var"]
    gamma = sd.get(f"{base}.weight", np.ones_like(mean))
    beta = sd.get(f"{base}.bias", np.zeros_like(mean))
    s = gamma / np.sqrt(var + eps)
    return w * s[:, None, None], (b - mean) * s + beta


def _strip(k: str) -> str:
    for pref in ("model.", "module.", "_orig_mod."):
        while k.startswith(pref):
            k = k[len(pref):]
    return k


def dstcn_from_torch_checkpoint(path) -> Tuple[DsTCNConfig, Dict[str, torch.Tensor]]:
    """A wavebeat Lightning checkpoint (`wavebeat.pth` / `last.ckpt`:
    {"state_dict", "hyper_parameters"}) -> (config, the `DsTCN` state dict
    with the BatchNorms folded). The layer plan comes from the
    hyper-parameters where present; widths and kernel sizes from the
    weights' shapes. It unpickles the file: load only trusted files."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    hp = dict(obj.get("hyper_parameters", {}) or {})
    sd_t = obj.get("state_dict", obj)
    sd = {_strip(k): v.detach().cpu().numpy() for k, v in sd_t.items() if hasattr(v, "detach")}

    nblocks = int(hp.get("nblocks", 0))
    if nblocks == 0:
        nblocks = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    stride = int(hp.get("stride", 2))
    dilation_growth = int(hp.get("dilation_growth", 8))
    dilation_cycle = int(hp.get("dilation_cycle", hp.get("stack_size", 2)))
    sample_rate = int(hp.get("sample_rate", 22050))

    blocks: List[DsTCNBlockConfig] = []
    out: Dict[str, np.ndarray] = {}
    for n in range(nblocks):
        base = f"blocks.{n}"
        w1 = sd[f"{base}.conv1.weight"]
        out_ch, in_ch, k = w1.shape
        blocks.append(DsTCNBlockConfig(in_ch, out_ch, k, stride,
                                       dilation_growth ** (n % max(dilation_cycle, 1))))
        w1, b1 = _fold_bn(w1, sd.get(f"{base}.conv1.bias"), sd, f"{base}.norm1")
        out[f"block_{n}.conv1.weight"], out[f"block_{n}.conv1.bias"] = w1, b1
        alpha = sd.get(f"{base}.act1.weight", np.full((out_ch,), 0.25, np.float32))
        out[f"block_{n}.prelu_alpha"] = alpha.reshape(-1)
        wr, br = _fold_bn(sd[f"{base}.res_conv.weight"], sd.get(f"{base}.res_conv.bias"), sd,
                          f"{base}.res_norm")
        out[f"block_{n}.res_conv.weight"], out[f"block_{n}.res_conv.bias"] = wr, br

    wo = sd["output.weight"] if "output.weight" in sd else sd["output.0.weight"]
    bo = sd.get("output.bias", sd.get("output.0.bias"))
    noutputs = wo.shape[0]
    out["output.weight"] = wo
    out["output.bias"] = bo if bo is not None else np.zeros(noutputs, np.float32)
    cfg = DsTCNConfig(sample_rate=sample_rate, noutputs=noutputs, blocks=tuple(blocks))
    return cfg, {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in out.items()}


def dstcn_state_dict_from_tree(tree: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's flax tree (conv kernels (k, in, out)) -> the `DsTCN`
    state dict (weights (out, in, k))."""
    sd = {}
    for path, x in flatten_tree(tree).items():
        y = torch.as_tensor(np.asarray(x, np.float32))
        if path[-1] == "kernel":
            path, y = path[:-1] + ("weight",), y.permute(2, 1, 0).contiguous()
        sd[".".join(path)] = y
    return sd


def dstcn_tree_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of `dstcn_state_dict_from_tree`: fp32 numpy leaves."""
    flat = {}
    for key, val in sd.items():
        path = tuple(key.split("."))
        x = val.detach().to(torch.float32).cpu().numpy()
        if path[-1] == "weight":
            path, x = path[:-1] + ("kernel",), np.ascontiguousarray(x.transpose(2, 1, 0))
        flat[path] = x
    return unflatten_tree(flat)


# ---------------- tracker ----------------


class WaveBeatModel:
    """A loaded dsTCN and upstream's prediction recipe
    (`predict_beats_from_array`): resample to the model's rate,
    peak-normalize, forward on the device, sigmoid, peak-pick beats and
    downbeats."""

    _PAD_GRID = 65536  # the JAX package's padding grid (about 3 s at 22.05 kHz)

    def __init__(self, config: DsTCNConfig, state_dict: Dict[str, torch.Tensor],
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.model = DsTCN(config, device="meta").to_empty(device=self.device)
        self.model.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32)
                                    for k, v in state_dict.items()})
        self.model.requires_grad_(False).eval()

    def to(self, device) -> "WaveBeatModel":
        self.device = resolve_device(device)
        self.model.to(self.device)
        return self

    @classmethod
    def from_checkpoint(cls, path, device="cuda") -> "WaveBeatModel":
        """A `.vtpu` (either package's) or a Lightning `.pth`/`.ckpt` file."""
        from .checkpoints import load_wavebeat

        cfg, sd = load_wavebeat(path)
        return cls(cfg, sd, device)

    @torch.inference_mode()
    def activations(self, samples: np.ndarray, sr: int) -> np.ndarray:
        """(t,) float audio -> (t', noutputs) beat/downbeat probabilities."""
        import scipy.signal

        x = np.asarray(samples, np.float32).reshape(-1)
        if sr != self.config.sample_rate:
            g = math.gcd(int(self.config.sample_rate), int(sr))
            x = scipy.signal.resample_poly(
                x, self.config.sample_rate // g, int(sr) // g).astype(np.float32)
        peak = np.abs(x).max()
        if peak > 0:
            x = x / peak
        n = len(x)
        padded = max(self._PAD_GRID, int(np.ceil(n / self._PAD_GRID)) * self._PAD_GRID)
        xp = np.zeros(padded, np.float32)
        xp[:n] = x
        acts = torch.sigmoid(self.model(torch.from_numpy(xp).to(self.device)[None]))[0]
        return acts[: n // self.config.total_stride].cpu().numpy()

    def predict_beats_from_array(self, samples: np.ndarray, sr: int,
                                 threshold: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
        acts = self.activations(samples, sr)
        fps = self.config.frame_rate
        beats = pick_peaks(acts[:, 0], fps, threshold, max_bpm=240.0)
        downbeats = pick_peaks(acts[:, 1] if acts.shape[1] > 1 else acts[:, 0],
                               fps, threshold, max_bpm=120.0)
        return beats, downbeats


def pick_peaks(activation: np.ndarray, frame_rate: float, threshold: float = 0.5,
               max_bpm: float = 240.0) -> np.ndarray:
    """Frame activations -> event times in seconds: find_peaks above
    `threshold` with a refractory distance of one minimum inter-event
    interval (the wavebeat evaluation's peak picker)."""
    import scipy.signal

    distance = max(1, int(round(frame_rate * 60.0 / max_bpm)))
    peaks, _ = scipy.signal.find_peaks(activation, height=threshold, distance=distance)
    return peaks.astype(np.float64) / frame_rate
