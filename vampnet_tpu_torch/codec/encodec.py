"""The EnCodec 32 kHz decoder that MAGNeT and MusicGen decode with
(audiocraft's `encodec_32khz`: `ResidualVectorQuantizer` and
`SEANetDecoder`). No JAX counterpart. Decoding only: the serving path turns
generated codes into audio and never encodes.

  * RVQ: 4 codebooks of 2,048 x 128; a frame's vectors are summed.
  * SEANet decoder, non-causal, weight norm throughout:
      conv k7 128 -> 1,024;
      a 2-layer LSTM over time with a skip (y = lstm(x) + x);
      4 blocks, ratios 8, 5, 4, 4, channels halving 1,024 -> 64: ELU, a
        transposed conv (k = 2 r, stride r, its r extra samples cut as
        audiocraft cuts them: r - r // 2 on the left, r // 2 on the right),
        and one residual unit (ELU, conv k3 to half the channels, ELU, conv
        k1 back, identity skip);
      ELU, conv k7 64 -> 1.
    Stride-1 convs pad (k - 1) / 2 zeros on each side (`pad_mode`
    "constant"). The hop is 8 * 5 * 4 * 4 = 640 samples: 50 frames a second.

The convolutions are `WNConv1d` / `WNConvTranspose1d` (`codec/layers.py`,
the LAC codec's) and the LSTM is `nn.LSTM`; all compute in fp32 with TF32
off (`no_tf32`), as the LAC codec does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import WNConv1d, WNConvTranspose1d, no_tf32


@dataclasses.dataclass(frozen=True)
class EncodecConfig:
    sample_rate: int = 32000
    dimension: int = 128
    n_filters: int = 64
    ratios: Tuple[int, ...] = (8, 5, 4, 4)
    n_q: int = 4
    bins: int = 2048
    lstm_layers: int = 2
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    compress: int = 2

    @property
    def hop_length(self) -> int:
        return math.prod(self.ratios)


class ResidualUnit(nn.Module):
    def __init__(self, dim: int, kernel_size: int, compress: int, device=None):
        super().__init__()
        hidden = dim // compress
        self.conv1 = WNConv1d(dim, hidden, kernel_size, padding=(kernel_size - 1) // 2,
                              device=device)
        self.conv2 = WNConv1d(hidden, dim, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.elu(self.conv1(F.elu(x))))


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, ratio: int, cfg: EncodecConfig, device=None):
        super().__init__()
        self.ratio = ratio
        self.up = WNConvTranspose1d(dim, dim // 2, 2 * ratio, stride=ratio, device=device)
        self.res = ResidualUnit(dim // 2, cfg.residual_kernel_size, cfg.compress, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.up(F.elu(x))
        r = self.ratio
        left, right = r - r // 2, r // 2
        return self.res(y[..., left:y.shape[-1] - right])


class SEANetDecoder(nn.Module):
    def __init__(self, cfg: EncodecConfig, device=None):
        super().__init__()
        mult = 2 ** len(cfg.ratios)
        dim = mult * cfg.n_filters
        k = cfg.kernel_size
        self.conv_in = WNConv1d(cfg.dimension, dim, k, padding=(k - 1) // 2, device=device)
        self.lstm = nn.LSTM(dim, dim, cfg.lstm_layers, device=device)
        blocks = []
        for ratio in cfg.ratios:
            blocks.append(DecoderBlock(dim, ratio, cfg, device=device))
            dim //= 2
        self.blocks = nn.ModuleList(blocks)
        k = cfg.last_kernel_size
        self.conv_out = WNConv1d(dim, 1, k, padding=(k - 1) // 2, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z (b, dimension, frames) -> audio (b, 1, frames * hop)."""
        x = self.conv_in(z)
        y, _ = self.lstm(x.permute(2, 0, 1))
        x = (y + x.permute(2, 0, 1)).permute(1, 2, 0)
        for block in self.blocks:
            x = block(x)
        return self.conv_out(F.elu(x))


class EncodecDecoder(nn.Module):
    def __init__(self, cfg: EncodecConfig, device=None):
        super().__init__()
        self.config = cfg
        self.codebooks = nn.Parameter(torch.empty(cfg.n_q, cfg.bins, cfg.dimension,
                                                  device=device))
        self.decoder = SEANetDecoder(cfg, device=device)

    def dequantize(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (b, n_q, frames) -> the summed codebook vectors (b, dimension,
        frames), fp32."""
        z = self.codebooks[0][codes[:, 0]]
        for k in range(1, codes.shape[1]):
            z = z + self.codebooks[k][codes[:, k]]
        return z.transpose(1, 2)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (b, n_q, frames) int -> audio (b, 1, frames * hop) fp32."""
        with no_tf32():
            return self.decoder(self.dequantize(codes.long()).float())
