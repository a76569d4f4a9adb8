"""Weight-normalised conv layers and the snake activation (counterpart of
`vampnet_tpu/codec/layers.py`, `conv_impl="xla"` semantics).

Weight norm is the explicit (g, v) pair of torch's `weight_norm` (norm over
every axis but the first), recomputed per call: w = g / (||v|| + 1e-12) * v.
The stored layouts are the JAX package's, which are already torch's:
v is (out, in, k) for a conv and (in, out, k) for a transposed conv.

These layers run channels-first (b, c, t), PyTorch's own layout; the codec's
public functions (`codec/model.py`) take and return channels-last tensors
as the JAX package does. Convolutions are fp32 and run with cuDNN's TF32
off (`no_tf32` below): the encoder decides the discrete codes, and TF32 can
flip a nearest-neighbour choice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..modules.activations import snake


def no_tf32():
    """cuDNN in full fp32 for the enclosed convolutions, without touching
    the process-wide setting."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def _weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=1)
    return (g / (norm + 1e-12))[:, None, None] * v


class Snake1d(nn.Module):
    """Snake with a learned per-channel alpha, channels-first."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha[None, :, None])


class WNConv1d(nn.Module):
    """weight_norm(Conv1d): v (out, in, k), g (out,), bias (out,)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1, device=None):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.v = nn.Parameter(torch.empty(features, in_features, kernel_size, device=device))
        self.g = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, _weight_norm(self.v, self.g), self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation)


class WNConvTranspose1d(nn.Module):
    """weight_norm(ConvTranspose1d): v (in, out, k), g (in,), bias (out,).
    Output length (T - 1) * stride - 2 * padding + k."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.v = nn.Parameter(torch.empty(in_features, features, kernel_size, device=device))
        self.g = nn.Parameter(torch.empty(in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, _weight_norm(self.v, self.g), self.bias,
                                  stride=self.stride, padding=self.padding)
