"""Activation functions (counterpart of `vampnet_tpu/modules/activations.py`)."""
from __future__ import annotations

import math

import torch


def new_gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU, written out as the JAX package writes it."""
    return 0.5 * x * (
        1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0)))
    )


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha x) / alpha; `alpha` broadcasts over
    the channel axis of `x`."""
    return x + (1.0 / (alpha + 1e-9)) * torch.square(torch.sin(alpha * x))
