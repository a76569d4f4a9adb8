"""The LAC codec's snake activation with the bias of the convolution before
it and the residual add folded in, as one pass (`csrc/snake.cu`), and its
plain PyTorch version.

For a convolution's output without its bias, y (b, c, t), that bias (c,),
the snake's alpha (c,) and optionally the residual input res (b, c, t):

    x = res + (y + bias[c])        (y + bias[c] where there is no residual)
    s = x + (1 / (alpha[c] + 1e-9)) * sin(alpha[c] x)^2

`snake_fused` returns s, or (x, s) with `keep_sum` (a residual unit's input
is also its own residual). The plain version is the eager chain the codec's
modules run: the bias added after the convolution (as PyTorch's CUDA
convolution adds it, apart from cuDNN), the residual add, then
`modules.activations.snake`. On the card the kernel gives the same fp32 bits
as that chain.

fp32 only. The bf16 and fp16 codecs (`compute_dtype`) keep the eager chain:
the kernel does not reproduce its rounding to those types after every step.

`snake_fused` takes the plain version for CPU tensors and the kernel for
CUDA tensors (or raises); `snake_fused.launches` counts the kernel's calls.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..modules.activations import snake
from . import build


def snake_fused_plain(y: torch.Tensor, bias: torch.Tensor, alpha: torch.Tensor,
                      residual: Optional[torch.Tensor] = None, keep_sum: bool = False):
    """The kernel's function as the eager chain computes it."""
    x = y + bias[:, None]
    if residual is not None:
        x = residual + x
    s = snake(x, alpha[None, :, None])
    return (x, s) if keep_sum else s


def snake_fused(y: torch.Tensor, bias: torch.Tensor, alpha: torch.Tensor,
                residual: Optional[torch.Tensor] = None, keep_sum: bool = False):
    """y (b, c, t), bias (c,), alpha (c,), residual None or (b, c, t), all
    fp32 on one device -> s (b, c, t), or (x, s) with `keep_sum`."""
    if (y.dim() != 3 or bias.shape != (y.shape[1],) or alpha.shape != (y.shape[1],)
            or (residual is not None and residual.shape != y.shape)):
        raise ValueError(f"the snake takes y (b, c, t), bias and alpha (c,) and a residual "
                         f"like y, got {tuple(y.shape)}, {tuple(bias.shape)}, "
                         f"{tuple(alpha.shape)} and "
                         f"{None if residual is None else tuple(residual.shape)}")
    tensors = (y, bias, alpha) + (() if residual is None else (residual,))
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError(f"the snake takes fp32 tensors, got {[x.dtype for x in tensors]}")
    if any(x.device != y.device for x in tensors):
        raise ValueError(f"the snake's tensors must lie on one device, got "
                         f"{[str(x.device) for x in tensors]}")
    if y.device.type == "cpu":
        return snake_fused_plain(y, bias, alpha, residual, keep_sum)
    if not y.is_cuda:
        raise ValueError(f"the snake runs on the CPU or a CUDA device, got {y.device}")
    build.refuse_grad("snake", *tensors)
    y, bias, alpha = y.contiguous(), bias.contiguous(), alpha.contiguous()
    residual = None if residual is None else residual.contiguous()
    out = torch.empty_like(y)
    total = torch.empty_like(y) if keep_sum else None
    if y.numel():
        b, c, t = y.shape
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = build.library().vampnet_snake(
            y.data_ptr(), bias.data_ptr(), alpha.data_ptr(),
            None if residual is None else residual.data_ptr(),
            None if total is None else total.data_ptr(), out.data_ptr(), b * c, c, t,
            y.device.index or 0, stream)
        build.check(rc, "snake")
        snake_fused.launches += 1
    return (total, out) if keep_sum else out


snake_fused.launches = 0
