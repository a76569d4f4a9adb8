"""Weight-normalised conv layers and the snake activation (counterpart of
`vampnet_tpu/codec/layers.py`).

Weight norm is the explicit (g, v) pair of torch's `weight_norm` (norm over
every axis but the first), recomputed per call: w = g / (||v|| + 1e-12) * v.
The stored layouts are the JAX package's, which are already torch's:
v is (out, in, k) for a conv and (in, out, k) for a transposed conv.

These layers run channels-first (b, c, t), PyTorch's own layout; the codec's
public functions (`codec/model.py`) take and return channels-last tensors
as the JAX package does. Each conv computes in its `dtype` (fp32 by default,
bf16 as an option) and has two schedules, selected by `impl` as in JAX:

  * "xla"    — cuDNN's convolution (`F.conv1d`, `F.conv_transpose1d`);
  * "matmul" — the convolutions as plain matmuls:
               - k = 1: one product;
               - stride 1, dilation d, narrow channels (c_in < 128): im2col
                 over the k taps, one (k c_in)-deep product;
               - stride 1, wide channels: k shifted products, summed;
               - stride s, k = 2s (the downsamplers): the input framed into
                 s-sample frames, each output reading two adjacent frames;
               - transposed, stride s, k = 2s: polyphase, one
                 (c_in) -> (2s c_out) product and a two-frame overlap-add, no
                 zero-inserted input.
The parameters are the same for both schedules; only the order of the
arithmetic changes. fp32 runs with TF32 off for cuDNN and cuBLAS alike
(`no_tf32` below): the encoder decides the discrete codes, and TF32 can flip
a nearest-neighbour choice.

For the LAC codec's fused route (`codec/model.py`), each conv also runs
without its bias (`forward_nobias`), and `Snake1d.fused` adds the bias, and
the residual where there is one, in the snake's own pass (`ops/snake.py`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..modules.activations import snake
from ..ops.snake import snake_fused

IMPLS = ("xla", "matmul")

_tf32_lock = threading.Lock()
_tf32_depth = [0]
_tf32_saved = [None]


@contextlib.contextmanager
def no_tf32():
    """Full fp32 for the enclosed convolutions and matmuls: TF32 off in cuDNN
    and in cuBLAS. The process-wide flags are restored when the last of any
    overlapping callers (threads of the serving stack) leaves."""
    with _tf32_lock:
        if _tf32_depth[0] == 0:
            _tf32_saved[0] = (torch.backends.cudnn.allow_tf32,
                              torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_depth[0] += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_depth[0] -= 1
            if _tf32_depth[0] == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _tf32_saved[0]


def _weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=1)
    return (g / (norm + 1e-12))[:, None, None] * v


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"conv impl must be one of {IMPLS}, got {impl!r}")


def conv1d_matmul(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
                  dilation: int) -> torch.Tensor:
    """Correlation conv as matmuls. x (b, c_in, t), w (out, in, k), the
    effective weight; returns (b, c_out, t_out) as `F.conv1d` with the same
    stride, padding and dilation (no bias)."""
    b, c_in, _ = x.shape
    c_out, _, k = w.shape
    if k == 1 and stride == 1 and padding == 0:
        return torch.matmul(w[:, :, 0], x)
    xp = F.pad(x, (padding, padding))
    tp = xp.shape[-1]
    if stride == 1:
        t_out = tp - (k - 1) * dilation
        if c_in < 128:
            # im2col, taps-major and channel-minor, one (k c_in)-deep product
            cols = torch.cat([xp[:, :, j * dilation: j * dilation + t_out] for j in range(k)],
                             dim=1)
            return torch.matmul(w.permute(0, 2, 1).reshape(c_out, k * c_in), cols)
        y = None
        for j in range(k):
            yj = torch.matmul(w[:, :, j], xp[:, :, j * dilation: j * dilation + t_out])
            y = yj if y is None else y + yj
        return y
    if dilation != 1 or k != 2 * stride:
        raise ValueError(f"the strided matmul conv takes k = 2 stride and no dilation, "
                         f"got k={k} stride={stride} dilation={dilation}")
    s = stride
    t_out = (tp - k) // s + 1
    # s-sample frames; output u reads frames u and u + 1
    n_frames = t_out + 1
    if n_frames * s > tp:
        xp = F.pad(xp, (0, n_frames * s - tp))
    frames = xp[:, :, : n_frames * s].reshape(b, c_in, n_frames, s)
    g = torch.cat([frames[:, :, :-1], frames[:, :, 1:]], dim=-1)  # (b, c_in, t_out, 2s)
    g = g.permute(0, 2, 1, 3).reshape(b, t_out, c_in * k)
    return torch.matmul(g, w.reshape(c_out, c_in * k).T).transpose(1, 2)


def conv_transpose1d_matmul(x: torch.Tensor, w: torch.Tensor, stride: int,
                            padding: int) -> torch.Tensor:
    """Polyphase transposed conv. x (b, c_in, t), w (in, out, k) with
    k = 2 stride; returns (b, c_out, (t - 1) s - 2 p + k) as
    `F.conv_transpose1d` (no bias): one product, then each input frame's two
    halves added into output frames t and t + 1."""
    b, _, t = x.shape
    c_in, c_out, k = w.shape
    s = stride
    if k != 2 * s:
        raise ValueError(f"the polyphase transposed conv takes k = 2 stride, got k={k} s={s}")
    a = torch.matmul(w.permute(1, 2, 0).reshape(c_out * k, c_in), x)  # (b, c_out k, t)
    a = a.reshape(b, c_out, 2, s, t).permute(0, 1, 2, 4, 3)  # (b, c_out, 2, t, s)
    full = F.pad(a[:, :, 0], (0, 0, 0, 1)) + F.pad(a[:, :, 1], (0, 0, 1, 0))
    full = full.reshape(b, c_out, (t + 1) * s)  # frame u holds outputs [u s, (u + 1) s)
    out_len = (t - 1) * s - 2 * padding + k
    return full[:, :, padding: padding + out_len]


class Snake1d(nn.Module):
    """Snake with a learned per-channel alpha, channels-first, in x's dtype."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha[None, :, None].to(x.dtype))

    def fused(self, pre: list, keep_sum: bool = False):
        """The snake of x = res + (y + bias) in one pass, for the pending
        pre = [y, bias, res or None]: a conv's output without its bias, that
        bias, and the residual. Returns s, or (x, s) with `keep_sum`. Empties
        `pre`, so that y and res are freed once the pass has read them,
        whoever else holds the list."""
        y, bias, res = pre
        pre.clear()
        return snake_fused(y, bias.to(y.dtype), self.alpha.to(y.dtype), res, keep_sum)


class WNConv1d(nn.Module):
    """weight_norm(Conv1d): v (out, in, k), g (out,), bias (out,); computes in
    `dtype` with the `impl` schedule (module docstring)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 dtype: torch.dtype = torch.float32, impl: str = "xla", device=None):
        super().__init__()
        _check_impl(impl)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype, self.impl = dtype, impl
        self.v = nn.Parameter(torch.empty(features, in_features, kernel_size, device=device))
        self.g = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.bias.to(self.dtype))

    def forward_nobias(self, x: torch.Tensor) -> torch.Tensor:
        """`forward` without the bias (the fused route adds it)."""
        return self._conv(x, None)

    def _conv(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        dt = self.dtype
        w = _weight_norm(self.v, self.g).to(dt)
        k = w.shape[-1]
        if self.impl == "matmul" and (self.stride == 1 or k == 2 * self.stride):
            y = conv1d_matmul(x.to(dt), w, self.stride, self.padding, self.dilation)
            return y if bias is None else y + bias[:, None]
        return F.conv1d(x.to(dt), w, bias, stride=self.stride, padding=self.padding,
                        dilation=self.dilation)


class WNConvTranspose1d(nn.Module):
    """weight_norm(ConvTranspose1d): v (in, out, k), g (in,), bias (out,).
    Output length (T - 1) * stride - 2 * padding + k; `dtype` and `impl` as
    `WNConv1d`."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dtype: torch.dtype = torch.float32,
                 impl: str = "xla", device=None):
        super().__init__()
        _check_impl(impl)
        self.stride, self.padding = stride, padding
        self.dtype, self.impl = dtype, impl
        self.v = nn.Parameter(torch.empty(in_features, features, kernel_size, device=device))
        self.g = nn.Parameter(torch.empty(in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.bias.to(self.dtype))

    def forward_nobias(self, x: torch.Tensor) -> torch.Tensor:
        """`forward` without the bias (the fused route adds it)."""
        return self._conv(x, None)

    def _conv(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        dt = self.dtype
        w = _weight_norm(self.v, self.g).to(dt)
        if self.impl == "matmul" and w.shape[-1] == 2 * self.stride:
            y = conv_transpose1d_matmul(x.to(dt), w, self.stride, self.padding)
            return y if bias is None else y + bias[:, None]
        return F.conv_transpose1d(x.to(dt), w, bias, stride=self.stride, padding=self.padding)
