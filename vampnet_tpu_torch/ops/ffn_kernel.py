"""Fused RMSNorm + GEGLU feed-forward + residual for Hopper (`csrc/ffn.cu`)
and its plain PyTorch version.

Replaces the Pallas kernel `_ffn_kernel` in `vampnet_tpu/ops/ffn_kernel.py:44`
(`fused_geglu_ffn` `:73`), which the JAX package runs once per layer per
MaskGIT step under `LMConfig(ffn_impl="fused")`. The function:

    y        = (x * rsqrt(mean(x^2) + eps) * nw).to(x.dtype)   fp32 statistics
    [p1, p2] = y @ w1[:2d]^T, y @ w1[2d:]^T                  fp32 accumulation
    g        = (p1 * gelu_tanh(p2)).to(x.dtype)              fp32
    out      = (x + g @ w2^T).to(x.dtype)                    fp32 accumulation and add

with w1 (4d, d) and w2 (d, 2d) in the port's (out, in) layout: rows [0, 2d)
of w1 are the value and rows [2d, 4d) the gate, as `jnp.split` cuts the JAX
(d, 4d) kernel's columns. The hidden products accumulate in fp32, where the
unfused path rounds them to bf16, so the two paths differ at bf16
resolution (as in the JAX package).

What bounds it on an H100: 2 m d 6d operations, 33.9 GFLOP at the coarse
serving shape (m = 1,724, d = 1280), 34 us at 989 TFLOP/s; 40.7 GFLOP (41 us)
at c2f (m = 2,072). The bytes (x, out and the 19.7 MB of weights) take 7 us.

What the design does about the TPU's layout: the TPU kernel carries a
(rows, d) fp32 accumulator across the hidden sweep in VMEM (320 KB for 64
rows at d = 1280). Here a block of 8 warps owns 16 rows and keeps the
accumulator in registers, split by output column across the warps; the
normalised rows stay in shared memory; w1 and w2 stream from L2 straight
into the tensor-core operands. Each block reads every weight once, so the
whole grid reads them m/16 times from L2: the kernel is right and simple,
not fast (see PERF.md).
"""
from __future__ import annotations

import math

import torch

from . import build


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """x * 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), as `jax.nn.gelu`
    writes the approximate form."""
    return x * (0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * (x * x * x)))))


def fused_geglu_ffn_plain(x: torch.Tensor, norm_weight: torch.Tensor, w1: torch.Tensor,
                          w2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain PyTorch, each product in fp32:
    x (..., d), norm_weight (d,), w1 (4d, d), w2 (d, 2d) -> x's shape and dtype."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps) * norm_weight.float()).to(dt)
    half = w1.shape[0] // 2
    w1f = w1.to(dt).float()
    p1 = y.float() @ w1f[:half].T
    p2 = y.float() @ w1f[half:].T
    g = (p1 * gelu_tanh(p2)).to(dt)
    return (xf + g.float() @ w2.to(dt).float().T).to(dt)


def fused_geglu_ffn(x: torch.Tensor, norm_weight: torch.Tensor, w1: torch.Tensor,
                    w2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x + FeedForward(RMSNorm(x)) in one kernel: x (..., d) bf16, d a
    multiple of 128 up to 1280. Forward-only. CPU tensors take
    `fused_geglu_ffn_plain`; CUDA tensors launch the kernel and count it."""
    if x.device.type == "cpu":
        return fused_geglu_ffn_plain(x, norm_weight, w1, w2, eps)
    build.refuse_grad("fused FFN", x, norm_weight, w1, w2)
    d = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the fused FFN kernel takes bf16 x, got {x.dtype}")
    if any(t.device != x.device for t in (norm_weight, w1, w2)):
        raise ValueError("x and the FFN weights must lie on one CUDA device")
    if tuple(norm_weight.shape) != (d,) or tuple(w1.shape) != (4 * d, d) \
            or tuple(w2.shape) != (d, 2 * d):
        raise ValueError(f"want norm_weight ({d},), w1 ({4 * d}, {d}), w2 ({d}, {2 * d}); got "
                         f"{tuple(norm_weight.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}")
    if d % 128 or d > 1280:
        raise ValueError(f"the fused FFN kernel takes d a multiple of 128 up to 1280, got {d}")
    x2 = x.reshape(-1, d).contiguous()
    nw = norm_weight.float().contiguous()
    w1c = w1.to(torch.bfloat16).contiguous()
    w2c = w2.to(torch.bfloat16).contiguous()
    out = torch.empty_like(x2)
    rc = build.library().vampnet_geglu_ffn(
        x2.data_ptr(), nw.data_ptr(), w1c.data_ptr(), w2c.data_ptr(), out.data_ptr(),
        x2.shape[0], d, float(eps), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "fused FFN")
    fused_geglu_ffn.launches += 1
    return out.reshape(x.shape)


fused_geglu_ffn.launches = 0
