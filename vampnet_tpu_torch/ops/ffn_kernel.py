"""Fused RMSNorm + GEGLU feed-forward + residual for Hopper (`csrc/ffn.cu`)
and its plain PyTorch version.

Replaces the Pallas kernel `_ffn_kernel` in `vampnet_tpu/ops/ffn_kernel.py:44`
(`fused_geglu_ffn` `:73`), which the JAX package runs once per layer per
MaskGIT step under `LMConfig(ffn_impl="fused")`. The function:

    y        = (x * rsqrt(mean(x^2) + eps) * nw).to(x.dtype)   fp32 statistics
    [p1, p2] = y @ w1[:2d]^T, y @ w1[2d:]^T                  fp32 accumulation
    g        = (p1 * gelu_tanh(p2)).to(x.dtype)              fp32
    out      = (x + g @ w2^T).to(x.dtype)                    fp32 accumulation and add

with w1 (2f, d) and w2 (d, f) in the port's (out, in) layout, f = 2d hidden
units for a whole layer: rows [0, f) of w1 are the value and rows [f, 2f)
the gate, as `jnp.split` cuts the JAX (d, 4d) kernel's columns. The hidden
products accumulate in fp32, where the unfused path rounds them to bf16, so
the two paths differ at bf16 resolution (as in the JAX package).

A tensor-parallel shard (`Interface.shard(tp=)`) calls it with its f = 2d/tp
units: its block of the value rows and the same block of the gate rows, and
w2's matching columns. Its output is then a partial sum of the layer's, and
`residual=False` leaves x out of it, so that x is added once, by one shard.

What bounds it on an H100: 2 m d 6d operations, 33.9 GFLOP at the coarse
serving shape (m = 1,724, d = 1280), 34 us at 989 TFLOP/s; 40.7 GFLOP (41 us)
at c2f (m = 2,072). The bytes (x, out and the 19.7 MB of weights) take 7 us.

What the design does about the TPU's layout: the TPU kernel carries a
(rows, d) fp32 accumulator across the hidden sweep in VMEM (320 KB for 64
rows at d = 1280), more than an SM holds. Here the call is three kernels on
one stream: a row pass writes y = RMSNorm(x) (m, d) bf16 to scratch; a
persistent warp-specialised GEMM (TMA-fed bf16 `wgmma`, 128 x BN tiles)
takes y against the value and gate rows of w1 together, forms g = p1 *
gelu(p2) in its epilogue and writes g (m, 2d) bf16 to scratch, kept in L2;
a second GEMM of the same design takes g against w2 and adds the residual
in its epilogue. Each weight tile is read once per 128 rows, and the fp32
pre-activation never leaves registers. Both GEMMs start by programmatic
dependent launch, and BN is chosen per (m, n) so that the tiles fill whole
waves of SMs (`block_n` reports it). The count `fused_geglu_ffn.launches`
goes up by one per call (the three kernels).
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
                          w2: torch.Tensor, eps: float = 1e-6,
                          residual: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch, each product in fp32:
    x (..., d), norm_weight (d,), w1 (2f, d), w2 (d, f) -> x's shape and
    dtype; without `residual`, g w2^T alone."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps) * norm_weight.float()).to(dt)
    half = w1.shape[0] // 2
    w1f = w1.to(dt).float()
    p1 = y.float() @ w1f[:half].T
    p2 = y.float() @ w1f[half:].T
    g = (p1 * gelu_tanh(p2)).to(dt)
    out = g.float() @ w2.to(dt).float().T
    return (xf + out if residual else out).to(dt)


def check_args(x: torch.Tensor, norm_weight: torch.Tensor, w1: torch.Tensor,
               w2: torch.Tensor) -> None:
    """Raise on what the kernel does not take: x (..., d) bf16 with d a
    multiple of 128, norm_weight (d,), w1 (2f, d), w2 (d, f) with f a
    multiple of 64, all on x's device."""
    d = x.shape[-1]
    f = w2.shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the fused FFN kernel takes bf16 x, got {x.dtype}")
    if any(t.device != x.device for t in (norm_weight, w1, w2)):
        raise ValueError("x and the FFN weights must lie on one CUDA device")
    if tuple(norm_weight.shape) != (d,) or tuple(w1.shape) != (2 * f, d) \
            or tuple(w2.shape) != (d, f):
        raise ValueError(f"want norm_weight ({d},), w1 ({2 * f}, {d}), w2 ({d}, {f}); got "
                         f"{tuple(norm_weight.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}")
    if d == 0 or d % 128:
        raise ValueError(f"the fused FFN kernel takes d a multiple of 128, got {d}")
    if f == 0 or f % 64:
        raise ValueError(f"the fused FFN kernel takes f a multiple of 64, got {f}")


def fused_geglu_ffn(x: torch.Tensor, norm_weight: torch.Tensor, w1: torch.Tensor,
                    w2: torch.Tensor, eps: float = 1e-6, residual: bool = True) -> torch.Tensor:
    """x + FeedForward(RMSNorm(x)) in one call (FeedForward(RMSNorm(x))
    alone without `residual`): x (..., d) bf16, d a multiple of 128, w1
    (2f, d), w2 (d, f). Forward-only. CPU tensors take
    `fused_geglu_ffn_plain`; CUDA tensors launch the kernels and count the
    call."""
    if x.device.type == "cpu":
        return fused_geglu_ffn_plain(x, norm_weight, w1, w2, eps, residual)
    build.refuse_grad("fused FFN", x, norm_weight, w1, w2)
    check_args(x, norm_weight, w1, w2)
    d, f = x.shape[-1], w2.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    m = x2.shape[0]
    # bf16 norm weights widen to fp32 exactly inside the kernel
    nw = norm_weight.contiguous() if norm_weight.dtype == torch.bfloat16 \
        else norm_weight.float().contiguous()
    w1c = w1.to(torch.bfloat16).contiguous()
    w2c = w2.to(torch.bfloat16).contiguous()
    if any(t.data_ptr() % 16 for t in (x2, nw, w1c, w2c)):
        raise ValueError("x, norm_weight, w1 and w2 must be 16-byte aligned")
    # scratch: the normalised rows y and the gated hidden activations g
    y = torch.empty((m, d), dtype=torch.bfloat16, device=x.device)
    g = torch.empty((m, f), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x2)
    rc = build.library().vampnet_geglu_ffn(
        x2.data_ptr(), nw.data_ptr(), int(nw.dtype == torch.bfloat16), w1c.data_ptr(),
        w2c.data_ptr(), y.data_ptr(),
        g.data_ptr(), out.data_ptr(), m, d, f, int(residual), float(eps), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "fused FFN")
    fused_geglu_ffn.launches += 1
    return out.reshape(x.shape)


fused_geglu_ffn.launches = 0


def block_n(m: int, d: int, device=None, f: int = None) -> tuple:
    """The tile widths (up-projection, down-projection) of the two GEMMs at
    (m, d) and f hidden units (2d by default) on a CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    lib = build.library()
    f = 2 * d if f is None else f
    return tuple(lib.vampnet_geglu_ffn_block_n(m, d, f, up, dev.index or 0) for up in (1, 0))
