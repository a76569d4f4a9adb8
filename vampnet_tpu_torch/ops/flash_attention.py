"""Attention forward kernel for Hopper (`csrc/attention_fwd.cu`) and its
plain PyTorch version.

Replaces the Pallas inference kernel `_attn_kernel_dt`
(`vampnet_tpu/ops/flash_attention.py:120`, launched by `_fwd_call_dt`
`:185`), which every layer of every MaskGIT step runs on the TPU. Same
function: softmax_2(q_s k^T + b_2) v, where
  * q_s = bf16(q * scale * log2(e)), the product taken in fp32;
  * b_2 = bias * log2(e), rounded back to the bias dtype (bf16 or fp32),
    the bias head-shared (h, t, t);
  * keys past t are excluded (the JAX side pads them with -1e9);
  * QK^T and PV accumulate in fp32, P enters PV as bf16, and the division by
    the row sum comes after PV.
The layout is the port's public one, (b, t, h, d), with d = 64.

What bounds it on an H100: per coarse layer call (b=2, t=861, h=20) q, k, v
and o are 4 x 2.2 MB of bf16 and the head-shared bias 29.6 MB in bf16 (59 MB
in fp32): about 38 MB, 11 us at 3.35 TB/s. The products are 7.6 GFLOP, 8 us
at 989 TFLOP/s. So the bias read bounds it, and the kernel reads the bias
exactly once per batch row and never writes a (t, t) tensor.

What the design does about it: the TPU kernel holds a whole (t_p, t_p) score
tile per program in 100 MB of VMEM; an SM has 227 KB. So one block of four
warps takes 64 query rows of one (batch, head) and streams keys in tiles of
64 with an online softmax in base 2 (running max and row sum in registers).
Products are `mma.sync` m16n8k16 bf16 with fp32 accumulators; the bias is
read straight from device memory into the score fragments and prefolded
there, so no prefolded copy of it is ever written. TMA, `wgmma` and
double-buffered tiles are left for a later change.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

LOG2E = 1.4426950408889634
HEAD_DIM = 64


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, step for step as the Pallas
    path computes it (prefolds, base-2 softmax, normalise after PV)."""
    d = q.shape[-1]
    qs = (q.float() * (LOG2E / math.sqrt(d))).to(q.dtype).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    if bias is not None:
        b2 = (bias.float() * LOG2E).to(bias.dtype).float()
        scores = scores + b2[None]
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp2(scores - m)
    l = p.sum(dim=-1, keepdim=True)  # (b, h, q, 1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (acc / l.permute(0, 2, 1, 3)).to(v.dtype)


def _check(q, k, v, bias):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the attention kernel takes bf16 q/k/v, got {q.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (b, t, h, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the attention kernel takes d = {HEAD_DIM}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if bias is not None:
        if bias.device != q.device or bias.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError("bias must be a bf16 or fp32 tensor on q's device")
        if tuple(bias.shape) != (h, t, t) or not bias.is_contiguous():
            raise ValueError(f"bias must be a contiguous ({h}, {t}, {t}) tensor, "
                             f"got {tuple(bias.shape)}")


def flash_attention_with_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: (b, t, h, d=64) bf16; bias: (h, t, t) bf16 or fp32 or None.
    CPU tensors take `attention_fwd_plain`; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, bias)
    _check(q, k, v, bias)
    from . import build

    b, t, h, d = q.shape
    if bias is None:
        bias = torch.zeros((h, t, t), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = build.library().vampnet_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        int(bias.dtype == torch.bfloat16), out.data_ptr(), b, t, h, d,
        LOG2E / math.sqrt(d), q.device.index or 0, stream,
    )
    build.check(rc, "attention")
    flash_attention_with_bias.launches += 1
    return out


flash_attention_with_bias.launches = 0
