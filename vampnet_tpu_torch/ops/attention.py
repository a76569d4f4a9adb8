"""Attention with an additive relative-position bias (counterpart of
`vampnet_tpu/ops/attention.py`).

`dot_product_attention` dispatches like the JAX function does with
`impl="auto"`: on the accelerator it takes the hand-written kernels
(`ops/flash_attention.py`): the inference kernel, the port of the Pallas
`_attn_kernel_dt`, or, when an input requires grad, the differentiable
`_AttentionCore` (forward-with-lse and backward kernels, the port of the
custom VJP `_attention_core`). Elsewhere it takes the plain version below,
which has the math of the JAX XLA path and which autograd differentiates.
The JAX function's `mask` argument is not ported: the serving path never
passes one.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v with fp32 scores, the probabilities
    cast to v's dtype before the PV product, fp32 accumulation, output in v's
    dtype. q, k, v: (b, t, h, d); bias: (h, t_q, t_k)."""
    d = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale.to(q.device)
    if bias is not None:
        scores = scores + bias[None].float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: (b, t, h, d); bias: (h, t, t) head-shared. CUDA tensors go
    through the attention kernels (the trainable Function when grad is
    needed), CPU tensors through `attention_plain`."""
    if q.is_cuda:
        from .flash_attention import flash_attention_with_bias

        return flash_attention_with_bias(q, k, v, bias)
    return attention_plain(q, k, v, bias)
