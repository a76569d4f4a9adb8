"""Attention with an additive relative-position bias and an optional mask
(counterpart of `vampnet_tpu/ops/attention.py`).

`dot_product_attention(..., impl=)` takes the JAX function's routes:
  * "auto" and "pallas": the hand-written kernels (`ops/flash_attention.py`)
    for CUDA tensors, at every t: the inference kernels, or, when an input
    requires grad, the differentiable `_AttentionCore` (forward-with-lse and
    backward kernels, the port of the custom VJP `_attention_core`). JAX's
    "auto" sends t > 1024 to XLA on its chip, because its blocked long
    kernel has no VJP and its single-pass kernels hold the whole sequence in
    VMEM; the card's kernels stream keys and are trainable at any t, so the
    port keeps them there. On CPU tensors "auto" takes `attention_plain`,
    which has the math of the JAX XLA path and which autograd differentiates,
    and "pallas" the kernels' plain versions (the Pallas path's math).
  * "xla": the library route, the counterpart of JAX's non-Pallas route:
    one `F.scaled_dot_product_attention` call with the bias and the folded
    mask as a float `attn_mask`. It is taken only when a config asks for it.
  * "ring": sequence-parallel ring attention (`ops/ring_attention.py`). It
    needs every shard of the sequence at once, so it runs inside a
    `RingStack` (`modules/transformer.py`, set up by `Interface.shard(sp=)`),
    never through this function, which raises for it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

IMPLS = ("auto", "pallas", "xla", "ring")
MASK_FILL = -1e9  # the JAX package's fill for a blocked score


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v with fp32 scores, the probabilities
    cast to v's dtype before the PV product, fp32 accumulation, output in v's
    dtype. q: (b, t_q, h, d); k, v: (b, t_k, h, d); bias: (h, t_q, t_k);
    mask: (b, t_q, t_k) or (b, 1, t_q, t_k), 0 = blocked, whose scores become
    -1e9 after the bias; `window` w drops the keys with |i - j| > w."""
    d = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale.to(q.device)
    if bias is not None:
        scores = scores + bias[None].float()
    if mask is not None:
        if mask.dim() == 3:
            mask = mask[:, None]
        scores = torch.where(mask == 0, torch.tensor(MASK_FILL, device=q.device), scores)
    if window is not None:
        from .flash_attention import band

        scores = scores.masked_fill(~band(q.shape[1], k.shape[1], window, q.device),
                                    float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def attention_library(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The "xla" route: one `F.scaled_dot_product_attention` call, in q's
    dtype, with `where(mask, bias, -1e9)` (or the bias alone) as its float
    `attn_mask`, broadcast over the batch where there is no mask."""
    attn_mask = None
    if bias is not None:
        attn_mask = bias[None].to(q.dtype)
    if mask is not None:
        if mask.dim() == 3:
            mask = mask[:, None]
        base = attn_mask if attn_mask is not None else torch.zeros((), dtype=q.dtype,
                                                                     device=q.device)
        attn_mask = torch.where(mask != 0, base, torch.tensor(MASK_FILL, dtype=q.dtype,
                                                              device=q.device))
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), attn_mask=attn_mask)
    return out.transpose(1, 2)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None,
                          impl: str = "auto", window: Optional[int] = None) -> torch.Tensor:
    """q, k, v: (b, t, h, d); bias: (h, t, t) head-shared; mask: (b, t, t) or
    (b, 1, t, t), 0 = blocked. Without a bias or mask, k and v may be
    (b, t_k, h, d), and `window` w keeps the keys with |i - j| <= w (the
    kernels' inference route, `attention_plain` on the CPU). Routes by
    `impl` as the module docstring says."""
    if impl == "ring":
        raise RuntimeError(
            "attention_impl='ring' runs only in a ring context: a RingStack over an sp mesh "
            "(Interface.shard(sp=N), or VampNetLM.forward(stack=RingStack(lm, devices)))")
    if impl == "xla":
        if window is not None:
            raise ValueError("the library route takes no window")
        return attention_library(q, k, v, bias, mask)
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}, got {impl!r}")
    if q.is_cuda or impl == "pallas":
        from .flash_attention import flash_attention_with_bias

        return flash_attention_with_bias(q, k, v, bias, mask, window)
    return attention_plain(q, k, v, bias, mask, window)
