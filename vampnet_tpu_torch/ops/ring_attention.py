"""Ring attention over a sequence split into shards (counterpart of
`vampnet_tpu/ops/ring_attention.py`).

softmax(q K^T / sqrt(d) + T5 bias) V over the time axis split into n equal
shards, shard i's q, k and v on device i. At ring step s device i holds key
and value shard (i + s) mod n: it attends its queries to that shard, then
takes the next one from device i + 1 (the JAX `ppermute` with pairs
(j, j - 1), here a `.to()` onto device i). The bias block of each (query
shard, held key shard) pair comes from `bias_block(i, src)`, built from the
bucket table and the pair's global offsets (`RingStack.bias_block`), so
the (t, t) bias is never built.

Two versions, routed by the device of the tensors:
  * CUDA tensors: each ring step is one launch of the hand-written forward
    with lse (`attention_fwd_lse`, K2/K4's kernel, `csrc/attention_fwd.cu`)
    on (q shard, held shard, bias block): its output normalised over the
    block and the base-2 log-sum-exp of each query row. The blocks' results
    merge by their lse in fp32: with m = max(lse_a, lse_b),
    w = 2^(lse - m), out = (w_a out_a + w_b out_b) / (w_a + w_b) and
    lse = m + log2(w_a + w_b). That is the online softmax done one block at a
    time. An lse that is not finite (-inf) or is the kernel's sentinel for a
    row with no open key (`FULLY_BLOCKED_LSE`) weighs 0 beside a finite one;
    sentinels alone average, and a row whose every lse is -inf stays -inf
    with a zero output (no 0 / 0).
  * CPU tensors: `ring_attention_plain`, the JAX function's loop in torch:
    q prefolded by log2(e)/sqrt(d), base-2 scores in fp32 with the bias
    times log2(e), a running max m and sum l, an fp32 accumulator, P cast to
    v's dtype before the PV product.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch

from .flash_attention import LOG2E, attention_fwd_lse

BiasBlock = Callable[[int, int], Optional[torch.Tensor]]


def _ring_order(ks, vs, devices):
    """Yield, for each ring step, the key and value shards each device holds,
    passing them one device back round the ring between steps."""
    n = len(ks)
    held_k, held_v = list(ks), list(vs)
    for s in range(n):
        yield s, held_k, held_v
        if s < n - 1:
            held_k = [held_k[(i + 1) % n].to(devices[i]) for i in range(n)]
            held_v = [held_v[(i + 1) % n].to(devices[i]) for i in range(n)]


def _merge(state, out: torch.Tensor, lse: torch.Tensor):
    """Fold one block's (out (b, tl, h, d), lse (b*h, tl)) into the running
    (out fp32, lse (b, tl, h, 1) fp32) of its query shard."""
    b, tl, h, _ = out.shape
    lse = lse.reshape(b, h, tl).permute(0, 2, 1)[..., None].float()
    out = out.float()
    if state is None:
        return out, lse
    acc, lse_a = state
    m = torch.maximum(lse_a, lse)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w_a, w_b = torch.exp2(lse_a - m), torch.exp2(lse - m)
    total = w_a + w_b
    safe = torch.where(total > 0, total, torch.ones_like(total))
    lse = torch.where(total > 0, m + torch.log2(safe), torch.full_like(m, -math.inf))
    return (acc * w_a + out * w_b) / safe, lse


def ring_attention_kernel(qs: List[torch.Tensor], ks: List[torch.Tensor],
                          vs: List[torch.Tensor], bias_block: BiasBlock) -> List[torch.Tensor]:
    """The CUDA route: one `attention_fwd_lse` launch per (shard, ring step),
    merged by lse in fp32. q, k, v shards bf16 (b, tl, h, d) on CUDA."""
    devices = [q.device for q in qs]
    states = [None] * len(qs)
    for s, held_k, held_v in _ring_order(ks, vs, devices):
        for i, q in enumerate(qs):
            src = (i + s) % len(qs)
            out, lse = attention_fwd_lse(q, held_k[i], held_v[i], bias_block(i, src))
            states[i] = _merge(states[i], out, lse)
    return [acc.to(q.dtype) for (acc, _), q in zip(states, qs)]


def ring_attention_plain(qs: List[torch.Tensor], ks: List[torch.Tensor],
                         vs: List[torch.Tensor], bias_block: BiasBlock) -> List[torch.Tensor]:
    """The JAX function's loop in plain PyTorch (any device, any float
    dtype): base-2 scores, running m and l, fp32 accumulator."""
    b, tl, h, d = qs[0].shape
    devices = [q.device for q in qs]
    qf = [(q.permute(0, 2, 1, 3).float() * (LOG2E / math.sqrt(d))).to(q.dtype) for q in qs]
    m = [torch.full((b, h, tl, 1), -1e30, device=dev) for dev in devices]
    l = [torch.zeros((b, h, tl, 1), device=dev) for dev in devices]
    acc = [torch.zeros((b, h, tl, d), device=dev) for dev in devices]
    for s, held_k, held_v in _ring_order(ks, vs, devices):
        for i in range(len(qs)):
            src = (i + s) % len(qs)
            kf = held_k[i].permute(0, 2, 1, 3)
            vf = held_v[i].permute(0, 2, 1, 3)
            sc = torch.einsum("bhqd,bhkd->bhqk", qf[i].float(), kf.float())
            bias = bias_block(i, src)
            if bias is not None:
                sc = sc + bias.float()[None] * LOG2E
            m_new = torch.maximum(m[i], sc.amax(dim=-1, keepdim=True))
            p = torch.exp2(sc - m_new)
            alpha = torch.exp2(m[i] - m_new)
            l[i] = l[i] * alpha + p.sum(dim=-1, keepdim=True)
            acc[i] = acc[i] * alpha + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vf.dtype).float(), vf.float())
            m[i] = m_new
    return [(a / li).permute(0, 2, 1, 3).to(q.dtype) for a, li, q in zip(acc, l, qs)]


def ring_attention(qs: List[torch.Tensor], ks: List[torch.Tensor], vs: List[torch.Tensor],
                   bias_block: Optional[BiasBlock] = None) -> List[torch.Tensor]:
    """Each shard's attention output (b, tl, h, d) over the whole sequence:
    qs[i], ks[i], vs[i] are shard i, on device i; `bias_block(i, src)` is the
    (h, tl, tl) bias of query shard i against key shard src, on device i, or
    None (no bias). CUDA shards take the kernel route, CPU shards the plain
    version."""
    n = len(qs)
    if not (n == len(ks) == len(vs)) or n == 0:
        raise ValueError("ring attention needs one q, k and v shard per device")
    if any(x.shape != qs[0].shape for x in (*qs, *ks, *vs)):
        raise ValueError("ring attention takes equal shards")
    block = bias_block if bias_block is not None else (lambda i, src: None)
    if all(q.is_cuda for q in qs):
        return ring_attention_kernel(qs, ks, vs, block)
    if any(q.is_cuda for q in qs):
        raise ValueError("ring attention's shards must all lie on CUDA devices or all on the CPU")
    return ring_attention_plain(qs, ks, vs, block)
