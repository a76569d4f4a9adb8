"""Fused token sampler for Hopper (`csrc/sampler.cu`) and its plain PyTorch
version.

Replaces the Pallas kernel `_kernel` in `vampnet_tpu/ops/sampler_kernel.py:80`
(`fused_sample_from_logits` `:151`), which the TPU runs once per MaskGIT
step. Same steps: typical filter (bisection, 24 steps), optional top-k
(the k-th largest logit after the typical filter, ties kept), optional top-p
(bisection, 24 steps), temperature softmax, Gumbel-max draw where the row's
flag is > 0.5 and greedy argmax elsewhere (first maximum wins), and the
chosen token's probability. The vocabulary is 1024 (VampNet's codebooks) or
2048 (MAGNeT's), one kernel instance each, chosen at launch.

Random numbers. The TPU's in-kernel PRNG cannot be reproduced off the TPU,
so this kernel defines its own stream: Philox4x32-10 keyed by the row's two
32-bit key words, counter (step, position, vocab index // 4, 0); word i of
the output feeds vocab index 4 * (vocab index // 4) + i, as the uniform
((bits >> 9) + 0.5) * 2^-23 and then Gumbel -log(-log(u)). `philox4x32_10`
below computes the same bits with int64 tensor ops, so the plain version
draws the kernel's noise exactly.

Determinism contract: the same keys, step and logits give the same tokens on
the same card, and a row's draws depend only on its own key (a request gives
the same tokens alone or batched with others).

What bounds it on an H100: one read of the logits, (b, flat, 1024) fp32:
28 MB at coarse shapes (2 x 3444 positions), 8.4 us at 3.35 TB/s; 85 MB at
c2f shapes (8 x 2590), 25 us. The plain algorithm's arithmetic is about 90
fp32 operations per logit (the 24 bisection steps dominate), about the same
time as the read at 67 TFLOP/s. MAGNeT's step, (8, 1500, 2048) with top-p
and no typical filter, reads 98 MB: 29 us.

What the design does about it: one warp per position, the 1024 logits in
registers (32 per lane, loaded as float4), every reduction a butterfly of
warp shuffles with no block barrier; logits are read once and only the
token and its probability are written. The typicality distances and
probabilities go to 8 KB of shared memory per warp, so that 24 warps share
an SM (80 registers a thread). After 6 bisection steps over all entries,
the entries already decided are carried as a count and a mass and the
remaining 18 steps run over the undecided band alone (the same comparisons,
so the same kept set). The kept tokens are then listed in ascending vocab
order, and top-k, top-p, the softmax, the noise and the argmax run over them
alone: a dropped token adds exp(-inf) = 0 to every sum and wins no argmax.
Top-k takes the k-th largest kept logit exactly (a radix select over the
floats' order-preserving 32-bit images, 32 ballot-and-popcount passes over
the list), so its kept set is the plain version's `torch.topk` threshold,
ties included, and not a bisection's approximation of it. In the JAX
package `top_k` bypasses the Pallas kernel (its generate takes the XLA
sampler then); the port has one sampler, so the kernel takes the filter.
"""
from __future__ import annotations

import numbers
from typing import Optional

import torch

from ..sampling.sample import gumbel_from_uniform, sample_from_logits, uniform_from_bits

VOCAB = 1024  # VampNet's codebooks
VOCABS = (1024, 2048)  # the vocabularies the kernel is built for
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo32(a: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product a * c, for a 32-bit
    constant a and int64 tensors c holding 32-bit values. The product is
    taken in 16-bit halves of c so nothing overflows signed int64."""
    p_lo = a * (c & 0xFFFF)  # < 2^48
    p_hi = a * (c >> 16)  # < 2^48, weight 2^16
    mid = (p_hi & 0xFFFF) * 65536 + p_lo  # < 2^49
    lo = mid & _MASK32
    hi = (p_hi >> 16) + (mid >> 32)
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit words (broadcasting)."""
    k0 = torch.as_tensor(k0)
    k1 = torch.as_tensor(k1)
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo32(_M0, c0)
        hi1, lo1 = _mulhilo32(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniform(row_keys: torch.Tensor, step: int, flat: int,
                   vocab: int = VOCAB) -> torch.Tensor:
    """The kernel's uniforms, (b, flat, vocab) fp32, for int64 keys (b, 2)."""
    dev = row_keys.device
    b = row_keys.shape[0]
    k0 = (row_keys[:, 0] & _MASK32).reshape(b, 1, 1)
    k1 = (row_keys[:, 1] & _MASK32).reshape(b, 1, 1)
    c0 = torch.full((1, 1, 1), step & _MASK32, dtype=torch.int64, device=dev)
    c1 = torch.arange(flat, dtype=torch.int64, device=dev).reshape(1, flat, 1)
    c2 = torch.arange(vocab // 4, dtype=torch.int64, device=dev).reshape(1, 1, -1)
    c3 = torch.zeros((1, 1, 1), dtype=torch.int64, device=dev)
    c0, c1, c2, c3 = (x.expand(b, flat, vocab // 4) for x in (c0, c1, c2, c3))
    words = torch.stack(philox4x32_10(c0, c1, c2, c3, k0, k1), dim=-1)
    return uniform_from_bits(words.reshape(b, flat, vocab))


def check_top_k(top_k: Optional[int], vocab: int = VOCAB) -> int:
    """`top_k` (None: off, or 1 to the vocabulary) as the kernel's int, 0
    for off."""
    if top_k is None:
        return 0
    if isinstance(top_k, bool) or not isinstance(top_k, numbers.Integral) \
            or not 1 <= top_k <= vocab:
        raise ValueError(f"top_k must be None or an int in [1, {vocab}], got {top_k!r}")
    return int(top_k)


def fused_sample_plain(row_keys, step, logits, temperature, do_sample, top_p=None,
                       typical_filtering=True, typical_mass=0.15,
                       typical_min_tokens=64, use_top_p=False, top_k=None):
    """The kernel's function in plain PyTorch (sample.py's filters plus the
    kernel's Philox noise)."""
    b, flat, v = logits.shape
    top_k = check_top_k(top_k, v) or None
    sample = _row_param(do_sample, b, logits.device)
    noise = None
    if bool((sample > 0.5).any()):
        noise = gumbel_from_uniform(philox_uniform(row_keys, int(step), flat, v))
    return sample_from_logits(
        logits.float(), noise, sample=sample,
        temperature=_row_param(temperature, b, logits.device),
        top_k=top_k, top_p=_row_param(top_p, b, logits.device) if use_top_p else None,
        typical_filtering=typical_filtering, typical_mass=typical_mass,
        typical_min_tokens=typical_min_tokens,
    )


def _row_param(x, b: int, device) -> torch.Tensor:
    """A scalar, None (1.0) or tensor parameter as a (b,) fp32 tensor on
    `device`. A Python number is filled on the device: a copy from the host
    would wait for the stream to drain."""
    if x is None or isinstance(x, (int, float)):
        return torch.full((b,), 1.0 if x is None else float(x), dtype=torch.float32,
                          device=device)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.expand(b).contiguous() if x.dim() == 0 else x.contiguous()


def fused_sample_from_logits(row_keys: torch.Tensor, step: int, logits: torch.Tensor,
                             temperature, do_sample, top_p: Optional[torch.Tensor] = None,
                             typical_filtering: bool = True, typical_mass: float = 0.15,
                             typical_min_tokens: int = 64, use_top_p: bool = False,
                             top_k: Optional[int] = None):
    """row_keys (b, 2) int64 holding 32-bit words; logits (b, flat, V) fp32,
    V in `VOCABS`; temperature, do_sample, top_p scalars or (b,); top_k None
    (off) or an int in [1, V]. Returns (tokens (b, flat) int64,
    probabilities (b, flat) fp32). CPU tensors take `fused_sample_plain`;
    CUDA tensors launch the kernel."""
    k = check_top_k(top_k, logits.shape[-1])
    if logits.device.type == "cpu":
        return fused_sample_plain(
            row_keys, step, logits, temperature, do_sample, top_p,
            typical_filtering, typical_mass, typical_min_tokens, use_top_p, top_k)
    from . import build

    build.refuse_grad("sampler", logits, temperature, do_sample, top_p)
    if not logits.is_cuda or row_keys.device != logits.device:
        raise ValueError("logits and row_keys must lie on one CUDA device")
    if logits.dtype != torch.float32 or logits.dim() != 3 or logits.shape[-1] not in VOCABS:
        raise ValueError(f"the sampler kernel takes fp32 (b, flat, V) logits, V in {VOCABS}, "
                         f"got {logits.dtype} {tuple(logits.shape)}")
    if not logits.is_contiguous() or logits.data_ptr() % 16:
        raise ValueError("logits must be contiguous and 16-byte aligned")
    b, flat, v = logits.shape
    if row_keys.dtype != torch.int64 or tuple(row_keys.shape) != (b, 2):
        raise ValueError(f"row_keys must be int64 ({b}, 2)")

    keys = row_keys.contiguous()
    temp = _row_param(temperature, b, logits.device)
    flag = _row_param(do_sample, b, logits.device)
    # the kernel reads top_p only under use_top_p
    topp = _row_param(top_p, b, logits.device) if use_top_p else temp
    for name, x in (("temperature", temp), ("do_sample", flag), ("top_p", topp)):
        if tuple(x.shape) != (b,):
            raise ValueError(f"{name} must be a scalar or ({b},)")
    tokens = torch.empty((b, flat), dtype=torch.int64, device=logits.device)
    probs = torch.empty((b, flat), dtype=torch.float32, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    rc = build.library().vampnet_sampler(
        logits.data_ptr(), keys.data_ptr(), temp.data_ptr(), topp.data_ptr(),
        flag.data_ptr(), tokens.data_ptr(), probs.data_ptr(), b, flat, v, int(step),
        int(typical_filtering), float(typical_mass), int(typical_min_tokens), k,
        int(use_top_p), logits.device.index or 0, stream,
    )
    build.check(rc, "sampler")
    fused_sample_from_logits.launches += 1
    return tokens, probs


fused_sample_from_logits.launches = 0
