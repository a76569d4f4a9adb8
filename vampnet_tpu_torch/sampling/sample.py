"""Token sampling: temperature, typical, top-k and top-p filters and
Gumbel-confidence re-masking (counterpart of
`vampnet_tpu/sampling/sample.py`).

The threshold filters use the JAX package's bisection form (24 halvings of
the threshold) rather than a sort, so their kept sets are the JAX ones up to
float ties at the cutoff. Randomness comes in as explicit noise tensors, a
`torch.Generator`, or per-row keys; the port does not reproduce
`jax.random`'s bits.

Per-row keys are (b, 2) int64 tensors holding two 32-bit words, laid out as
`jax.random.PRNGKey` lays them out (a seed s is the key (0, s mod 2^32)).
The port defines their streams with Philox4x32-10, the generator of the
sampler kernel (`ops/sampler_kernel.py`), told apart by the counter's last
word:
  * c3 = 0: the sampler's Gumbel noise, counter (step, position, vocab // 4, 0);
  * c3 = 1: the re-masking noise of `mask_by_random_topk`, counter
    (step, position, 0, 1), word 0;
  * c3 = 2: `fold_in_rows(keys, data)`, the first two words at counter
    (data, 0, 0, 2), the port's `jax.random.fold_in`.
So no two of them share a counter, and a row's draws depend only on its own
key. All of it runs as int64 tensor ops on the keys' device.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float("-inf")
BISECT_ITERS = 24
_MASK32 = 0xFFFFFFFF
_REMASK_DOMAIN = 1  # the counter word c3 of the re-masking noise
_FOLD_DOMAIN = 2  # the counter word c3 of fold_in_rows


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) from uniforms strictly inside (0, 1)."""
    return -torch.log(-torch.log(u))


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel(0, 1) noise from `generator`; the uniforms are kept off 0 and 1
    so both logs stay finite."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return gumbel_from_uniform(u.clamp(min=tiny, max=1.0 - 2.0 ** -24))


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64) -> fp32 uniforms ((bits >> 9) + 0.5) * 2^-23,
    strictly inside (0, 1), as the sampler kernel forms them."""
    return ((bits >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


def fold_in_rows(keys: torch.Tensor, data) -> torch.Tensor:
    """Per-row keys (b, 2) int64 -> new keys (b, 2): the first two words of
    Philox4x32-10 under each row's key at counter (data, 0, 0, 2). `data` is
    an int or a (b,) tensor. The port's counterpart of the JAX package's
    `fold_in_rows` (its own stream, not threefry's)."""
    from ..ops.sampler_kernel import philox4x32_10

    dev = keys.device
    c0 = torch.as_tensor(data, dtype=torch.int64, device=dev) & _MASK32
    c0 = c0.expand(keys.shape[0])
    zero = torch.zeros_like(c0)
    w0, w1, _, _ = philox4x32_10(c0, zero, zero, torch.full_like(c0, _FOLD_DOMAIN),
                                 keys[:, 0] & _MASK32, keys[:, 1] & _MASK32)
    return torch.stack([w0, w1], dim=1)


def remask_noise(row_keys: torch.Tensor, step: int, n: int) -> torch.Tensor:
    """Gumbel(0, 1) re-masking noise (b, n) for MaskGIT step `step`: row r,
    position p draws word 0 of Philox4x32-10 under key row_keys[r] at
    counter (step, p, 0, 1)."""
    from ..ops.sampler_kernel import philox4x32_10

    dev = row_keys.device
    b = row_keys.shape[0]
    c0 = torch.full((1, 1), int(step) & _MASK32, dtype=torch.int64, device=dev).expand(b, n)
    c1 = torch.arange(n, dtype=torch.int64, device=dev)[None, :].expand(b, n)
    zero = torch.zeros((1, 1), dtype=torch.int64, device=dev).expand(b, n)
    domain = torch.full((1, 1), _REMASK_DOMAIN, dtype=torch.int64, device=dev).expand(b, n)
    w0, _, _, _ = philox4x32_10(c0, c1, zero, domain, (row_keys[:, :1] & _MASK32),
                                (row_keys[:, 1:] & _MASK32))
    return gumbel_from_uniform(uniform_from_bits(w0))


def typical_filter(logits: torch.Tensor, typical_mass: float = 0.2,
                   typical_min_tokens: int = 1) -> torch.Tensor:
    """Locally-typical filtering: keep the tokens whose surprisal is closest
    to the entropy until `typical_mass` is covered and at least
    `typical_min_tokens` are kept; the rest become -inf."""
    m = logits.amax(dim=-1, keepdim=True)
    shifted = logits - m
    log_p = shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))
    p = torch.exp(log_p)
    plogp = torch.where(p > 0, log_p * p, torch.zeros_like(p))
    entropy = -plogp.sum(dim=-1, keepdim=True)
    c = torch.abs(-log_p - entropy)
    inf = torch.full_like(c, float("inf"))
    c = torch.where(torch.isfinite(c), c, inf)
    hi = torch.where(torch.isfinite(c), c, torch.zeros_like(c)).amax(dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        within = c <= mid
        mass_ok = torch.where(within, p, torch.zeros_like(p)).sum(dim=-1, keepdim=True) >= typical_mass
        count_ok = within.sum(dim=-1, keepdim=True) >= typical_min_tokens
        ok = mass_ok & count_ok
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    return torch.where(c > hi, torch.full_like(logits, NEG_INF), logits)


def _top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep only the top_k logits."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def _top_p_filter(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus filtering in bisection form: token i survives iff the mass
    strictly above p_i is <= top_p. `top_p` is a scalar or per-row tensor."""
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    p = e / e.sum(dim=-1, keepdim=True)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
    while top_p.dim() < logits.dim():
        top_p = top_p[..., None]
    lo = torch.zeros_like(p[..., :1])
    hi = p.amax(dim=-1, keepdim=True)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ok = torch.where(p > mid, p, torch.zeros_like(p)).sum(dim=-1, keepdim=True) <= top_p
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    return torch.where(p <= lo, torch.full_like(logits, NEG_INF), logits)


def _per_row(x, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (b,) parameter broadcast against (b, ..., vocab)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    if x.dim() == 1:
        x = x.reshape((-1,) + (1,) * (like.dim() - 1))
    return x


def sample_from_logits(logits: torch.Tensor, noise: Optional[torch.Tensor] = None,
                       sample=True, temperature=1.0, top_k: Optional[int] = None,
                       top_p=None, typical_filtering: bool = False,
                       typical_mass: float = 0.2, typical_min_tokens: int = 1):
    """Categorical sampling with the JAX package's filter pipeline.

    `noise` is Gumbel noise shaped like `logits`, needed where `sample` is
    true; `sample`, `temperature` and `top_p` are scalars or per-row (b,)
    tensors. Returns (tokens int64, the chosen tokens' probabilities)."""
    if typical_filtering:
        logits = typical_filter(logits, typical_mass, typical_min_tokens)
    if top_k is not None:
        logits = _top_k_filter(logits, top_k)
    if top_p is not None:
        logits = _top_p_filter(logits, top_p)

    t = torch.clamp(_per_row(temperature, logits), min=1e-10)
    scaled = logits / t
    m = scaled.amax(dim=-1, keepdim=True)
    e = torch.exp(scaled - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    token = torch.argmax(logits, dim=-1)
    sample = _per_row(sample, logits)
    sample = (sample.squeeze(-1) if sample.dim() else sample) > 0.5
    if bool(sample.any()):
        if noise is None:
            raise ValueError("sampling needs Gumbel noise")
        sampled = torch.argmax(scaled + noise, dim=-1)
        token = torch.where(sample, sampled, token)
    token_probs = torch.gather(probs, -1, token[..., None])[..., 0]
    return token, token_probs


def mask_by_random_topk(num_to_mask: torch.Tensor, probs: torch.Tensor,
                        temperature, generator: Optional[torch.Generator] = None,
                        row_keys: Optional[torch.Tensor] = None,
                        step: int = 0) -> torch.Tensor:
    """Gumbel-confidence re-masking: confidence = log p + temperature *
    gumbel; the `num_to_mask` (b, 1) least confident positions of each row
    come back masked. +inf probabilities pin a position unmasked. The noise
    comes from `generator`, or with `row_keys` from each row's own stream at
    `step` (`remask_noise`)."""
    if row_keys is not None:
        noise = remask_noise(row_keys, step, probs.shape[-1])
    else:
        noise = gumbel_noise(probs.shape, generator, probs.device)
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=probs.device)
    if temperature.dim() == 1:
        temperature = temperature[:, None]
    confidence = torch.log(probs) + temperature * noise
    sorted_confidence = torch.sort(confidence, dim=-1).values
    cut_off = torch.gather(sorted_confidence, -1, num_to_mask)
    return confidence < cut_off
