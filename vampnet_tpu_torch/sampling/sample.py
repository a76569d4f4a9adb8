"""Token sampling: temperature, typical, top-k and top-p filters and
Gumbel-confidence re-masking (counterpart of
`vampnet_tpu/sampling/sample.py`).

The threshold filters use the JAX package's bisection form (24 halvings of
the threshold) rather than a sort, so their kept sets are the JAX ones up to
float ties at the cutoff. Randomness comes in as explicit noise tensors or a
`torch.Generator`; the port does not reproduce `jax.random`'s bits.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float("-inf")
BISECT_ITERS = 24


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) from uniforms strictly inside (0, 1)."""
    return -torch.log(-torch.log(u))


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel(0, 1) noise from `generator`; the uniforms are kept off 0 and 1
    so both logs stay finite."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return gumbel_from_uniform(u.clamp(min=tiny, max=1.0 - 2.0 ** -24))


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
                        temperature, generator: torch.Generator) -> torch.Tensor:
    """Gumbel-confidence re-masking: confidence = log p + temperature *
    gumbel; the `num_to_mask` (b, 1) least confident positions of each row
    come back masked. +inf probabilities pin a position unmasked."""
    noise = gumbel_noise(probs.shape, generator, probs.device)
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=probs.device)
    if temperature.dim() == 1:
        temperature = temperature[:, None]
    confidence = torch.log(probs) + temperature * noise
    sorted_confidence = torch.sort(confidence, dim=-1).values
    cut_off = torch.gather(sorted_confidence, -1, num_to_mask)
    return confidence < cut_off
