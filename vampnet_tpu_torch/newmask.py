"""Training-time mask variants (counterpart of `vampnet_tpu/newmask.py`):
stemgen-style per-codebook masks, the hierarchical `hugo_random`, the prefix
`tria_mask`, `drop_ones` and the onset mask. Masks are int64 (batch,
n_codebooks, seq), 1 = regenerate and 0 = keep; several builders also
return an `ignore` mask (bool) of the positions the loss leaves out.
Randomness comes from an explicit `torch.Generator` on the input's device;
the draws are not `jax.random`'s bits.
"""
from __future__ import annotations

import torch

from .mask import (  # noqa: F401  (re-exported, as the JAX module does)
    _gamma,
    _invgamma,
    apply_mask,
    codebook_mask,
    codebook_unmask,
    empty_mask,
    full_mask,
    inpaint,
    linear_random,
    mask_and,
    mask_or,
    onset_mask,
    periodic_mask,
    time_stretch_mask,
)


def _rows(r, b: int, device) -> torch.Tensor:
    """A scalar or (b,) ratio as a (b,) fp32 tensor."""
    r = torch.as_tensor(r, dtype=torch.float32, device=device)
    return r.expand(b) if r.dim() == 0 else r


def _check3(x: torch.Tensor) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (batch, n_codebooks, seq), got {tuple(x.shape)}")


def random(generator: torch.Generator, x: torch.Tensor, r):
    """Bernoulli(gamma(r)) mask per row and an empty ignore mask."""
    _check3(x)
    probs = _gamma(_rows(r, x.shape[0], x.device))[:, None, None]
    u = torch.rand(x.shape, generator=generator, device=x.device)
    mask = (u < probs).to(torch.int64)
    return mask, torch.zeros_like(mask, dtype=torch.bool)


def random_along_time(generator: torch.Generator, x: torch.Tensor, r) -> torch.Tensor:
    """(batch, seq) Bernoulli(gamma(r)) mask over time only."""
    _check3(x)
    b, t = x.shape[0], x.shape[-1]
    probs = _gamma(_rows(r, b, x.device))[:, None]
    u = torch.rand((b, t), generator=generator, device=x.device)
    return (u < probs).to(torch.int64)


def stemgen_random(generator: torch.Generator, x: torch.Tensor, r):
    """A random codebook level c per row: the levels below it kept and
    ignored, level c Bernoulli(r)-masked over time, the levels above masked
    and ignored. Returns (mask, ignore)."""
    _check3(x)
    nb, nc, nt = x.shape
    r = _rows(r, nb, x.device)
    c = torch.randint(0, nc, (nb,), generator=generator, device=x.device)
    u = torch.rand((nb, nt), generator=generator, device=x.device)
    level_mask = (u < r[:, None]).to(torch.int64)
    cb = torch.arange(nc, device=x.device)[None, :, None]
    below = cb < c[:, None, None]
    above = cb > c[:, None, None]
    mask = torch.where(below, 0, torch.where(above, 1, level_mask[:, None, :]))
    return mask.to(torch.int64), below | above


def hugo_random(generator: torch.Generator, x: torch.Tensor, r):
    """Hierarchical mask: the per-(b, t) level is nc - sum(Bernoulli(gamma(r)))
    - 1; codebooks above the level are masked, those above level + 1
    ignored. Returns (mask, ignore)."""
    _check3(x)
    nb, nc, _nt = x.shape
    probs = _gamma(_rows(r, nb, x.device))[:, None, None]
    bern = (torch.rand(x.shape, generator=generator, device=x.device) < probs).to(torch.int64)
    levels = nc - bern.sum(dim=1) - 1  # (nb, nt)
    cb = torch.arange(nc, device=x.device)[None, :, None]
    mask = (levels[:, None, :] < cb).to(torch.int64)
    return mask, (levels + 1)[:, None, :] < cb


def drop_ones(generator: torch.Generator, mask: torch.Tensor, p: float) -> torch.Tensor:
    """Each 1 of the mask becomes 0 with probability p."""
    keep = torch.rand(mask.shape, generator=generator, device=mask.device) < 1.0 - p
    return torch.where(mask.bool() & ~keep, 0, mask).to(torch.int64)


def tria_mask(generator: torch.Generator, codes: torch.Tensor, min_amt: float = 0.1,
              max_amt: float = 0.4) -> torch.Tensor:
    """Keep a prefix of a random share in [min_amt, max_amt) of each row."""
    nb, _nc, nt = codes.shape
    amt = torch.rand((nb,), generator=generator, device=codes.device) * (max_amt - min_amt) \
        + min_amt
    n_keep = (amt * nt).to(torch.int64)
    pos = torch.arange(nt, device=codes.device)[None, None, :]
    mask = torch.where(pos < n_keep[:, None, None], 0, 1)
    return mask.expand(codes.shape).to(torch.int64)
