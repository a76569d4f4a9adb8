"""Mask algebra (counterpart of `vampnet_tpu/mask.py`), the functions the
serving paths (`vamp_e2e` and the staged `build_mask`/`vamp`) and the
training step use. Masks are int64 tensors (batch, n_codebooks, seq) with
1 = regenerate and 0 = keep. Randomness comes from an explicit
`torch.Generator` on the mask's device."""
from __future__ import annotations

import math
from typing import Optional

import torch

from .util import scalar_to_batch_array


def _gamma(r: torch.Tensor) -> torch.Tensor:
    """Cosine mask schedule, in fp32."""
    return torch.clamp(torch.cos(r * math.pi / 2), 1e-10, 1.0)


def full_mask(x: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(x, dtype=torch.int64)


def empty_mask(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x, dtype=torch.int64)


def apply_mask(x: torch.Tensor, mask: torch.Tensor, mask_token: int):
    """Fill masked positions with `mask_token`; returns (masked_x, mask)."""
    if mask.shape != x.shape:
        raise ValueError(f"shape mismatch {tuple(mask.shape)} vs {tuple(x.shape)}")
    mask = mask.to(torch.int64)
    return torch.where(mask.bool(), torch.full_like(x, mask_token), x), mask


def random(generator: torch.Generator, x: torch.Tensor, r) -> torch.Tensor:
    """Bernoulli mask with per-row probability gamma(r), the training mask."""
    r = torch.as_tensor(r, dtype=torch.float32, device=x.device)
    if r.dim() == 0:
        r = scalar_to_batch_array(float(r), x.shape[0], device=x.device)
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return (u < _gamma(r)[:, None, None]).to(torch.int64)


def linear_random(generator: torch.Generator, x: torch.Tensor, r) -> torch.Tensor:
    """Bernoulli mask with per-row probability r."""
    r = torch.as_tensor(r, dtype=torch.float32, device=x.device)
    if r.dim() == 0:
        r = scalar_to_batch_array(float(r), x.shape[0], device=x.device)
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return (u < r[:, None, None]).to(torch.int64)


def inpaint(x: torch.Tensor, n_prefix, n_suffix) -> torch.Tensor:
    """Keep a prefix and a suffix (token counts, scalars or (b,)),
    regenerate the middle."""
    b, c, t = x.shape
    n_prefix = torch.as_tensor(n_prefix, device=x.device).expand(b)
    n_suffix = torch.as_tensor(n_suffix, device=x.device).expand(b)
    pos = torch.arange(t, device=x.device)[None, None, :]
    keep_prefix = pos < n_prefix[:, None, None]
    # a suffix of 0 keeps nothing
    keep_suffix = (pos >= (t - n_suffix)[:, None, None]) & (n_suffix[:, None, None] > 0)
    mask = torch.where(keep_prefix | keep_suffix, 0, 1)
    return mask.expand(b, c, t).to(torch.int64)


def periodic_mask(x: torch.Tensor, period: int, width: int = 1,
                  random_roll: bool = False, generator=None) -> torch.Tensor:
    """Keep every `period`-th step with a window of `width`; period 0 masks
    everything. With `random_roll` the pattern is rolled by a random offset
    in [0, period)."""
    if period == 0:
        return full_mask(x)
    t = x.shape[-1]
    w2 = width // 2
    pos = torch.arange(t, device=x.device)
    dmod = pos % period
    near_left = dmod <= w2
    near_right = (period - dmod <= w2) & (pos - dmod + period < t)
    mask = torch.where(near_left | near_right, 0, 1).to(torch.int64)
    mask = mask[None, None, :].expand(x.shape)
    if random_roll:
        if generator is None:
            raise ValueError("random_roll needs a generator")
        offset = int(torch.randint(0, period, (), generator=generator, device=x.device))
        mask = torch.roll(mask, offset, dims=-1)
    return mask


def codebook_unmask(mask: torch.Tensor, n_conditioning_codebooks) -> torch.Tensor:
    """Zero the mask of the conditioning codebooks."""
    if n_conditioning_codebooks is None:
        return mask
    cb = torch.arange(mask.shape[1], device=mask.device)[None, :, None]
    return torch.where(cb < n_conditioning_codebooks, 0, mask)


def codebook_mask(mask: torch.Tensor, val1: int, val2: Optional[int] = None) -> torch.Tensor:
    """Force regeneration of codebooks >= val1. `val2` is accepted and
    unused, as in the JAX function."""
    cb = torch.arange(mask.shape[1], device=mask.device)[None, :, None]
    return torch.where(cb >= val1, 1, mask)


def mask_and(mask1: torch.Tensor, mask2: torch.Tensor) -> torch.Tensor:
    if mask1.shape != mask2.shape:
        raise ValueError(f"mask shapes differ: {mask1.shape} vs {mask2.shape}")
    return torch.minimum(mask1, mask2)


def mask_or(mask1: torch.Tensor, mask2: torch.Tensor) -> torch.Tensor:
    if mask1.shape != mask2.shape:
        raise ValueError(f"mask shapes differ: {mask1.shape} vs {mask2.shape}")
    return torch.clamp(mask1 + mask2, 0, 1)


def dropout(generator: torch.Generator, mask: torch.Tensor, p: float) -> torch.Tensor:
    """Force-regenerate int(t * p) time steps drawn with replacement."""
    t = mask.shape[-1]
    n_drop = int(t * p)
    if n_drop == 0:
        return mask
    idxs = torch.randint(0, t, (n_drop,), generator=generator, device=mask.device)
    dropped = torch.zeros((t,), dtype=mask.dtype, device=mask.device)
    dropped[idxs] = 1
    return torch.maximum(mask, dropped[None, None, :])


def time_stretch_mask(x: torch.Tensor, stretch_factor: int) -> torch.Tensor:
    """The periodic mask that matches a repeat-interleave time stretch: keep
    every `stretch_factor`-th step."""
    if stretch_factor < 1:
        raise ValueError(f"stretch factor must be >= 1, got {stretch_factor}")
    return periodic_mask(x, stretch_factor, width=1)
