"""MaskGIT iterative parallel decoding (counterpart of
`vampnet_tpu/sampling/generate.py`, `generate`).

Step for step as the JAX loop: r = (i+1)/steps; forward; sample (typical
and top-p filters, temperature, per-row sample cutoff); keep the unmasked
tokens; num_to_mask = floor(gamma(r) * N0) with N0 counted per row, clamped
to [1, remaining-1] except on the last step; Gumbel-confidence re-masking at
temperature mask_temperature * (1 - r).

It runs eagerly as a Python loop. Each step samples through
`ops.sampler_kernel.fused_sample_from_logits` (the CUDA kernel on the card,
its plain version on CPU tensors). The ctrls CFG and `cfg_guidance` paths of
the JAX function are not ported yet.

Randomness comes from one of two places. A `torch.Generator` draws the
sampler's row keys and the re-masking noise for the whole batch. Per-row
keys (`row_keys`, (b, 2) int64), the JAX function's batched `key`, give each
row its own streams (`sample.py`): the sampler kernel takes the keys as they
are and the re-masking noise comes from `remask_noise`, so a row's tokens
depend only on its key and its own logits, never on its batch-mates.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..mask import _gamma
from ..ops.sampler_kernel import fused_sample_from_logits
from ..util import codebook_flatten, codebook_unflatten
from .sample import mask_by_random_topk


def _row_tensor(x, b: int, device) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.expand(b).contiguous() if x.dim() == 0 else x


def generate(
    forward_fn: Callable[[torch.Tensor], torch.Tensor],
    start_tokens: torch.Tensor,  # (b, n_codebooks, t) int
    mask: Optional[torch.Tensor],  # (b, n_codebooks, t) or (b, t); 1 = regenerate
    mask_token: int,
    generator: Optional[torch.Generator] = None,
    n_conditioning_codebooks: int = 0,
    sampling_steps: int = 12,
    temperature=1.0,
    mask_temperature=10.5,
    typical_filtering: bool = True,
    typical_mass: float = 0.15,
    typical_min_tokens: int = 64,
    top_p=None,
    sample_cutoff=1.0,
    row_keys: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the MaskGIT loop; returns sampled codes (b, n_codebooks, t).

    `forward_fn` maps masked codes (b, C, T) to fp32 logits
    (b, T, C - n_conditioning_codebooks, V). `temperature`,
    `mask_temperature`, `top_p` and `sample_cutoff` are scalars or per-row
    (b,) tensors. `generator` lives on the tokens' device and feeds the
    sampler's per-row Philox keys and the re-masking noise; with `row_keys`
    ((b, 2) int64 on the tokens' device) it is not used. A (b, t) mask
    applies to every codebook."""
    z = start_tokens.to(torch.int64)
    dev = z.device
    b, n_cb, t = z.shape
    ncc = n_conditioning_codebooks
    n_infer = n_cb - ncc

    if mask is None:
        mask = torch.ones_like(z)
        mask[:, :ncc, :] = 0
    if mask.dim() == 2:
        mask = mask[:, None, :].expand(z.shape)
    mask = mask.to(torch.int64)
    z_masked = torch.where(mask.bool(), mask_token, z)
    # N0 per row, as the JAX package counts it (chunks are batch rows)
    n0 = (z_masked == mask_token).sum(dim=(1, 2)).to(torch.float32)

    temperature = _row_tensor(temperature, b, dev)
    mask_temp = _row_tensor(mask_temperature, b, dev)
    sample_cutoff = _row_tensor(sample_cutoff, b, dev)
    if top_p is not None:
        top_p = _row_tensor(top_p, b, dev)
    steps = int(sampling_steps)
    per_row = row_keys is not None
    if per_row:
        if tuple(row_keys.shape) != (b, 2) or row_keys.dtype != torch.int64:
            raise ValueError(f"row_keys must be int64 ({b}, 2), got {row_keys.dtype} "
                             f"{tuple(row_keys.shape)}")
        row_keys = row_keys.to(dev)
    elif generator is None:
        raise ValueError("generate needs a generator or per-row keys")
    else:
        row_keys = torch.randint(0, 2 ** 32, (b, 2), generator=generator,
                                 device=dev, dtype=torch.int64)

    sampled = codebook_flatten(z_masked[:, ncc:, :])
    for i in range(steps):
        i_f = torch.tensor(float(i), dtype=torch.float32)
        r = ((i_f + 1.0) / steps).to(dev).expand(b)
        logits = forward_fn(z_masked)  # (b, T, n_infer, V) fp32
        logits_flat = logits.reshape(b, t * n_infer, logits.shape[-1])
        do_sample = ((i_f / steps).to(dev) <= sample_cutoff).to(torch.float32)
        sampled, selected_probs = fused_sample_from_logits(
            row_keys, i, logits_flat, temperature, do_sample, top_p=top_p,
            typical_filtering=typical_filtering, typical_mass=float(typical_mass),
            typical_min_tokens=int(typical_min_tokens), use_top_p=top_p is not None,
        )

        zm_flat = codebook_flatten(z_masked[:, ncc:, :])
        cur_mask = zm_flat == mask_token
        sampled = torch.where(cur_mask, sampled, zm_flat)
        selected_probs = torch.where(cur_mask, selected_probs, float("inf"))

        num_to_mask = torch.floor(_gamma(r) * n0).to(torch.int64)[:, None]
        if i != steps - 1:
            remaining = cur_mask.sum(dim=-1, keepdim=True)
            num_to_mask = torch.clamp(torch.minimum(remaining - 1, num_to_mask), min=1)

        new_mask = mask_by_random_topk(
            num_to_mask, selected_probs, mask_temp * (1 - r), generator,
            row_keys=row_keys if per_row else None, step=i,
        )
        z_masked = torch.cat(
            [z[:, :ncc, :],
             codebook_unflatten(torch.where(new_mask, mask_token, sampled), n_infer)],
            dim=1,
        )

    return torch.cat([z[:, :ncc, :], codebook_unflatten(sampled, n_infer)], dim=1)
