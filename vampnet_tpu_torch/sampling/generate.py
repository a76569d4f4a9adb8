"""MaskGIT iterative parallel decoding (counterpart of
`vampnet_tpu/sampling/generate.py`, `generate`).

Step for step as the JAX loop: r = (i+1)/steps; forward; sample (typical,
top-k and top-p filters, temperature, per-row sample cutoff); keep the
unmasked tokens; num_to_mask = floor(gamma(r) * N0) with N0 counted per row,
clamped to [1, remaining-1] except on the last step; Gumbel-confidence
re-masking at temperature mask_temperature * (1 - r).

It runs eagerly as a Python loop. Each step samples through
`ops.sampler_kernel.fused_sample_from_logits` (the CUDA kernel on the card,
top-k included, its plain version on CPU tensors).

Classifier-free guidance, as in the JAX function:
  * `ctrls` (sketch2sound controls): every forward runs the batch twice,
    with the real control masks and with zeroed ones, and the logits are
    uncond + cfg_scale * (cond - uncond);
  * `cfg_guidance`: nb unconditional rows, all MASK (their conditioning
    codebooks too, N0 = n_codebooks * t), are appended to the batch and
    sampled beside it with per-row parameters tiled and their own keys
    (`fold_in_rows(keys, 0x756E63)`); the first nb rows sample from
    uncond + g * (cond - uncond), the unconditional ones from their own
    logits, and only the first nb rows are returned. One forward a step
    runs the doubled batch, so the kernel launches do not double.

Randomness comes from one of two places. A `torch.Generator` draws the
sampler's row keys and the re-masking noise for the whole batch. Per-row
keys (`row_keys`, (b, 2) int64), the JAX function's batched `key`, give each
row its own streams (`sample.py`): the sampler kernel takes the keys as they
are and the re-masking noise comes from `remask_noise`, so a row's tokens
depend only on its key and its own logits, never on its batch-mates.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ..mask import _gamma
from ..ops.sampler_kernel import fused_sample_from_logits
from ..util import codebook_flatten, codebook_unflatten
from .sample import fold_in_rows, mask_by_random_topk

UNCOND_FOLD = 0x756E63  # "unc": folded into the row keys of cfg_guidance's rows


def _row_tensor(x, b: int, device, tile: int = 1) -> torch.Tensor:
    """A scalar or per-row parameter as a (b,) fp32 tensor; a per-row one
    of b / tile rows is tiled `tile` times (the CFG-doubled batch)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.dim() == 0:
        return x.expand(b).contiguous()
    return x.repeat(tile) if x.shape[0] * tile == b else x


def _check_ctrl_rows(ctrls, ctrl_masks, b: int) -> None:
    """The controls carry one row per forward row, as the JAX function
    needs them to (its shapes fail to broadcast otherwise)."""
    if ctrl_masks is None or set(ctrl_masks) != set(ctrls):
        raise ValueError("ctrls and ctrl_masks must have the same keys")
    for name in ctrls:
        if ctrls[name].shape[0] != b or ctrl_masks[name].shape[0] != b:
            raise ValueError(
                f"control {name!r} has {ctrls[name].shape[0]} rows and its mask "
                f"{ctrl_masks[name].shape[0]}; the forward runs {b}")


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
    top_k: Optional[int] = None,
    top_p=None,
    sample_cutoff=1.0,
    row_keys: Optional[torch.Tensor] = None,
    cfg_guidance: Optional[float] = None,
    ctrls: Optional[Dict[str, torch.Tensor]] = None,
    ctrl_masks: Optional[Dict[str, torch.Tensor]] = None,
    cfg_scale: float = 3.0,
    debug_callback: Optional[Callable] = None,
) -> torch.Tensor:
    """Run the MaskGIT loop; returns sampled codes (b, n_codebooks, t).

    `forward_fn` maps masked codes (b, C, T) to fp32 logits
    (b, T, C - n_conditioning_codebooks, V); with `ctrls` it is called
    `forward_fn(codes, ctrls, ctrl_masks)`. `temperature`,
    `mask_temperature`, `top_p` and `sample_cutoff` are scalars or per-row
    (b,) tensors; `top_k` is None or an int. `generator` lives on the
    tokens' device and feeds the sampler's per-row Philox keys and the
    re-masking noise; with `row_keys` ((b, 2) int64 on the tokens' device)
    it is not used. A (b, t) mask applies to every codebook. `ctrls` and
    `ctrl_masks` map each control's name to (b', t, dim) and (b', t), one
    row per row of the batch the forward runs. `debug_callback(step,
    z_masked, sampled, mask, selected_probs, num_to_mask)`, where given, gets
    each step's state as host numpy arrays (int32 tokens and mask, as the
    JAX function hands them over; `sampling/debug.py`); without one the loop
    copies nothing to the host."""
    z = start_tokens.to(torch.int64)
    dev = z.device
    nb, n_cb, t = z.shape
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
    tile = 1
    if cfg_guidance is not None:
        # the unconditional rows: all MASK, the conditioning codebooks too
        z_uncond = torch.full_like(z, mask_token)
        z_masked = torch.cat([z_masked, z_uncond])
        z = torch.cat([z, z_uncond])
        n0 = torch.cat([n0, torch.full_like(n0, float(n_cb * t))])
        tile = 2
    b = z.shape[0]
    if ctrls is not None:
        _check_ctrl_rows(ctrls, ctrl_masks, b)

    temperature = _row_tensor(temperature, b, dev, tile)
    mask_temp = _row_tensor(mask_temperature, b, dev, tile)
    sample_cutoff = _row_tensor(sample_cutoff, b, dev, tile)
    if top_p is not None:
        top_p = _row_tensor(top_p, b, dev, tile)
    steps = int(sampling_steps)
    per_row = row_keys is not None
    if per_row:
        if tuple(row_keys.shape) != (nb, 2) or row_keys.dtype != torch.int64:
            raise ValueError(f"row_keys must be int64 ({nb}, 2), got {row_keys.dtype} "
                             f"{tuple(row_keys.shape)}")
        row_keys = row_keys.to(dev)
        if cfg_guidance is not None:
            row_keys = torch.cat([row_keys, fold_in_rows(row_keys, UNCOND_FOLD)])
    elif generator is None:
        raise ValueError("generate needs a generator or per-row keys")
    else:
        row_keys = torch.randint(0, 2 ** 32, (b, 2), generator=generator,
                                 device=dev, dtype=torch.int64)

    sampled = codebook_flatten(z_masked[:, ncc:, :])
    for i in range(steps):
        i_f = torch.tensor(float(i), dtype=torch.float32)
        r = ((i_f + 1.0) / steps).to(dev).expand(b)
        if ctrls is not None:
            # the controls' CFG: the batch with its control masks, then with none
            both = forward_fn(
                torch.cat([z_masked, z_masked]),
                {k: torch.cat([v, v]) for k, v in ctrls.items()},
                {k: torch.cat([v, torch.zeros_like(v)]) for k, v in ctrl_masks.items()})
            cond, uncond = both[:b], both[b:]
            logits = uncond + cfg_scale * (cond - uncond)
        else:
            logits = forward_fn(z_masked)  # (b, T, n_infer, V) fp32
        if cfg_guidance is not None:
            cond, uncond = logits[:nb], logits[nb:]
            logits = torch.cat([uncond + cfg_guidance * (cond - uncond), uncond])
        logits_flat = logits.reshape(b, t * n_infer, logits.shape[-1])
        do_sample = ((i_f / steps).to(dev) <= sample_cutoff).to(torch.float32)
        sampled, selected_probs = fused_sample_from_logits(
            row_keys, i, logits_flat, temperature, do_sample, top_p=top_p,
            typical_filtering=typical_filtering, typical_mass=float(typical_mass),
            typical_min_tokens=int(typical_min_tokens), use_top_p=top_p is not None,
            top_k=top_k,
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
        if debug_callback is not None:
            debug_callback(i, *(x.cpu().numpy() for x in (
                z_masked.to(torch.int32), codebook_unflatten(sampled, n_infer).to(torch.int32),
                codebook_unflatten(new_mask.to(torch.int32), n_infer), selected_probs,
                num_to_mask[:, 0].to(torch.int32))))

    out = torch.cat([z[:, :ncc, :], codebook_unflatten(sampled, n_infer)], dim=1)
    return out[:nb]


MAGNET_KEEP_SCORE = -1e4  # audiocraft's DONT_REMASK_ME_SCORE: a span kept for good
MAGNET_SPAN = 3  # frames a span: MAGNeT's unit of re-masking


def magnet_schedule(step: int, steps: int) -> float:
    """MAGNeT's mask share at `step` of `steps`: cos(pi / 2 * step / (steps - 1))
    over torch.linspace(0, 1, steps), in fp32 as audiocraft computes it."""
    timestep = torch.linspace(0, 1, steps)[step]
    return float(torch.cos(timestep * math.pi * 0.5))


def magnet_generate(
    forward_fn: Callable[[torch.Tensor, int], torch.Tensor],
    b: int,
    n_q: int,
    t: int,
    mask_id: int,
    row_keys: torch.Tensor,  # (b, 2) int64
    decoding_steps=(60, 10, 10, 10),
    top_p=0.9,
    temperature=3.0,
    max_cfg_coef=10.0,
    min_cfg_coef=1.0,
) -> torch.Tensor:
    """MAGNeT's stage loop (audiocraft's `MagnetLMModel._generate_stage`,
    text-to-music from no prompt); returns codes (b, n_q, t).

    One stage per codebook, `decoding_steps[s]` steps each. All codebooks
    start at the mask id; while stage s runs, the codebooks above it hold
    the mask id and those below it their final tokens. At step i of n, with
    mask share p = cos(pi / 2 * i / (n - 1)):
      * the max(int(p * n_spans), 1) spans of `MAGNET_SPAN` frames with the
        highest scores come back masked (at step 0 every span: all scores
        are 0), ties broken towards the lower span index;
      * `forward_fn(codes (2b, n_q, t), stage)` runs the doubled CFG rows
        (the first b conditioned, the last b not) to the stage head's fp32
        logits (2b, t, V); the guided logits are
        uncond + (cond - uncond) * (p * max_cfg + (1 - p) * min_cfg);
      * they are divided by the annealed temperature
        max(temperature * (n - 1 - i) / n, 0.01) and sampled by the sampler
        (K10 on the card) at temperature 1 with top-p on them, per-row keys
        and the step counter of the whole loop, so that no two steps share
        draws; masked positions take the sampled tokens;
      * a span's score is 1 - the largest probability of its sampled tokens
        under the sampler's kept distribution (top-p renormalised), and a
        span not masked at this step scores `MAGNET_KEEP_SCORE`.
    `top_p`, `temperature`, `max_cfg_coef` and `min_cfg_coef` are scalars
    or per-row (b,) values. While tracing, each stage records a
    `magnet.stage` span (stage, steps, rows)."""
    from .. import profiling

    dev = row_keys.device
    if t % MAGNET_SPAN:
        raise ValueError(f"{t} frames are not whole spans of {MAGNET_SPAN}")
    n_spans = t // MAGNET_SPAN
    temp = _row_tensor(temperature, b, dev)
    cfg_max = _row_tensor(max_cfg_coef, b, dev)[:, None, None]
    cfg_min = _row_tensor(min_cfg_coef, b, dev)[:, None, None]
    top_p_rows = _row_tensor(top_p, b, dev)
    ones = torch.ones((b,), dtype=torch.float32, device=dev)
    codes = torch.full((b, n_q, t), mask_id, dtype=torch.int64, device=dev)
    step_id = 0
    for stage, n_steps in enumerate(decoding_steps):
        with profiling.span("magnet.stage", stage=stage, steps=int(n_steps), rows=2 * b):
            scores = torch.zeros((b, n_spans), dtype=torch.float32, device=dev)
            for i in range(n_steps):
                p = magnet_schedule(i, n_steps)
                n_masked = max(int(p * n_spans), 1)
                order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
                chosen = torch.zeros_like(scores, dtype=torch.bool).scatter_(
                    1, order[:, :n_masked], True)
                frame_mask = chosen.repeat_interleave(MAGNET_SPAN, dim=1)
                codes[:, stage] = torch.where(frame_mask, mask_id, codes[:, stage])
                logits = forward_fn(torch.cat([codes, codes]), stage)
                cond, uncond = logits[:b], logits[b:]
                coef = p * cfg_max + (1.0 - p) * cfg_min
                inv_t = 1.0 / torch.clamp(temp * ((n_steps - 1 - i) / n_steps), min=1e-2)
                guided = (uncond + (cond - uncond) * coef) * inv_t[:, None, None]
                tokens, probs = fused_sample_from_logits(
                    row_keys, step_id, guided.contiguous(), ones, ones, top_p=top_p_rows,
                    typical_filtering=False, use_top_p=True)
                codes[:, stage] = torch.where(frame_mask, tokens, codes[:, stage])
                span_best = probs.reshape(b, n_spans, MAGNET_SPAN).amax(dim=-1)
                scores = torch.where(chosen, 1.0 - span_best, MAGNET_KEEP_SCORE)
                step_id += 1
    return codes
