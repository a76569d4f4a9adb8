"""Random weights made on the device from the seed, in a few large calls.

Frozen copies of the draws the port's card checks use (`random_state` with
`fan_in`, and the codec's `codec_weights`), changed only so that a module's
tensors are drawn as one flat block and cut into leaves: one `randn` (and
one `rand`) per module, not one per leaf. The benchmark makes the same
tensors again from the same seed for the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def _flat_draws(shapes: Dict[str, torch.Size], gen: torch.Generator, uniform: bool = False):
    total = sum(math.prod(s) for s in shapes.values())
    draw = torch.rand if uniform else torch.randn
    flat = draw((total,), generator=gen, device=gen.device)
    out, at = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        out[k] = flat[at:at + n].view(s)
        at += n
    return out


def lm_state(shapes: Dict[str, torch.Size], gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """fan-in weights that keep activations O(1) at any width: Dense weights
    normal / sqrt(fan-in), norm scales 1 + 0.1 normal, biases 0.02 normal, the
    bucket table and the MASK latents normal (fp32)."""
    x = _flat_draws(shapes, gen)
    out = {}
    for k, v in x.items():
        if k.endswith(".weight") and v.dim() == 2:
            v = v / v.shape[1] ** 0.5
        elif k.endswith(".weight"):
            v = 1.0 + 0.1 * v
        elif k.endswith(".bias"):
            v = 0.02 * v
        out[k] = v
    return out


def codec_state(shapes: Dict[str, torch.Size], gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Codec weights whose codes spread over the codebooks: weight-norm
    directions normal, gains 0.3-0.7, snake alphas 0.5-1.5, biases 0.01
    normal, codebooks normal (fp32)."""
    u = _flat_draws(shapes, gen, uniform=True)
    n = _flat_draws(shapes, gen)
    out = {}
    for k in shapes:
        leaf = k.rsplit(".", 1)[-1]
        out[k] = {"g": 0.3 + 0.4 * u[k], "alpha": 0.5 + u[k], "bias": 0.01 * n[k]}.get(leaf, n[k])
    return out

