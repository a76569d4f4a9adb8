"""The coarse training step's arithmetic in plain fp32 PyTorch (upstream
vampnet `scripts/exp/train.py` with `conf/vampnet.yml`): the random ratio
and Bernoulli mask, the masked cross-entropy with label smoothing in its
gather form, the clip at the global gradient norm, and AdamW under the Noam
schedule with optax's semantics (the update's bias corrections rounded to
fp32, the rate taken at the update count before the increment).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import lm as ref_lm


def noam(d_model: int, factor: float, warmup: int, step: int) -> float:
    """factor d^-0.5 min(s^-0.5, s warmup^-1.5), s = max(step, 1), in fp32."""
    scale = np.float32(factor * d_model ** -0.5)
    ramp = np.float32(warmup ** -1.5)
    s = np.float32(max(float(step), 1.0))
    return float(scale * np.minimum(s ** np.float32(-0.5), s * ramp))


def loss_and_grads(params: Dict[str, torch.Tensor], cfg: ref_lm.LMConfig, z: torch.Tensor,
                   codebooks: torch.Tensor, gen: torch.Generator, label_smoothing: float,
                   precision: Optional[str] = None):
    """One step's loss and gradients on codes z (b, C, t): r ~ U(0, 1) per
    row, each token masked with probability cos(r pi / 2), the forward with
    dropout from `gen`, the mean of the label-smoothed cross-entropy over the
    masked tokens."""
    b = z.shape[0]
    r = torch.rand((b,), generator=gen, device=z.device)
    u = torch.rand(z.shape, generator=gen, device=z.device)
    mask = u < torch.clamp(torch.cos(r * math.pi / 2), 1e-10, 1.0)[:, None, None]
    zm = torch.where(mask, cfg.mask_token, z)
    names = list(params)
    for k in names:
        params[k].requires_grad_(True)
    operand = ref_lm.fp8 if precision == "fp8" else None
    with torch.enable_grad():
        logits = ref_lm.forward(params, cfg, zm, codebooks, generator=gen, operand=operand)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, z.transpose(1, 2)[..., None])[..., 0]
        ce = lse - (1 - label_smoothing) * tgt - label_smoothing * logits.mean(-1)
        w = mask.transpose(1, 2).to(torch.float32)
        loss = (ce * w).sum() / w.sum().clamp(min=1.0)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
    for k in names:
        params[k].requires_grad_(False)
    return loss.detach(), dict(zip(names, grads))


class AdamW:
    """clip_by_global_norm -> adamw(b1 0.9, b2 0.999, eps 1e-8, weight decay)
    under the Noam rate, updating `params` in place."""

    def __init__(self, params: Dict[str, torch.Tensor], o: dict, d_model: int):
        self.params, self.o, self.d = params, o, d_model
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Returns the clipped gradients the moments took."""
        o = self.o
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        clip = float(o["grad_clip"])
        scale = 1.0 if float(norm) < clip else clip / float(norm)
        grads = {k: g * scale if scale != 1.0 else g for k, g in grads.items()}
        lr = noam(self.d, o["noam_factor"], o["noam_warmup"], self.count)
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(0.9) ** f32(self.count))
        bc2 = float(f32(1) - f32(0.999) ** f32(self.count))
        wd = float(o["weight_decay"])
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(0.9).add_(g, alpha=0.1)
            self.nu[k].mul_(0.999).addcmul_(g, g, value=0.001)
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-8) + wd * p
            p.add_(upd, alpha=-lr)
        return grads
