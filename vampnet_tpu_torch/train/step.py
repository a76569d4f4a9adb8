"""The training step (counterpart of `vampnet_tpu/train/step.py`).

One step: frozen-codec encode -> schedule-ratio random mask -> LM forward
(dropout on) -> masked cross-entropy with label smoothing -> backward ->
clip by global norm -> AdamW with the Noam learning rate.

The JAX package builds its optimizer from optax; the port has no optax.
`Optimizer` keeps optax's semantics for the chain
`clip_by_global_norm(max) -> adamw(lr, b1, b2, eps, weight_decay)` around
`torch.optim.AdamW`, whose update is the same maths as optax's adamw
(`p (1 - lr wd) - lr (mu / bc1) / (sqrt(nu) / sqrt(bc2) + eps)`, fp32
moments). What it adds:
  * the bias corrections bc1 and bc2 rounded to fp32 as optax rounds them
    (folded into the lr, eps and weight decay handed to torch);
  * clipping divides by the norm and multiplies by max (`(g / |g|) * max`)
    when |g| >= max, with no epsilon (unlike `clip_grad_norm_`);
  * the learning rate is the schedule at the update count BEFORE the
    increment, so the first update uses noam(max(0, 1));
  * `grad_norm` is the norm before clipping.
Parameters are updated in place (the JAX step returns new trees); that
saves a copy of 328 M fp32 parameters at coarse width.

With a `Sketch2SoundController` (`control.py`) the step extracts the
controls from the step's audio on its device, trims them to the codes'
length, draws their random masks from the step's generator and forwards
through the LM's ControlEncoder (CFG dropout on), as the JAX step does.

Not ported yet: the bf16-moment option (`_scale_by_adam_lowmem`), LoRA-only
training (`lora_filter`), `encode_microbatch`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import mask as pmask
from ..util import codebook_flatten
from .scheduler import noam_schedule


@dataclasses.dataclass
class OptState:
    """The number of updates made, and the AdamW that holds the moments."""

    count: int
    adamw: torch.optim.AdamW


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """clip_by_global_norm(grad_clip) -> AdamW(b1 0.9, b2 0.999, eps 1e-8)
    under `schedule`, with optax's semantics (module docstring)."""

    schedule: Callable[[int], float]
    weight_decay: float = 0.01
    grad_clip: float = 5.0

    def init(self, params: List[torch.Tensor]) -> OptState:
        return OptState(0, torch.optim.AdamW(
            params, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=self.weight_decay, fused=True))

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState,
               params: List[torch.Tensor]) -> torch.Tensor:
        """Clip `grads` (in place), step the moments and `params` in place,
        and return the global norm of the grads before clipping."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        trigger = norm < self.grad_clip
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        # optax: select(trigger, g, (g / norm) * max), without a host sync
        torch._foreach_div_(grads, torch.where(trigger, one, norm))
        torch._foreach_mul_(grads, torch.where(trigger, one, one * self.grad_clip))
        for p, g in zip(params, grads):
            # the fused update reads a grad as laid out like its parameter;
            # autograd may hand back a strided view (the MASK latents' is a
            # slice of the codebook table's gradient)
            p.grad = g.contiguous()
        lr = self.schedule(state.count)
        state.count += 1
        # optax bias-corrects in fp32, where 1 - 0.999 ** 1 is 1.3e-5 off;
        # torch in float64. These lr, eps and weight decay make torch's
        # lr / bc1 mu / (sqrt(nu) / sqrt(bc2) + eps) and p (1 - lr wd) optax's.
        f32, n = np.float32, state.count
        bc1, bc2 = 1 - 0.9 ** n, 1 - 0.999 ** n
        bc1_32 = float(f32(1) - f32(0.9) ** f32(n))
        bc2_32 = float(f32(1) - f32(0.999) ** f32(n))
        c = math.sqrt(bc2_32 / bc2)
        group = state.adamw.param_groups[0]
        group.update(lr=lr * c * bc1 / bc1_32, eps=1e-8 * c,
                     weight_decay=self.weight_decay * bc1_32 / (c * bc1))
        state.adamw.step()
        state.adamw.zero_grad(set_to_none=True)
        return norm


def make_optimizer(d_model: int, factor: float = 2.0, warmup: int = 10000,
                   weight_decay: float = 0.01, grad_clip: float = 5.0) -> Optimizer:
    """AdamW + grad clip + Noam schedule (reference conf/vampnet.yml: AdamW
    lr scaled by NoamScheduler factor=2.0 warmup=10000; clip 5.0)."""
    return Optimizer(noam_schedule(d_model, factor=factor, warmup=warmup),
                 weight_decay=weight_decay, grad_clip=grad_clip)


@dataclasses.dataclass
class TrainState:
    """The LM (its parameters, fp32, updated in place), the optimizer's state
    and the step count."""

    model: torch.nn.Module
    opt_state: OptState
    step: int = 0

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for p in self.model.parameters() if p.requires_grad]

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: Optimizer) -> "TrainState":
        state = cls(model, None)
        state.opt_state = optimizer.init(state.params)
        return state


def loss_and_metrics(logits: torch.Tensor, target: torch.Tensor, flat_mask: torch.Tensor,
                     r: torch.Tensor, label_smoothing: float = 0.1):
    """Masked CE with label smoothing, in gather form:
    CE = lse - (1 - ls) logit[target] - ls mean(logits), and the stratified
    top-1 and top-25 accuracies (masked and unmasked, r in [0, .5) and
    [.5, 1)). logits (b, t, c, vocab) fp32, target (b, c, t), flat_mask
    (b, t*c) with 1 where the loss counts, r (b,)."""
    b, t, c, v = logits.shape
    logits_flat = logits.reshape(b, t * c, v)
    target_flat = codebook_flatten(target)
    lse = torch.logsumexp(logits_flat, dim=-1)
    tgt_logit = logits_flat.gather(-1, target_flat[..., None])[..., 0]
    ce = lse - (1 - label_smoothing) * tgt_logit - label_smoothing * logits_flat.mean(-1)
    w = flat_mask.to(torch.float32)
    loss = (ce * w).sum() / w.sum().clamp(min=1.0)

    metrics = {"loss": loss.detach()}
    with torch.no_grad():
        pred = logits_flat.argmax(dim=-1)
        top25 = torch.topk(logits_flat, 25, dim=-1).indices
        hit1 = (pred == target_flat).to(torch.float32)
        hit25 = (top25 == target_flat[..., None]).any(-1).to(torch.float32)
        for lo, hi in ((0.0, 0.5), (0.5, 1.0)):
            in_bucket = ((r >= lo) & (r < hi)).to(torch.float32)[:, None]
            for name, sel in (("masked", w), ("unmasked", 1.0 - w)):
                sel_b = sel * in_bucket
                denom = sel_b.sum().clamp(min=1.0)
                metrics[f"accuracy-{lo}-{hi}/top1/{name}"] = (hit1 * sel_b).sum() / denom
                metrics[f"accuracy-{lo}-{hi}/top25/{name}"] = (hit25 * sel_b).sum() / denom
    return loss, metrics


def loss_and_grads(model, z_masked: torch.Tensor, codebooks: torch.Tensor,
                   target: torch.Tensor, flat_mask: torch.Tensor, r: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   label_smoothing: float = 0.1, ctrls=None, ctrl_masks=None):
    """The JAX step's `loss_fn` under `value_and_grad`: the forward with
    dropout drawn from `generator` (none without one), the loss, and the gradient of every
    trainable parameter. Returns (loss, metrics, grads)."""
    params = [p for p in model.parameters() if p.requires_grad]
    with torch.enable_grad():
        logits = model.forward_codes(z_masked, codebooks, generator=generator, ctrls=ctrls,
                                     ctrl_masks=ctrl_masks)
        loss, metrics = loss_and_metrics(logits, target, flat_mask, r, label_smoothing)
        grads = list(torch.autograd.grad(loss, params))
    return loss.detach(), metrics, grads


def make_train_step(lm_model, codec_model, optimizer: Optimizer,
                    label_smoothing: float = 0.1, controller=None):
    """Returns train_step(state, codebooks, audio, generator) -> (state,
    metrics): encode with the frozen codec, draw r ~ U(0, 1) and the random
    mask from `generator` (with a `controller`, extract the controls from
    the audio and draw their masks too), then `train_step.with_mask`.

    `train_step.with_mask(state, codebooks, z, r, mask, generator, ctrls,
    ctrl_masks)` is the step after the random draws: `codebook_unmask` ->
    `apply_mask` -> forward, loss and grads -> clip and AdamW. The tests
    hand it the JAX step's r, mask and control masks."""
    cfg = lm_model.config
    if cfg.remat:
        raise NotImplementedError(
            "LMConfig.remat (recompute each layer in the backward) is not ported: "
            "ROADMAP Queue A item 5")
    if controller is not None and cfg.ctrl_dims is None:
        raise ValueError("a controller needs an LM with ctrl_dims")
    n_cb, ncc, mask_token = cfg.n_codebooks, cfg.n_conditioning_codebooks, cfg.mask_token

    def with_mask(state: TrainState, codebooks, z, r, mask, generator=None, ctrls=None,
                  ctrl_masks=None):
        mask = pmask.codebook_unmask(mask, ncc)
        z_masked, mask = pmask.apply_mask(z, mask, mask_token)
        flat_mask = codebook_flatten(mask[:, ncc:, :])
        target = z[:, ncc:, :]
        _loss, metrics, grads = loss_and_grads(
            state.model, z_masked, codebooks, target, flat_mask, r, generator,
            label_smoothing, ctrls, ctrl_masks)
        metrics["grad_norm"] = optimizer.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, metrics

    def train_step(state: TrainState, codebooks, audio, generator: torch.Generator):
        with torch.no_grad():
            z = codec_model.encode(audio)[:, :n_cb, :]
        r = torch.rand((z.shape[0],), generator=generator, device=z.device)
        mask = pmask.random(generator, z, r)
        ctrls = ctrl_masks = None
        if controller is not None:
            t = z.shape[-1]
            with torch.no_grad():
                ctrls = {k: v[:, :t] for k, v in controller.extract(audio[..., 0]).items()}
            ctrl_masks = {k: v[:, :t] for k, v in
                          controller.random_mask(ctrls, r, generator).items()}
        return with_mask(state, codebooks, z, r, mask, generator, ctrls, ctrl_masks)

    train_step.with_mask = with_mask
    return train_step
