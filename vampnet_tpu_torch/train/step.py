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

Options, as in the JAX package:
  * `make_optimizer(state_dtype="bfloat16")` stores both Adam moments in
    bf16 (`_scale_by_adam_lowmem`): the moment math runs in fp32 and is
    rounded once on store. `torch.optim.AdamW` cannot keep bf16 moments with
    fp32 math, so this is the port's own update (`_adam_lowmem`, foreach ops
    over groups of parameters, optax's bias-correction rounding);
  * `make_optimizer(lora_filter=)` updates only the adapter leaves (optax's
    `multi_transform` with `set_to_zero` for the rest): the frozen leaves get
    no moments, no weight decay and no update, and the clip norm is taken
    over the adapters' gradients alone; `grad_norm` stays the norm of every
    gradient, as the JAX step reports it;
  * `make_train_step(encode_microbatch=k)` runs the frozen encode in serial
    sub-batches of k rows; `LMConfig.remat` recomputes each layer in the
    backward (`modules/transformer.py`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import mask as pmask
from ..modules.lora import LORA_LEAVES
from ..util import codebook_flatten
from .scheduler import noam_schedule


@dataclasses.dataclass
class OptState:
    """The number of updates made, and the moments: in a `torch.optim.AdamW`
    (fp32) or in the lists `mu` and `nu` (`state_dtype` moments), over the
    parameters the optimizer trains."""

    count: int
    adamw: Optional[torch.optim.AdamW] = None
    mu: Optional[List[torch.Tensor]] = None
    nu: Optional[List[torch.Tensor]] = None

    def state_dict(self) -> dict:
        if self.adamw is not None:
            return {"count": self.count, "adamw": self.adamw.state_dict()}
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        if self.adamw is not None:
            self.adamw.load_state_dict(sd["adamw"])
            return
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, list(sd["mu"]) + list(sd["nu"])):
                dst.copy_(src)


# the low-precision update holds two fp32 temporaries per parameter (the
# moments before their rounding): it walks the parameters in groups of about
# this many elements
_LOWMEM_GROUP = 1 << 26


def _global_norm(xs: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(xs)))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """clip_by_global_norm(grad_clip) -> AdamW(b1 0.9, b2 0.999, eps 1e-8)
    under `schedule`, with optax's semantics (module docstring). With
    `lora_filter`, one bool per parameter handed to `init` and `update`
    (True where it is trained); with `state_dtype`, the moments' dtype."""

    schedule: Callable[[int], float]
    weight_decay: float = 0.01
    grad_clip: float = 5.0
    lora_filter: Optional[Tuple[bool, ...]] = None
    state_dtype: Optional[torch.dtype] = None

    @property
    def lowmem(self) -> bool:
        return self.state_dtype not in (None, torch.float32)

    def _trained(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.lora_filter is None:
            return list(xs)
        if len(self.lora_filter) != len(xs):
            raise ValueError(f"lora_filter has {len(self.lora_filter)} entries for "
                             f"{len(xs)} parameters")
        return [x for x, keep in zip(xs, self.lora_filter) if keep]

    def init(self, params: List[torch.Tensor]) -> OptState:
        params = self._trained(params)
        if not params:
            raise ValueError("the optimizer has no parameter to train")
        if self.lowmem:
            return OptState(0, mu=[torch.zeros_like(p, dtype=self.state_dtype) for p in params],
                            nu=[torch.zeros_like(p, dtype=self.state_dtype) for p in params])
        return OptState(0, torch.optim.AdamW(
            params, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=self.weight_decay, fused=True))

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState,
               params: List[torch.Tensor]) -> torch.Tensor:
        """Clip the trained parameters' `grads` (in place), step their
        moments and the parameters in place, and return the global norm of
        all `grads` before clipping."""
        norm = _global_norm(grads)
        grads, params = self._trained(grads), self._trained(params)
        clip_norm = norm if self.lora_filter is None else _global_norm(grads)
        trigger = clip_norm < self.grad_clip
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        # optax: select(trigger, g, (g / norm) * max), without a host sync
        torch._foreach_div_(grads, torch.where(trigger, one, clip_norm))
        torch._foreach_mul_(grads, torch.where(trigger, one, one * self.grad_clip))
        lr = self.schedule(state.count)
        state.count += 1
        # optax bias-corrects in fp32, where 1 - 0.999 ** 1 is 1.3e-5 off
        f32, n = np.float32, state.count
        bc1_32 = float(f32(1) - f32(0.9) ** f32(n))
        bc2_32 = float(f32(1) - f32(0.999) ** f32(n))
        if self.lowmem:
            self._adam_lowmem(grads, state, params, lr, bc1_32, bc2_32)
            return norm
        for p, g in zip(params, grads):
            # the fused update reads a grad as laid out like its parameter;
            # autograd may hand back a strided view (the MASK latents' is a
            # slice of the codebook table's gradient)
            p.grad = g.contiguous()
        # torch bias-corrects in float64. These lr, eps and weight decay make
        # torch's lr / bc1 mu / (sqrt(nu) / sqrt(bc2) + eps) and p (1 - lr wd)
        # optax's.
        bc1, bc2 = 1 - 0.9 ** n, 1 - 0.999 ** n
        c = math.sqrt(bc2_32 / bc2)
        group = state.adamw.param_groups[0]
        group.update(lr=lr * c * bc1 / bc1_32, eps=1e-8 * c,
                     weight_decay=self.weight_decay * bc1_32 / (c * bc1))
        state.adamw.step()
        state.adamw.zero_grad(set_to_none=True)
        return norm

    def _adam_lowmem(self, grads, state: OptState, params, lr: float, bc1: float,
                     bc2: float) -> None:
        """optax's chain scale_by_adam (moments stored in `state_dtype`, math
        in fp32) -> add_decayed_weights -> scale_by_learning_rate, in place:
        mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2,
        p += -lr ((mu / bc1) / (sqrt(nu / bc2) + eps) + wd p)."""
        b1, b2, eps = 0.9, 0.999, 1e-8
        lo = 0
        while lo < len(params):
            hi, size = lo, 0
            while hi < len(params) and (hi == lo or size + params[hi].numel() <= _LOWMEM_GROUP):
                size += params[hi].numel()
                hi += 1
            g, p = grads[lo:hi], params[lo:hi]
            mu32 = [m.float() for m in state.mu[lo:hi]]
            torch._foreach_mul_(mu32, b1)
            torch._foreach_add_(mu32, g, alpha=1 - b1)
            nu32 = [v.float() for v in state.nu[lo:hi]]
            torch._foreach_mul_(nu32, b2)
            torch._foreach_addcmul_(nu32, g, g, value=1 - b2)
            torch._foreach_copy_(state.mu[lo:hi], mu32)  # rounded once, on store
            torch._foreach_copy_(state.nu[lo:hi], nu32)
            torch._foreach_div_(mu32, bc1)
            torch._foreach_div_(nu32, bc2)
            torch._foreach_sqrt_(nu32)
            torch._foreach_add_(nu32, eps)
            torch._foreach_div_(mu32, nu32)
            del nu32
            torch._foreach_add_(mu32, p, alpha=self.weight_decay)
            torch._foreach_mul_(mu32, -lr)
            torch._foreach_add_(p, mu32)
            lo = hi


def make_optimizer(d_model: int, factor: float = 2.0, warmup: int = 10000,
                   weight_decay: float = 0.01, grad_clip: float = 5.0,
                   lora_filter: Optional[Sequence[bool]] = None,
                   state_dtype=None) -> Optimizer:
    """AdamW + grad clip + Noam schedule (reference conf/vampnet.yml: AdamW
    lr scaled by NoamScheduler factor=2.0 warmup=10000; clip 5.0). With
    `lora_filter` (`lora_filter(model)`), only the adapter leaves are
    updated. `state_dtype="bfloat16"` stores the Adam moments in bf16; None
    or "float32" keeps torch's fused fp32 AdamW."""
    if isinstance(state_dtype, str):
        state_dtype = getattr(torch, state_dtype)
    return Optimizer(noam_schedule(d_model, factor=factor, warmup=warmup),
                     weight_decay=weight_decay, grad_clip=grad_clip,
                     lora_filter=None if lora_filter is None else tuple(map(bool, lora_filter)),
                     state_dtype=state_dtype)


def lora_filter(model: torch.nn.Module) -> List[bool]:
    """One bool per trainable parameter of `model`, in `TrainState.params`
    order: True at the LoRA adapters (`lora_a`, `lora_b`), which a LoRA
    fine-tune trains."""
    return [name.rsplit(".", 1)[-1] in LORA_LEAVES
            for name, p in model.named_parameters() if p.requires_grad]


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

    def state_dict(self) -> dict:
        """The parameters, the optimizer's state and the step, as tensors on
        the state's device (a checkpoint copies them to the host)."""
        return {"params": self.model.state_dict(), "opt_state": self.opt_state.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["params"], strict=True)
        self.opt_state.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])


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
                    label_smoothing: float = 0.1, controller=None,
                    encode_microbatch: Optional[int] = None):
    """Returns train_step(state, codebooks, audio, generator) -> (state,
    metrics): encode with the frozen codec, draw r ~ U(0, 1) and the random
    mask from `generator` (with a `controller`, extract the controls from
    the audio and draw their masks too), then `train_step.with_mask`.
    `encode_microbatch=k` encodes in serial sub-batches of k rows (the
    encoder's first block holds the step's largest activations); k must
    divide the batch.

    `train_step.with_mask(state, codebooks, z, r, mask, generator, ctrls,
    ctrl_masks)` is the step after the random draws: `codebook_unmask` ->
    `apply_mask` -> forward, loss and grads -> clip and AdamW. The tests
    hand it the JAX step's r, mask and control masks."""
    cfg = lm_model.config
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
        mb = encode_microbatch
        # loud, not silent: a user sets this because the full-batch encode
        # runs out of memory, and a fallback would reproduce that
        if mb and audio.shape[0] % mb != 0:
            raise ValueError(f"encode_microbatch={mb} must divide the batch ({audio.shape[0]})")
        with torch.no_grad():
            if mb and 0 < mb < audio.shape[0]:
                z = torch.cat([codec_model.encode(a)[:, :n_cb, :] for a in audio.split(mb)])
            else:
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
