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

Over a ("dp", "tp") mesh the state is a `ShardedTrainState` and the step
`make_sharded_train_step`'s, with the JAX step's semantics over the global
batch (draws, loss, metrics, the global gradient norm), tp shards per dp
group (`parallel/train_placement.py`), the gradients summed over dp and
each dp group stepping its ZeRO-1 slice of the moments with the same
`Optimizer` (optax's bias-correction rounding, bf16 moments and LoRA-only
updates included), then giving the updated slices to every replica.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import mask as pmask
from .. import profiling
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
    def update(self, grads: List[torch.Tensor], state: OptState, params: List[torch.Tensor],
               norm: Optional[torch.Tensor] = None,
               clip_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Clip the trained parameters' `grads` (in place), step their
        moments and the parameters in place, and return the global norm of
        all `grads` before clipping. A sharded step, whose `grads` are one
        position's slices, gives the norms of the whole gradient: `norm`
        (of every gradient) and `clip_norm` (of the trained ones)."""
        if norm is None:
            norm = _global_norm(grads)
        grads, params = self._trained(grads), self._trained(params)
        if clip_norm is None:
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
    ce_sum, hits = loss_terms(logits, target, flat_mask, r, label_smoothing)
    w = flat_mask.to(torch.float32)
    loss = ce_sum / w.sum().clamp(min=1.0)
    metrics = {"loss": loss.detach()}
    denoms = metric_denominators(flat_mask, r)
    for name, hit in hits.items():
        metrics[name] = hit / denoms[name]
    return loss, metrics


def _buckets(flat_mask: torch.Tensor, r: torch.Tensor):
    """(metric name, whether it counts top-25 hits, its selection (b, t*c))
    of the stratified accuracies."""
    w = flat_mask.to(torch.float32)
    for lo, hi in ((0.0, 0.5), (0.5, 1.0)):
        in_bucket = ((r >= lo) & (r < hi)).to(torch.float32)[:, None]
        for name, sel in (("masked", w), ("unmasked", 1.0 - w)):
            for k in ("top1", "top25"):
                yield f"accuracy-{lo}-{hi}/{k}/{name}", k == "top25", sel * in_bucket


def loss_terms(logits: torch.Tensor, target: torch.Tensor, flat_mask: torch.Tensor,
               r: torch.Tensor, label_smoothing: float = 0.1):
    """The sums that `loss_and_metrics` divides, over these rows: sum(ce w)
    (with the graph), and per accuracy the hits in its selection (no
    graph). A sharded step adds them over the dp groups and divides by the
    global batch's `metric_denominators`."""
    b, t, c, v = logits.shape
    logits_flat = logits.reshape(b, t * c, v)
    target_flat = codebook_flatten(target)
    lse = torch.logsumexp(logits_flat, dim=-1)
    tgt_logit = logits_flat.gather(-1, target_flat[..., None])[..., 0]
    ce = lse - (1 - label_smoothing) * tgt_logit - label_smoothing * logits_flat.mean(-1)
    ce_sum = (ce * flat_mask.to(torch.float32)).sum()
    hits = {}
    with torch.no_grad():
        pred = logits_flat.argmax(dim=-1)
        top25 = torch.topk(logits_flat, 25, dim=-1).indices
        hit1 = (pred == target_flat).to(torch.float32)
        hit25 = (top25 == target_flat[..., None]).any(-1).to(torch.float32)
        for name, is25, sel_b in _buckets(flat_mask, r):
            hits[name] = ((hit25 if is25 else hit1) * sel_b).sum()
    return ce_sum, hits


def metric_denominators(flat_mask: torch.Tensor, r: torch.Tensor) -> dict:
    """Per accuracy, its selection's size (at least 1), of the rows given."""
    return {name: sel_b.sum().clamp(min=1.0) for name, _, sel_b in _buckets(flat_mask, r)}


def loss_and_grads(model, z_masked: torch.Tensor, codebooks: torch.Tensor,
                   target: torch.Tensor, flat_mask: torch.Tensor, r: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   label_smoothing: float = 0.1, ctrls=None, ctrl_masks=None):
    """The JAX step's `loss_fn` under `value_and_grad`: the forward with
    dropout drawn from `generator` (none without one), the loss, and the gradient of every
    trainable parameter. Returns (loss, metrics, grads)."""
    params = [p for p in model.parameters() if p.requires_grad]
    with torch.enable_grad():
        with profiling.span("train.forward"):
            logits = model.forward_codes(z_masked, codebooks, generator=generator, ctrls=ctrls,
                                         ctrl_masks=ctrl_masks)
            loss, metrics = loss_and_metrics(logits, target, flat_mask, r, label_smoothing)
        # on the card autograd runs the backward's operators on its own
        # device thread: their kernels belong to this span by its interval
        with profiling.span("train.backward"):
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
        with profiling.span("train.optimizer"):
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


# ---------------------------------------------------------------- sharded


def _all_reduce(tensors: List[torch.Tensor]) -> None:
    """Sum `tensors` over the ranks of the job, in place: one all_reduce of
    a flat buffer per device and dtype (all_reduce is a collective that
    gloo takes for CUDA tensors too, so ranks may share one card)."""
    import torch.distributed as dist

    from ..parallel import dp_group

    by_kind: dict = {}
    for t in tensors:
        by_kind.setdefault((t.device, t.dtype), []).append(t)
    for ts in by_kind.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=dp_group())
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def _norm_of(xs: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """`_global_norm` of tensors that may lie on several devices."""
    by_dev: dict = {}
    for x in xs:
        by_dev.setdefault(x.device, []).append(x)
    norms = [torch.stack(torch._foreach_norm(v)).to(device) for v in by_dev.values()]
    return torch.linalg.vector_norm(torch.cat(norms))


def _zero1_dim(spec, local_shape, dp: int) -> Optional[int]:
    """The dimension of a position's tensor that its moments split over dp
    (`zero1_specs`), or None. Where tp already split that dimension (a row
    site's adapter, which JAX replicates) the position's block is split
    again, if it divides."""
    if dp == 1 or "dp" not in spec:
        return None
    dim = spec.index("dp")
    return dim if local_shape[dim] % dp == 0 else None


@dataclasses.dataclass
class _Position:
    """One mesh position's part of the optimizer: its trained tensors'
    names, their ZeRO-1 dimension (None: the moments whole, and the update
    is made on the group's own parameter), the tensors the update steps
    (the parameter itself, or a contiguous copy of the position's dp slice
    of it) and their optimizer state."""

    g: int
    j: int
    device: torch.device
    names: List[str]
    dims: List[Optional[int]]
    masters: List[torch.Tensor]
    opt_state: Optional[OptState] = None


class ShardedTrainState:
    """A train state over a ("dp", "tp") mesh (`parallel/train_placement`):
    the parameters as `lm_param_specs` splits them (per dp group, each tp
    position its blocks, the replicated tensors once per tp group), the
    Adam moments as `zero1_specs` splits them over the global dp axis (each
    dp group the moments of its slice), and the step count.

    `state_dict()` gathers it to whole tensors in `TrainState.state_dict`'s
    layout, the single-card layout, so a checkpoint resumes on any mesh; in
    a job of several processes it is a collective (every rank calls it).
    `load_state_dict` cuts such a state dict again."""

    def __init__(self, placement, optimizer: Optimizer, trained: List[str],
                 order: List[str], zero1_min_size: int = 2 ** 14):
        from ..parallel.partition import lm_param_specs, zero1_specs

        self.placement, self.optimizer, self.step = placement, optimizer, 0
        self.trained, self.order = trained, order
        mesh = placement.mesh
        self.dp = mesh.shape["dp"]
        g0 = placement.groups[0]
        whole = {name: _whole_shape(name, g0, placement.tp) for name in order}
        shapes = {k: torch.empty(v, device="meta") for k, v in whole.items()}
        self.zspecs = zero1_specs(lm_param_specs(shapes), shapes, self.dp,
                                  min_size=zero1_min_size)
        self.local_opt = dataclasses.replace(optimizer, lora_filter=None)
        self.positions: List[_Position] = []
        for g, group in enumerate(placement.groups):
            big_g = mesh.dp_offset + g
            for j, dev in enumerate(group.devices):
                names = [n for n in trained if n in group._params[j]]
                pos = _Position(g, j, dev, names, [], [])
                for name in names:
                    p = group.param(j, name)
                    dim = _zero1_dim(self.zspecs[name], p.shape, self.dp)
                    pos.dims.append(dim)
                    pos.masters.append(p if dim is None else
                                       p.detach().chunk(self.dp, dim)[big_g].contiguous().clone())
                if names:
                    pos.opt_state = self.local_opt.init(pos.masters)
                self.positions.append(pos)

    @classmethod
    def create(cls, lm_config, mesh, state_dict, optimizer: Optimizer,
               zero1_min_size: int = 2 ** 14):
        """The sharded state of the LM whose whole `state_dict` is given
        (fp32 parameters), over `mesh`; the optimizer's `lora_filter` (one
        bool per parameter in the whole LM's order) picks what it trains.
        Tensors under `zero1_min_size` elements keep whole moments."""
        from ..modules import VampNetLM
        from ..parallel.train_placement import TrainPlacement

        order = [n for n, p in VampNetLM(lm_config, device="meta").named_parameters()
                 if p.requires_grad]
        keep = optimizer.lora_filter
        names = order if keep is None else [n for n, k in zip(order, keep) if k]
        return cls(TrainPlacement(lm_config, mesh, state_dict), optimizer, names, order,
                   zero1_min_size)

    # ---- the update ----

    def held(self):
        """(j, name, group 0's parameter) for every tensor the positions
        hold, each once: the gradient norm's terms."""
        g0 = self.placement.groups[0]
        return [(j, n, g0.param(j, n)) for j in range(self.placement.tp) for n in g0.names(j)]

    def zero_grad(self) -> None:
        for group in self.placement.groups:
            for shard in group.shards:
                shard.zero_grad(set_to_none=True)

    def update(self) -> torch.Tensor:
        """After each group's backward: sum the gradients over dp, take the
        global norm, step each position's slice of the moments and of the
        parameters, and give the updated slices to every replica. Returns
        the norm (before clipping)."""
        held = self.held()
        acc = sum_dp_grads(self.placement.groups, held, self.placement.mesh.process[1] > 1)
        home = self.placement.device
        norm = _norm_of(list(acc.values()), home)
        clip = norm
        if self.optimizer.lora_filter is not None:
            trained = set(self.trained)
            clip = _norm_of([g for (j, n), g in acc.items() if n in trained], home)
        mesh = self.placement.mesh
        # group 0 last: its whole gradients are the sums themselves
        for pos in sorted(self.positions, key=lambda p: -p.g):
            if not pos.names:
                continue
            big_g = mesh.dp_offset + pos.g
            grads = []
            for name, dim in zip(pos.names, pos.dims):
                g = acc[(pos.j, name)]
                if dim is not None:
                    g = g.chunk(self.dp, dim)[big_g].to(pos.device).contiguous()
                elif pos.g:
                    g = g.to(pos.device, copy=True)
                grads.append(g)
            self.local_opt.update(grads, pos.opt_state, pos.masters, norm=norm.to(pos.device),
                                  clip_norm=clip.to(pos.device))
        gather_slices(self)
        self.zero_grad()
        return norm

    # ---- whole tensors ----

    def _moment_lists(self, pos: _Position):
        """The position's (first moments, second moments), as lists (empty
        before the first update: torch's AdamW makes them then)."""
        st = pos.opt_state
        if st.adamw is None:
            return st.mu, st.nu
        s = st.adamw.state
        if not all(p in s for p in pos.masters):
            return [], []
        return ([s[p]["exp_avg"] for p in pos.masters], [s[p]["exp_avg_sq"] for p in pos.masters])

    def gathered_moments(self):
        """({name: whole first moment}, {name: whole second moment}) on the
        CPU, empty before the first update; a collective in a job."""
        if not self._moment_lists(self.positions[0])[0]:
            return {}, {}
        return (self._gather(lambda pos: self._moment_lists(pos)[0]),
                self._gather(lambda pos: self._moment_lists(pos)[1]))

    @torch.no_grad()
    def _gather(self, parts_of) -> dict:
        """{name: whole tensor on the CPU} from `parts_of(pos)` (one tensor
        per trained name of the position: its dp slice, or its whole
        block), the dp slices from every rank (an all_reduce of buffers
        zero outside this rank's slices)."""
        from ..parallel.partition import tp_gather

        mesh = self.placement.mesh
        blocks, split = {}, []
        for pos in self.positions:
            for name, dim, x in zip(pos.names, pos.dims, parts_of(pos)):
                key = (pos.j, name)
                if dim is None:
                    if pos.g == 0:
                        blocks[key] = x.detach().clone()
                    continue
                if key not in blocks:
                    shape = list(x.shape)
                    shape[dim] *= self.dp
                    blocks[key] = torch.zeros(shape, dtype=x.dtype, device=x.device)
                    split.append(blocks[key])
                blocks[key].chunk(self.dp, dim)[mesh.dp_offset + pos.g].copy_(x)
        if mesh.process[1] > 1 and split:
            _all_reduce(split)
        return {name: tp_gather(name, [blocks[(j, name)].cpu() for j in range(self.placement.tp)
                                       if (j, name) in blocks])
                for name in self.trained}

    @torch.no_grad()
    def params_state_dict(self) -> dict:
        """The whole LM's state dict on the CPU (group 0's replica)."""
        from ..parallel.partition import tp_gather

        g0 = self.placement.groups[0]
        out = {}
        for name in self.order:
            parts = [g0.param(j, name).detach().cpu() for j in range(self.placement.tp)
                     if name in g0._params[j]]
            out[name] = tp_gather(name, parts)
        return out

    def state_dict(self) -> dict:
        mu, nu = self.gathered_moments()
        pos0 = self.positions[0]
        count = pos0.opt_state.count
        if pos0.opt_state.adamw is None:
            opt = {"count": count, "mu": [mu[n] for n in self.trained],
                   "nu": [nu[n] for n in self.trained]}
        else:
            template = pos0.opt_state.adamw.state_dict()
            group = dict(template["param_groups"][0], params=list(range(len(self.trained))))
            step = next(iter(template["state"].values()))["step"] if template["state"] else None
            opt = {"count": count, "adamw": {
                "param_groups": [group],
                "state": {} if step is None else {
                    i: {"step": step.clone().cpu(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                    for i, n in enumerate(self.trained)}}}
        return {"params": self.params_state_dict(), "opt_state": opt, "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Cut a whole state (`state_dict`'s layout, from any mesh or one
        card) into this placement's parameters, slices and moments."""
        from ..parallel.partition import tp_slice

        params = sd["params"]
        n = self.placement.tp
        for group in self.placement.groups:
            for j in range(n):
                for name, p in group._params[j].items():
                    p.copy_(tp_slice(name, params[name], j, n))
        opt = sd["opt_state"]
        index = {name: i for i, name in enumerate(self.trained)}
        mesh = self.placement.mesh
        for pos in self.positions:
            if not pos.names:
                continue
            big_g = mesh.dp_offset + pos.g
            group = self.placement.groups[pos.g]

            def cut(whole, name, dim):
                x = tp_slice(name, whole, pos.j, n)
                return x if dim is None else x.chunk(self.dp, dim)[big_g]

            for name, dim, m in zip(pos.names, pos.dims, pos.masters):
                if dim is not None:
                    m.copy_(cut(params[name], name, dim))
                else:
                    assert m is group.param(pos.j, name)
            st = pos.opt_state
            st.count = int(opt["count"])
            if st.adamw is None:
                for name, dim, mu, nu in zip(pos.names, pos.dims, st.mu, st.nu):
                    mu.copy_(cut(opt["mu"][index[name]], name, dim))
                    nu.copy_(cut(opt["nu"][index[name]], name, dim))
                continue
            whole = opt["adamw"]
            mine = st.adamw.state_dict()
            group_sd = dict(whole["param_groups"][0], params=mine["param_groups"][0]["params"])
            state = {}
            for k, (name, dim) in enumerate(zip(pos.names, pos.dims)):
                src = whole["state"].get(index[name])
                if src is not None:
                    state[k] = {"step": src["step"].clone(),
                                "exp_avg": cut(src["exp_avg"], name, dim).contiguous(),
                                "exp_avg_sq": cut(src["exp_avg_sq"], name, dim).contiguous()}
            st.adamw.load_state_dict({"param_groups": [group_sd], "state": state})
        self.step = int(sd["step"])

    # ---- accounting ----

    def bytes_by_position(self) -> List[dict]:
        """Per position (g, j), the bytes it holds, counted from the
        tensors: parameters, Adam moments, and the contiguous copies of its
        parameters' dp slices that the update steps."""
        out = []
        for pos in self.positions:
            group = self.placement.groups[pos.g]
            params = sum(p.numel() * p.element_size() for p in group._params[pos.j].values())
            mom = 0
            if pos.opt_state is not None:
                mom = sum(x.numel() * x.element_size() for xs in self._moment_lists(pos)
                          for x in xs)
            masters = sum(m.numel() * m.element_size() for m, d in zip(pos.masters, pos.dims)
                          if d is not None)
            out.append(dict(g=pos.g, j=pos.j, params=params, moments=mom, masters=masters))
        return out


def _whole_shape(name: str, group, tp: int) -> tuple:
    from ..parallel.partition import tp_dim

    x = group.param(0, name)
    where = tp_dim(name)
    shape = list(x.shape)
    if where is not None:
        shape[where[0]] *= tp
    return tuple(shape)


def sum_dp_grads(groups, held, cross_rank: bool) -> dict:
    """{(j, name): the gradient summed over every dp group}, in fp32 on
    group 0's tensors: this process's groups in order, then over the ranks
    (`_all_reduce`). The other groups' gradients are freed."""
    acc = {}
    for j, name, p in held:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        for group in groups[1:]:
            other = group.param(j, name).grad
            if other is not None:
                g.add_(other.to(g.device))
        acc[(j, name)] = g
    if cross_rank:
        _all_reduce(list(acc.values()))
    return acc


@torch.no_grad()
def gather_slices(state: ShardedTrainState) -> None:
    """Every replica's parameters from the updated dp slices: in this
    process a copy, across ranks an all_reduce of buffers zero outside each
    rank's slices."""
    mesh = state.placement.mesh
    groups, dp = state.placement.groups, state.dp
    if mesh.process[1] == 1:
        for pos in state.positions:
            for name, dim, m in zip(pos.names, pos.dims, pos.masters):
                if dim is None:
                    continue
                big_g = mesh.dp_offset + pos.g
                for group in groups:
                    p = group.param(pos.j, name)
                    p.chunk(dp, dim)[big_g].copy_(m.to(p.device))
        return
    bufs: dict = {}
    for pos in state.positions:
        for name, dim, m in zip(pos.names, pos.dims, pos.masters):
            if dim is None:
                continue
            key = (pos.j, name)
            if key not in bufs:
                bufs[key] = torch.zeros_like(groups[0].param(pos.j, name))
            bufs[key].chunk(dp, dim)[mesh.dp_offset + pos.g].copy_(m.to(bufs[key].device))
    _all_reduce(list(bufs.values()))
    for (j, name), buf in bufs.items():
        for group in groups:
            group.param(j, name).copy_(buf.to(group.devices[j]))


class _Codecs:
    """The frozen codec on each device that a group's rows live on (the
    codec itself on its own device, a copy elsewhere)."""

    def __init__(self, codec):
        self.by_device = {next(codec.parameters()).device: codec}

    def __call__(self, device: torch.device):
        if device not in self.by_device:
            import copy

            self.by_device[device] = copy.deepcopy(next(iter(self.by_device.values()))).to(device)
        return self.by_device[device]


def _group_generator(generator: torch.Generator, big_g: int, device) -> torch.Generator:
    """Dp group big_g's dropout generator on `device`, seeded from the
    step's seed and big_g: the groups draw independent masks, the same on
    every rank and in every run."""
    seed = np.random.SeedSequence([generator.initial_seed(), big_g]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed[0]) >> 1)
    return gen


def _all_rows(x: torch.Tensor, world: int) -> torch.Tensor:
    """The global batch from each rank's rows (rank-major): an all_reduce
    of a buffer zero outside this rank's rows."""
    if world == 1:
        return x
    from ..parallel import process_index

    out = torch.zeros((world * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    rank = process_index()
    out[rank * x.shape[0]:(rank + 1) * x.shape[0]] = x
    _all_reduce([out])
    return out


def _sharded_terms(state: ShardedTrainState, codebooks, z, r, mask, mask_token: int, ncc: int,
                   label_smoothing: float, generator=None, ctrls=None, ctrl_masks=None,
                   backward: bool = False):
    """Each dp group's forward on its rows of the global batch (with the
    backward of its share of the loss where `backward`), and the global
    metrics. `z` is this process's rows; `r`, `mask` (before
    `codebook_unmask`) and the controls' masks are the global batch's; the
    controls are this process's rows. Dropout is on where a `generator` is
    given: each group draws from its own (`_group_generator`)."""
    placement = state.placement
    mesh, groups = placement.mesh, placement.groups
    home = placement.device
    mask = pmask.codebook_unmask(mask.to(home), ncc)
    r = r.to(home)
    flat = codebook_flatten(mask[:, ncc:, :])
    w_sum = flat.to(torch.float32).sum().clamp(min=1.0)
    denoms = metric_denominators(flat, r)
    rows = mask.shape[0] // state.dp
    ce_total = torch.zeros((), device=home)
    hit_total: dict = {}
    for g, group in enumerate(groups):
        big_g = mesh.dp_offset + g
        dev = group.devices[0]
        sl = slice(big_g * rows, (big_g + 1) * rows)
        zg = z[g * rows:(g + 1) * rows].to(dev)
        z_masked, mg = pmask.apply_mask(zg, mask[sl].to(dev), mask_token)
        gen = None if generator is None else _group_generator(generator, big_g, dev)
        cg = None if ctrls is None else {k: v[g * rows:(g + 1) * rows].to(dev)
                                         for k, v in ctrls.items()}
        cm = None if ctrl_masks is None else {k: v[sl].to(dev) for k, v in ctrl_masks.items()}
        with torch.set_grad_enabled(backward):
            logits = group.forward_codes(z_masked, codebooks.to(dev), generator=gen, ctrls=cg,
                                         ctrl_masks=cm)
            ce_sum, hits = loss_terms(logits, zg[:, ncc:, :], codebook_flatten(mg[:, ncc:, :]),
                                      r[sl].to(dev), label_smoothing)
            if backward:
                (ce_sum / w_sum.to(dev)).backward()
        ce_total = ce_total + ce_sum.detach().to(home)
        for k, v in hits.items():
            hit_total[k] = hit_total.get(k, 0.0) + v.to(home)
        del logits
    sums = torch.stack([ce_total] + list(hit_total.values()))
    if mesh.process[1] > 1:
        _all_reduce([sums])
    metrics = {"loss": sums[0] / w_sum}
    for k, v in zip(hit_total, sums[1:]):
        metrics[k] = v / denoms[k]
    return metrics


def make_sharded_train_step(lm_config, codec_model, optimizer: Optimizer,
                            label_smoothing: float = 0.1, controller=None,
                            encode_microbatch: Optional[int] = None):
    """The step over a `ShardedTrainState`, the counterpart of
    `jax.jit(make_train_step(...), in_shardings=..., out_shardings=...)`
    over a ("dp", "tp") mesh, with the JAX step's semantics over the global
    batch: train_step(state, codebooks, audio, generator) -> (state,
    metrics), `audio` this process's rows (the global batch's rows
    [rank b / world, (rank + 1) b / world)), `generator` seeded alike on
    every rank.

      * r, the random mask and the controls' masks are drawn for the global
        batch from `generator`, then split by rows, so a row's draws do not
        depend on the mesh;
      * each dp group encodes its rows with the frozen codec (in serial
        sub-batches of `encode_microbatch` rows) and runs its forward, with
        dropout from a generator of its own, and the backward of
        sum(ce w) over its rows / the global batch's sum(w): the gradients'
        sum over the groups is the global loss's;
      * every metric is the global batch's (sums over the groups and the
        ranks, divided by the global counts);
      * `ShardedTrainState.update`: gradients summed over dp, the global
        norm (a tp-split tensor and a replicated one each counted once),
        the clip, each dp group's ZeRO-1 slice of the moments and the
        parameters stepped, the slices gathered to every replica.

    `train_step.with_mask(state, codebooks, z, r, mask, generator, ctrls,
    ctrl_masks)` is the step after the draws (z this process's encoded
    rows, r and mask the global batch's), as `make_train_step`'s;
    `train_step.eval_step(state, codebooks, audio, generator)` the global
    metrics of the deterministic forward, no update."""
    cfg = lm_config
    n_cb, ncc, mask_token = cfg.n_codebooks, cfg.n_conditioning_codebooks, cfg.mask_token
    codecs = _Codecs(codec_model)

    def with_mask(state: ShardedTrainState, codebooks, z, r, mask, generator=None, ctrls=None,
                  ctrl_masks=None):
        state.zero_grad()
        metrics = _sharded_terms(state, codebooks, z, r, mask, mask_token, ncc, label_smoothing,
                                 generator, ctrls, ctrl_masks, backward=True)
        metrics["grad_norm"] = state.update()
        state.step += 1
        return state, metrics

    def encode(state, audio):
        """This process's rows, each group's encoded on its device."""
        out = []
        for group, a in zip(state.placement.groups, audio.chunk(len(state.placement.groups))):
            codec = codecs(group.devices[0])
            a = a.to(group.devices[0])
            mb = encode_microbatch
            with torch.no_grad():
                if mb and 0 < mb < a.shape[0]:
                    out.append(torch.cat([codec.encode(x)[:, :n_cb, :] for x in a.split(mb)]))
                else:
                    out.append(codec.encode(a)[:, :n_cb, :])
        home = state.placement.device
        return torch.cat([x.to(home) for x in out])

    def draws(state, z, audio, generator):
        """r, the mask and the controls' masks of the global batch, and the
        controls of this process's rows, from `generator`."""
        world = state.placement.mesh.process[1]
        b, t = z.shape[0] * world, z.shape[-1]
        dev = generator.device
        r = torch.rand((b,), generator=generator, device=dev)
        mask = pmask.random(generator, torch.empty((b, n_cb, t), device=dev), r)
        ctrls = ctrl_masks = None
        if controller is not None:
            # the controls of the global batch (an rms envelope is scaled by
            # the whole batch's range), then this process's rows
            whole = _all_rows(audio.to(dev), world)
            with torch.no_grad():
                ctrls = {k: v[:, :t] for k, v in controller.extract(whole[..., 0]).items()}
            ctrl_masks = {k: v[:, :t]
                          for k, v in controller.random_mask(ctrls, r, generator).items()}
            rank, rows = state.placement.mesh.process[0], z.shape[0]
            ctrls = {k: v[rank * rows:(rank + 1) * rows] for k, v in ctrls.items()}
        return r, mask, ctrls, ctrl_masks

    def check_batch(state, audio):
        b = audio.shape[0] * state.placement.mesh.process[1]
        mb = encode_microbatch
        if mb and b % mb != 0:
            raise ValueError(f"encode_microbatch={mb} must divide the batch ({b})")
        if b % state.dp:
            raise ValueError(f"batch_size {b} not divisible by dp {state.dp}")

    def train_step(state: ShardedTrainState, codebooks, audio, generator: torch.Generator):
        check_batch(state, audio)
        z = encode(state, audio)
        r, mask, ctrls, ctrl_masks = draws(state, z, audio, generator)
        return with_mask(state, codebooks, z, r, mask, generator, ctrls, ctrl_masks)

    @torch.no_grad()
    def eval_step(state: ShardedTrainState, codebooks, audio, generator: torch.Generator) -> dict:
        check_batch(state, audio)
        z = encode(state, audio)
        r, mask, ctrls, ctrl_masks = draws(state, z, audio, generator)
        return _sharded_terms(state, codebooks, z, r, mask, mask_token, ncc, label_smoothing,
                              None, ctrls, ctrl_masks)

    train_step.with_mask = with_mask
    train_step.eval_step = eval_step
    return train_step
