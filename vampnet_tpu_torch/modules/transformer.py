"""VampNet masked-token transformer LM (counterpart of
`vampnet_tpu/modules/transformer.py`).

A bidirectional pre-norm T5-style stack: RMSNorm -> self-attention with a
relative-position bias (the bucket table lives on layer 0 and the bias is
shared by every layer) -> GEGLU feed-forward, over codec-token embeddings,
with a Dense classifier. Activations are (b, t, d); logits come out
(b, t, n_predict_codebooks, vocab) in fp32, the classifier's columns
codebook-major as in the JAX package.

Weights may be stored in any float dtype; every projection computes in
`LMConfig.compute_dtype` (bf16 by default, fp32 for parity work), RMSNorm
statistics in fp32. Dropout (training) sits where the JAX package has it:
on the GEGLU hidden, and on the attention and FFN outputs before their
residual adds.

Two serving options, as in the JAX package: `quantization="int8"` runs every
attention and FFN projection as a w8a8 matmul (`LoRADense(quantize=True)`),
and `ffn_impl="fused"` runs each layer's RMSNorm, GEGLU feed-forward and
residual add as one kernel (`ops/ffn_kernel.py`). `attention_impl` picks the
attention route (`ops/attention.py`): "auto" (the kernels on the card),
"pallas", "xla" (the library call) or "ring" (sequence-parallel ring
attention, which runs only inside a `RingStack`). `TransformerStack`
takes an attention mask `x_mask` (b, t, t) or (b, 1, t, t), 0 = blocked, as
the JAX stack does; `VampNetLM` passes none, as in JAX. LoRA adapters
(`lora_r > 0`) sit on w_qs, w_vs, fc, w_1 and w_2 (`modules/lora.py`). With
`ctrl_dims` the LM takes sketch2sound controls: a `ControlEncoder` (one
Dense per control, masked per frame, classifier-free-guidance dropout while
training) adds them to the embedding before the stack. With `remat` the
stack recomputes each layer in the backward (`torch.utils.checkpoint`)
instead of keeping its activations, its dropout masks redrawn from a copy of
the generator's state at the layer (`_remat_layer`).

Two sharded stacks replace `TransformerStack` (`VampNetLM.forward(stack=)`,
which `Interface.shard` sets up through `parallel/placement.py` for
inference; the training placement, `parallel/train_placement.py`, runs a
trainable `TensorParallelStack` with dropout and remat):
  * `TensorParallelStack`: the layers split Megatron-style over the devices
    of a tp group (`parallel/partition.py`): each shard holds h/tp heads of
    q, k, v with the matching columns of fc, and f = 2d/tp GEGLU units (its
    block of w_1's value half and the same block of its gate half) with the
    matching columns of w_2. Each shard's attention takes its heads' slice
    of the T5 bias; the fc and w_2 partial sums meet on the group's first
    device, where the residual is added once (the fused FFN's kernel adds
    it on shard 0 only). An int8 LM keeps fc and w_2 whole on the first
    device (`row_parallel`): w8a8 quantizes each activation row by its
    absmax, which a shard of the row's features cannot know, so the sharded
    int8 forward is the unsharded one bit for bit. The other shards of an
    int8 group hold no fc or w_2, and a group's stack is all a replica on
    another device needs of the layers.
  * `RingStack`: the time axis split over the devices of an sp mesh; every
    layer is position-wise but attention, which runs as ring attention
    (`ops/ring_attention.py`) over the q, k, v shards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.attention import IMPLS, dot_product_attention
from ..ops.flash_attention import attention_mask
from ..ops.ffn_kernel import fused_geglu_ffn
from ..ops.relative_bias import RelativePositionBias
from .activations import new_gelu
from .layers import CodebookEmbedding, Dense
from .lora import LoRADense


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Hyperparameters, with the JAX `LMConfig`'s defaults and field names."""

    n_heads: int = 20
    n_layers: int = 16
    n_codebooks: int = 9
    n_conditioning_codebooks: int = 0
    latent_dim: int = 8
    embedding_dim: int = 1280
    vocab_size: int = 1024
    dropout: float = 0.1
    lora_r: int = 0
    attention_num_buckets: int = 32
    attention_max_distance: int = 128
    attention_impl: str = "auto"  # auto | pallas | xla | ring (ops/attention.py)
    ffn_impl: str = "auto"  # auto | xla | fused; "auto" is the unfused path, as in JAX
    remat: bool = False  # recompute each layer in the backward (training memory)
    quantization: Optional[str] = None  # None | "int8" (w8a8 projections)
    ctrl_dims: Optional[Tuple[Tuple[str, int], ...]] = None  # (name, dim) per control
    cfg_dropout_prob: float = 0.2
    compute_dtype: str = "bfloat16"

    @property
    def n_predict_codebooks(self) -> int:
        return self.n_codebooks - self.n_conditioning_codebooks

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def mask_token(self) -> int:
        return self.vocab_size

    @staticmethod
    def coarse(**kw) -> "LMConfig":
        """4 codebooks, 20 layers."""
        return LMConfig(**{**dict(n_codebooks=4, n_conditioning_codebooks=0, n_layers=20), **kw})

    @staticmethod
    def c2f(**kw) -> "LMConfig":
        """14 codebooks (4 conditioning), 16 layers."""
        return LMConfig(**{**dict(n_codebooks=14, n_conditioning_codebooks=4, n_layers=16), **kw})


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool = True,
                             num_buckets: int = 32, max_distance: int = 128) -> torch.Tensor:
    """T5 bucketing of relative positions: half exact buckets, half
    log-spaced up to max_distance. The log is taken in fp32 and truncated to
    an integer, as the JAX function does."""
    ret = torch.zeros_like(relative_position)
    n = relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).to(n.dtype) * num_buckets
        n = torch.abs(n)
    else:
        n = torch.clamp(-n, min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(torch.clamp(n, min=1).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(n.dtype)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def position_bias_from_params(model: "VampNetLM", t_q: int,
                              t_k: Optional[int] = None) -> torch.Tensor:
    """(heads, t_q, t_k) T5 bias from layer 0's bucket table, in the table's
    dtype. It depends only on the sequence length, so the serving path builds
    it once per request and hands it to every forward."""
    return position_bias_from_table(model.transformer.layers_0.self_attn.relative_attention_bias,
                                    model.config, t_q, t_k)


def position_bias_from_table(table: torch.Tensor, cfg: LMConfig, t_q: int,
                             t_k: Optional[int] = None) -> torch.Tensor:
    """`position_bias_from_params` from the bucket table itself, as
    `RelativePositionBias` over the buckets of the t_q + t_k - 1 offsets j - i:
    its backward sums the bias's gradient into the table with one kernel.
    Under no_grad, or for a frozen table, it records no graph."""
    t_k = t_q if t_k is None else t_k
    offsets = relative_position_bucket(
        torch.arange(-(t_q - 1), t_k, device=table.device), bidirectional=True,
        num_buckets=cfg.attention_num_buckets, max_distance=cfg.attention_max_distance)
    return RelativePositionBias.apply(table, offsets, t_q, t_k)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax `nn.Dropout` semantics: keep each element with probability 1 - p
    and scale the kept ones by 1 / (1 - p), in x's dtype. The draws come from
    `generator` (on x's device); with no generator, or p = 0, it is the
    identity (the deterministic path)."""
    if generator is None or p == 0.0:
        return x
    return dropout_kept(x, torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p, p)


def dropout_kept(x: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """`dropout` with its draws given: x / (1 - p) where `keep`, else 0."""
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class RMSNorm(nn.Module):
    """Scale-only T5 layer norm with fp32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (self.weight.float() * y).to(x.dtype)


def row_parallel(cfg: LMConfig) -> bool:
    """Whether a tensor-parallel shard splits the row sites (fc, w_2) by
    their inputs. Not for an int8 LM: w8a8 scales each activation row by
    its absmax over all its features, which a shard of them cannot know."""
    return cfg.quantization != "int8"


class MultiHeadRelativeAttention(nn.Module):
    """Self-attention over (b, t, d) with a head-shared additive bias."""

    def __init__(self, d_model: int, n_head: int, has_relative_attention_bias: bool,
                 cfg: LMConfig, device=None, tp: int = 1):
        super().__init__()
        if cfg.attention_impl not in IMPLS:
            raise ValueError(f"attention_impl must be one of {IMPLS}, got {cfg.attention_impl!r}")
        # a tensor-parallel shard (tp > 1) holds n_head / tp heads
        self.n_head = n_head // tp
        self.d_head = d_model // n_head
        self.attention_impl = cfg.attention_impl
        inner = self.n_head * self.d_head
        dense = lambda n_in, n_out, r: LoRADense(n_in, n_out, r=r, compute_dtype=cfg.dtype,
                                                 quantize=cfg.quantization == "int8",
                                                 device=device)
        # the key projection never takes adapters, as in the JAX package
        self.w_qs, self.w_ks = dense(d_model, inner, cfg.lora_r), dense(d_model, inner, 0)
        self.w_vs = dense(d_model, inner, cfg.lora_r)
        self.fc = dense(inner if row_parallel(cfg) else d_model, d_model, cfg.lora_r)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Parameter(
                torch.empty(cfg.attention_num_buckets, n_head, device=device)
            )

    def project(self, x: torch.Tensor):
        """q, k, v (b, t, heads, d_head) of x (b, t, d)."""
        b, t, _ = x.shape
        shape = (b, t, self.n_head, self.d_head)
        return (self.w_qs(x).reshape(shape), self.w_ks(x).reshape(shape),
                self.w_vs(x).reshape(shape))

    def attend(self, x: torch.Tensor, position_bias: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The heads' outputs (b, t, heads * d_head), before fc."""
        q, k, v = self.project(x)
        out = dot_product_attention(q, k, v, bias=position_bias, mask=mask,
                                    impl=self.attention_impl)
        return out.reshape(x.shape[0], x.shape[1], -1)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.fc(self.attend(x, position_bias, mask))


class FeedForward(nn.Module):
    """GEGLU feed-forward: w_1 to 4d, gate one half by the GELU of the
    other, w_2 from 2d back to d."""

    def __init__(self, d_model: int, cfg: LMConfig, device=None, tp: int = 1):
        super().__init__()
        self.p = cfg.dropout
        quantize = cfg.quantization == "int8"
        units = 2 * d_model // tp  # a tensor-parallel shard's GEGLU units
        self.w_1 = LoRADense(d_model, 2 * units, r=cfg.lora_r,
                             compute_dtype=cfg.dtype, quantize=quantize, device=device)
        self.w_2 = LoRADense(units if row_parallel(cfg) else 2 * d_model, d_model, r=cfg.lora_r,
                             compute_dtype=cfg.dtype, quantize=quantize, device=device)

    def hidden(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The gated hidden units p1 * gelu(p2), before w_2; dropout drawn
        from `generator`, or given as its `keep` mask (a tensor-parallel
        shard's block of the units' draws)."""
        p1, p2 = self.w_1(x).chunk(2, dim=-1)
        if keep is not None:
            return dropout_kept(p1 * new_gelu(p2), keep, self.p)
        return dropout(p1 * new_gelu(p2), self.p, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.w_2(self.hidden(x, generator))


class TransformerLayer(nn.Module):
    """Pre-norm block: RMSNorm -> self-attention -> residual,
    RMSNorm -> FFN -> residual. With `ffn_impl="fused"` the second half is
    one call of `fused_geglu_ffn` on the pre-norm x, fed `norm_3.weight` and
    the FFN's weights; the state dict is the unfused path's."""

    def __init__(self, cfg: LMConfig, has_relative_attention_bias: bool, device=None,
                 tp: int = 1):
        super().__init__()
        if cfg.ffn_impl not in ("auto", "xla", "fused"):
            raise ValueError(f"ffn_impl must be auto, xla or fused, got {cfg.ffn_impl!r}")
        if cfg.quantization not in (None, "int8"):
            raise ValueError(f"quantization must be None or 'int8', got {cfg.quantization!r}")
        self.fused_ffn = cfg.ffn_impl == "fused"
        if self.fused_ffn and (cfg.lora_r != 0 or cfg.quantization is not None):
            # the fused kernel has no LoRA or int8 path; never fall back quietly
            raise ValueError("ffn_impl='fused' needs no dropout generator, lora_r=0, no int8")
        d = cfg.embedding_dim
        self.p = cfg.dropout
        self.norm_1 = RMSNorm(d, device=device)
        self.self_attn = MultiHeadRelativeAttention(
            d, cfg.n_heads, has_relative_attention_bias, cfg, device=device, tp=tp)
        self.norm_3 = RMSNorm(d, device=device)
        self.feed_forward = FeedForward(d, cfg, device=device, tp=tp)

    def fused(self, x: torch.Tensor, residual: bool = True) -> torch.Tensor:
        """The fused kernel's call on x: x + FeedForward(RMSNorm(x)), or the
        feed-forward alone (a tensor-parallel shard's partial sum)."""
        ff = self.feed_forward
        return fused_geglu_ffn(x.to(ff.w_1.compute_dtype), self.norm_3.weight, ff.w_1.weight,
                               ff.w_2.weight, self.norm_3.eps, residual=residual)

    def ffn_block(self, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The layer's second half: x + FeedForward(RMSNorm(x))."""
        if self.fused_ffn:
            if generator is not None:
                raise ValueError("ffn_impl='fused' needs no dropout generator, lora_r=0, no int8")
            return self.fused(x)
        y = self.feed_forward(self.norm_3(x), generator)
        return x + dropout(y, self.p, generator)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + dropout(self.self_attn(self.norm_1(x), position_bias, x_mask), self.p, generator)
        return self.ffn_block(x, generator)


def _remat(fn, generator: Optional[torch.Generator], *inputs: torch.Tensor) -> torch.Tensor:
    """`fn(generator, *inputs)` under `torch.utils.checkpoint`: the backward
    recomputes it. The recompute draws its dropout masks from a generator of
    its own, set to the state the caller's generator had before the call, so
    it redraws the forward's masks (checkpoint's `preserve_rng_state` covers
    only the default generators), and the caller's generator ends where it
    ends without remat."""
    from torch.utils.checkpoint import checkpoint

    state = None if generator is None else generator.get_state()
    first = [True]

    def run(*inputs):
        gen = generator
        if gen is not None and not first[0]:
            gen = torch.Generator(device=generator.device)
            gen.set_state(state)
        first[0] = False
        return fn(gen, *inputs)

    return checkpoint(run, *inputs, use_reentrant=False, preserve_rng_state=False)


def _remat_layer(layer: TransformerLayer, x: torch.Tensor, position_bias: torch.Tensor,
                 generator: Optional[torch.Generator],
                 x_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """`layer(x, ...)` recomputed in the backward (`_remat`)."""
    return _remat(lambda gen, x, pb: layer(x, pb, gen, x_mask), generator, x, position_bias)


class TransformerStack(nn.Module):
    """n_layers layers (`layers_0` holds the bucket table) and a final norm.
    `x_mask` (b, t, t) or (b, 1, t, t), 0 = blocked, reaches every layer's
    attention; it is turned into the kernels' bool (b, t, t) once here. With
    `cfg.remat`, a forward that records gradients recomputes each layer in the
    backward."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        self.n_layers = cfg.n_layers
        self.remat = cfg.remat
        for i in range(cfg.n_layers):
            self.add_module(f"layers_{i}", TransformerLayer(cfg, i == 0, device=device))
        self.norm = RMSNorm(cfg.embedding_dim, device=device)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x_mask is not None:
            x_mask = attention_mask(x_mask, x)
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.n_layers):
            layer = getattr(self, f"layers_{i}")
            if remat:
                x = _remat_layer(layer, x, position_bias, generator, x_mask)
            else:
                x = layer(x, position_bias, generator, x_mask)
        return self.norm(x)


def _sum_on(parts, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The sum of the shards' partial results on `device`, taken in fp32
    and rounded once to `dtype` (the reduction at the end of a row-parallel
    product)."""
    acc = parts[0].to(device).float()
    for p in parts[1:]:
        acc = acc + p.to(device).float()
    return acc.to(dtype)


def _shard_layers(lm: "VampNetLM", j: int, n: int, device: torch.device) -> list:
    """Tensor-parallel shard j of n of `lm`'s layers, on `device`. Without
    `row_parallel` only shard 0 holds fc and w_2 (whole); the others have
    none."""
    from ..parallel.partition import tp_shard_state_dict

    cfg = lm.config
    part = tp_shard_state_dict(lm.state_dict(), j, n, row_parallel(cfg))
    no_rows = j > 0 and not row_parallel(cfg)  # shard 0 runs the whole row sites
    layers = []
    for i in range(cfg.n_layers):
        prefix = f"transformer.layers_{i}."
        layer = TransformerLayer(cfg, False, device="meta", tp=n)
        sd = {k[len(prefix):]: v.to(device).contiguous() for k, v in part.items()
              if k.startswith(prefix) and not (no_rows and (".self_attn.fc." in k
                                                            or ".feed_forward.w_2." in k))}
        if no_rows:
            layer.self_attn.fc = layer.feed_forward.w_2 = None
        layer.load_state_dict(sd, strict=True, assign=True)
        layers.append(layer.requires_grad_(False).eval())
    return layers


# the adapters that every tensor-parallel shard multiplies whole: a column
# site's lora_a (its inputs are whole) and a row site's lora_b (its outputs)
REPLICATED_LORA = (("self_attn", "w_qs", "lora_a"), ("self_attn", "w_vs", "lora_a"),
                   ("feed_forward", "w_1", "lora_a"), ("self_attn", "fc", "lora_b"),
                   ("feed_forward", "w_2", "lora_b"))


class TensorParallelStack:
    """`lm`'s layers split over `devices` (one tp group), with its final
    norm on the first device: a stand-in for `lm.transformer`,
    `stack(x, position_bias, generator)` with x and the output on the first
    device. Shard j holds heads [j h/n, (j+1) h/n) and GEGLU units
    [j f/n, (j+1) f/n) of each half of w_1 (`tp_shard_state_dict`). Without
    `row_parallel` (the int8 LMs) fc and w_2 run whole on the first device
    on the heads' and units' outputs gathered in order. RMSNorm runs once,
    on the first device, with the first shard's scale.

    Built two ways. `TensorParallelStack(lm, devices)` for inference: frozen
    copies of `lm`'s shards. `TensorParallelStack.trainable(cfg, devices,
    transformers)` for training, over the `transformer` modules of a
    training placement's shards (`parallel/train_placement.py`): each holds
    its blocks as parameters, and the first shard alone holds the tensors
    every shard computes with whole (norm_1, norm_3, the final norm, the
    bucket table, `REPLICATED_LORA`), which reach the other shards as
    differentiable copies, so autograd sums their gradients into the one
    parameter. A `generator` turns dropout on at the training forward's
    three sites: the attention and FFN outputs, after their partial sums
    (drawn once, on the first device), and the GEGLU hidden units, drawn
    for all units on the first device and split by units, so that with the
    unsharded stack's generator the draws are its own. With `cfg.remat` a
    forward that records gradients recomputes each layer (`_remat`)."""

    def __init__(self, lm: "VampNetLM", devices):
        self._setup(lm.config, devices)
        norm = lm.transformer.norm
        if norm.weight.device != self.devices[0]:
            import copy

            norm = copy.deepcopy(norm).to(self.devices[0])
        self.norm = norm
        self.shards = [_shard_layers(lm, j, self.n, dev) for j, dev in enumerate(self.devices)]
        self.bound = []

    @classmethod
    def trainable(cls, cfg: LMConfig, devices, transformers) -> "TensorParallelStack":
        self = cls.__new__(cls)
        self._setup(cfg, devices)
        self.norm = transformers[0].norm
        self.shards = [[getattr(t, f"layers_{i}") for i in range(cfg.n_layers)]
                       for t in transformers]
        # (shard j's module, leaf, shard 0's parameter) for each replicated
        # adapter of the other shards, copied to them at every forward
        self.bound = []
        for i in range(cfg.n_layers * bool(cfg.lora_r)):
            for shard in self.shards[1:]:
                for part, site, leaf in REPLICATED_LORA:
                    module = getattr(getattr(shard[i], part), site)
                    home = getattr(getattr(self.shards[0][i], part), site)
                    self.bound.append((module, leaf, getattr(home, leaf)))
        return self

    def _setup(self, cfg: LMConfig, devices) -> None:
        n = len(devices)
        if cfg.n_heads % n or (2 * cfg.embedding_dim) % n:
            raise ValueError(f"tp={n} must divide the {cfg.n_heads} heads and "
                             f"{2 * cfg.embedding_dim} GEGLU units")
        self.config, self.n = cfg, n
        self.devices = [torch.device(d) for d in devices]
        self.row_parallel = row_parallel(cfg)

    def shard_biases(self, position_bias: torch.Tensor) -> list:
        """Each shard's heads of the bias, a contiguous block of its rows, on
        the shard's device."""
        h = self.config.n_heads // self.n
        return [position_bias[j * h:(j + 1) * h].to(dev) for j, dev in enumerate(self.devices)]

    def __call__(self, x: torch.Tensor, position_bias: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for module, leaf, param in self.bound:
            setattr(module, leaf, param.to(module.weight.device))
        biases = self.shard_biases(position_bias)
        remat = self.config.remat and torch.is_grad_enabled()
        for i in range(self.config.n_layers):
            if remat:
                x = _remat(lambda gen, x, *bs, i=i: self._layer(i, x, bs, gen), generator, x,
                           *biases)
            else:
                x = self._layer(i, x, biases, generator)
        return self.norm(x)

    def _layer(self, i: int, x: torch.Tensor, biases, generator) -> torch.Tensor:
        cfg, devs, p = self.config, self.devices, self.config.dropout
        dt, home = x.dtype, devs[0]
        layers = [shard[i] for shard in self.shards]
        h = layers[0].norm_1(x)
        outs = [lay.self_attn.attend(h.to(dev), bias)
                for lay, dev, bias in zip(layers, devs, biases)]
        if self.row_parallel:
            a = _sum_on([lay.self_attn.fc(o) for lay, o in zip(layers, outs)], home, dt)
        else:
            a = layers[0].self_attn.fc(torch.cat([o.to(home) for o in outs], dim=-1))
        x = x + dropout(a, p, generator)
        if layers[0].fused_ffn:
            if generator is not None:
                raise ValueError("ffn_impl='fused' needs no dropout generator, lora_r=0, no int8")
            # the residual once: shard 0's kernel adds x, the others do not
            return _sum_on([lay.fused(x.to(dev), residual=j == 0)
                            for j, (lay, dev) in enumerate(zip(layers, devs))], home, dt)
        h = layers[0].norm_3(x)
        keeps = [None] * self.n
        if generator is not None and p != 0.0:
            keep = torch.rand((*h.shape[:-1], 2 * cfg.embedding_dim), generator=generator,
                              device=home) < 1.0 - p
            keeps = [k.to(dev) for k, dev in zip(keep.chunk(self.n, dim=-1), devs)]
        gs = [lay.feed_forward.hidden(h.to(dev), keep=k) for lay, dev, k in zip(layers, devs, keeps)]
        if self.row_parallel:
            y = _sum_on([lay.feed_forward.w_2(g) for lay, g in zip(layers, gs)], home, dt)
        else:
            y = layers[0].feed_forward.w_2(torch.cat([g.to(home) for g in gs], dim=-1))
        return x + dropout(y, p, generator)


class RingStack:
    """`lm`'s layers over the devices of an sp mesh, the time axis split
    into equal shards (shard i on `devices[i]`): a stand-in for
    `lm.transformer` in an inference forward, `stack(x)` with x and the
    output on the first device. Every layer is position-wise but attention,
    which is ring attention over the shards (`ops/ring_attention.py`), its
    T5 bias blocks built from layer 0's bucket table for each (query shard,
    key shard) offset and kept per sequence length. Devices other than the
    LM's get a copy of its layers; a repeated device shares them."""

    def __init__(self, lm: "VampNetLM", devices):
        import copy

        self.config = lm.config
        self.devices = [torch.device(d) for d in devices]
        home = lm.transformer.norm.weight.device
        self.replicas = {}
        for dev in self.devices:
            if dev not in self.replicas:
                self.replicas[dev] = lm.transformer if dev == home else \
                    copy.deepcopy(lm.transformer).to(dev)
        self._blocks: Dict[tuple, torch.Tensor] = {}

    def bias_block(self, i: int, src: int, tl: int) -> torch.Tensor:
        """The (h, tl, tl) T5 bias of query shard i against key shard src, in
        the table's dtype, on device i: it depends on src - i alone."""
        dev, cfg = self.devices[i], self.config
        key = (dev, src - i, tl)
        if key not in self._blocks:
            if any(k[2] != tl for k in self._blocks):
                self._blocks.clear()
            table = self.replicas[dev].layers_0.self_attn.relative_attention_bias
            pos = torch.arange(tl, device=dev)
            rel = (src - i) * tl + pos[None, :] - pos[:, None]
            buckets = relative_position_bucket(
                rel, bidirectional=True, num_buckets=cfg.attention_num_buckets,
                max_distance=cfg.attention_max_distance)
            self._blocks[key] = table[buckets].permute(2, 0, 1).contiguous()
        return self._blocks[key]

    def __call__(self, x: torch.Tensor, position_bias=None) -> torch.Tensor:
        from ..ops.ring_attention import ring_attention

        cfg, devs = self.config, self.devices
        n = len(devs)
        b, t, d = x.shape
        if t % n:
            raise ValueError(f"sequence length {t} does not split into {n} equal shards")
        tl = t // n
        xs = [x[:, i * tl:(i + 1) * tl].to(dev) for i, dev in enumerate(devs)]
        for li in range(cfg.n_layers):
            layers = [getattr(self.replicas[dev], f"layers_{li}") for dev in devs]
            qkv = [lay.self_attn.project(lay.norm_1(xi)) for lay, xi in zip(layers, xs)]
            outs = ring_attention([q for q, _, _ in qkv], [k for _, k, _ in qkv],
                                  [v for _, _, v in qkv],
                                  lambda i, src: self.bias_block(i, src, tl))
            xs = [lay.ffn_block(xi + lay.self_attn.fc(o.reshape(b, tl, d)))
                  for lay, xi, o in zip(layers, xs, outs)]
        home = devs[0]
        return torch.cat([self.replicas[dev].norm(xi).to(home) for dev, xi in zip(devs, xs)],
                         dim=1)


class CFGDropout(nn.Module):
    """Classifier-free-guidance dropout along the batch: a row is kept where
    its uniform draw is > p and zeroed elsewhere, with no 1 / (1 - p)
    rescale (unlike `F.dropout`). The identity without a generator or at
    p = 0."""

    def __init__(self, p: float = 0.2):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if generator is None or self.p == 0.0:
            return x
        u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator,
                       device=x.device)
        return x * (u > self.p).to(x.dtype)


class ControlEncoder(nn.Module):
    """One Dense per control (`ctrl_{name}`, dim -> d_model), each masked by
    its per-frame mask and put through `cfg_{name}` dropout at p, summed in
    `ctrl_dims` order, then `cfg_all` dropout at p / 2. Controls are
    (b, t, dim), masks (b, t)."""

    def __init__(self, ctrl_dims: Tuple[Tuple[str, int], ...], d_model: int,
                 cfg_dropout_prob: float = 0.2, compute_dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.ctrl_dims = tuple((str(k), int(v)) for k, v in ctrl_dims)
        self.compute_dtype = compute_dtype
        for name, dim in self.ctrl_dims:
            if "." in name or not name:
                raise ValueError(f"control name {name!r} cannot name a parameter")
            self.add_module(f"ctrl_{name}", Dense(dim, d_model, bias=True,
                                                  compute_dtype=compute_dtype, device=device))
            self.add_module(f"cfg_{name}", CFGDropout(cfg_dropout_prob))
        self.cfg_all = CFGDropout(cfg_dropout_prob / 2)

    def forward(self, embedding: torch.Tensor, ctrls: Dict[str, torch.Tensor],
                ctrl_masks: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        names = sorted(k for k, _ in self.ctrl_dims)
        if ctrls is None or sorted(ctrls) != names:
            raise ValueError(f"ctrls have keys {None if ctrls is None else sorted(ctrls)}, "
                             f"the control encoder {names}")
        if ctrl_masks is None or sorted(ctrl_masks) != names:
            raise ValueError(f"ctrl_masks have keys "
                             f"{None if ctrl_masks is None else sorted(ctrl_masks)}, "
                             f"the control encoder {names}")
        dt = self.compute_dtype
        out = torch.zeros_like(embedding)
        for name, _dim in self.ctrl_dims:
            emb = getattr(self, f"ctrl_{name}")(ctrls[name].to(dt))
            emb = emb * ctrl_masks[name][:, :, None].to(dt)
            out = out + getattr(self, f"cfg_{name}")(emb, generator)
        return self.cfg_all(out, generator)


class VampNetLM(nn.Module):
    """The full LM. Parameter names follow the flax tree, so `convert.py`
    maps one onto the other by path."""

    def __init__(self, config: LMConfig, device="cuda"):
        super().__init__()
        if str(device) != "meta":
            from ..util import resolve_device

            device = resolve_device(device)
        cfg = self.config = config
        self.embedding = CodebookEmbedding(
            cfg.latent_dim, cfg.n_codebooks, cfg.embedding_dim,
            compute_dtype=cfg.dtype, device=device,
        )
        self.transformer = TransformerStack(cfg, device=device)
        self.classifier = Dense(
            cfg.embedding_dim, cfg.vocab_size * cfg.n_predict_codebooks,
            bias=True, compute_dtype=cfg.dtype, device=device,
        )
        if cfg.ctrl_dims is not None:
            self.ctrl_encoder = ControlEncoder(cfg.ctrl_dims, cfg.embedding_dim,
                                               cfg.cfg_dropout_prob, cfg.dtype, device=device)

    @property
    def mask_token(self) -> int:
        return self.config.mask_token

    def forward(self, latents: torch.Tensor,
                position_bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                ctrls: Optional[Dict[str, torch.Tensor]] = None,
                ctrl_masks: Optional[Dict[str, torch.Tensor]] = None,
                stack=None) -> torch.Tensor:
        """latents (b, t, n_codebooks*latent_dim) -> fp32 logits
        (b, t, n_predict_codebooks, vocab). A `generator` turns dropout (and
        the controls' CFG dropout) on (training) and its draws come from it;
        without one the forward is deterministic. An LM with `ctrl_dims`
        takes `ctrls` and `ctrl_masks`, one entry per control. `stack` (a
        `TensorParallelStack`, which takes the generator, or a `RingStack`,
        inference only) runs the layers in place of `self.transformer`."""
        cfg = self.config
        if isinstance(stack, RingStack) and generator is not None:
            raise ValueError("a ring stack runs inference forwards only (no generator)")
        if position_bias is None and not isinstance(stack, RingStack):
            position_bias = position_bias_from_params(self, latents.shape[1])
        x = self.embedding(latents)
        if cfg.ctrl_dims is not None:
            x = x + self.ctrl_encoder(x, ctrls, ctrl_masks, generator)
        elif ctrls is not None:
            raise ValueError("controls given to an LM without ctrl_dims")
        if isinstance(stack, TensorParallelStack):
            out = stack(x, position_bias, generator)
        elif stack is not None:
            out = stack(x, position_bias)
        else:
            out = self.transformer(x, position_bias, generator)
        logits = self.classifier(out)  # (b, t, C*vocab), codebook-major
        b, t, _ = logits.shape
        return logits.reshape(b, t, cfg.n_predict_codebooks, cfg.vocab_size).float()

    def forward_codes(self, codes: torch.Tensor, codebooks: torch.Tensor,
                      position_bias: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      ctrls: Optional[Dict[str, torch.Tensor]] = None,
                      ctrl_masks: Optional[Dict[str, torch.Tensor]] = None,
                      stack=None) -> torch.Tensor:
        """codes (b, n_codebooks, t) -> logits in one call (the sampler's
        forward, and the training step's)."""
        return self(self.embedding.from_codes(codes, codebooks), position_bias, generator,
                    ctrls, ctrl_masks, stack)
