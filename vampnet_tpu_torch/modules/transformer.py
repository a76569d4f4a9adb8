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
"pallas", "xla" (the library call) or "ring" (not ported). `TransformerStack`
takes an attention mask `x_mask` (b, t, t) or (b, 1, t, t), 0 = blocked, as
the JAX stack does; `VampNetLM` passes none, as in JAX. LoRA adapters
(`lora_r > 0`) sit on w_qs, w_vs, fc, w_1 and w_2 (`modules/lora.py`). With
`ctrl_dims` the LM takes sketch2sound controls: a `ControlEncoder` (one
Dense per control, masked per frame, classifier-free-guidance dropout while
training) adds them to the embedding before the stack. Not ported yet: ring
attention and remat.
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
    remat: bool = False  # recompute each layer in the backward; not ported (item 5)
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
    cfg = model.config
    t_k = t_q if t_k is None else t_k
    table = model.transformer.layers_0.self_attn.relative_attention_bias
    dev = table.device
    rel = (torch.arange(t_k, device=dev)[None, :]
           - torch.arange(t_q, device=dev)[:, None])
    buckets = relative_position_bucket(
        rel, bidirectional=True, num_buckets=cfg.attention_num_buckets,
        max_distance=cfg.attention_max_distance,
    )
    return table[buckets].permute(2, 0, 1).contiguous()


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax `nn.Dropout` semantics: keep each element with probability 1 - p
    and scale the kept ones by 1 / (1 - p), in x's dtype. The draws come from
    `generator` (on x's device); with no generator, or p = 0, it is the
    identity (the deterministic path)."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
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


class MultiHeadRelativeAttention(nn.Module):
    """Self-attention over (b, t, d) with a head-shared additive bias."""

    def __init__(self, d_model: int, n_head: int, has_relative_attention_bias: bool,
                 cfg: LMConfig, device=None):
        super().__init__()
        if cfg.attention_impl not in IMPLS:
            raise ValueError(f"attention_impl must be one of {IMPLS}, got {cfg.attention_impl!r}")
        self.n_head = n_head
        self.attention_impl = cfg.attention_impl
        dense = lambda r: LoRADense(d_model, d_model, r=r, compute_dtype=cfg.dtype,
                                    quantize=cfg.quantization == "int8", device=device)
        # the key projection never takes adapters, as in the JAX package
        self.w_qs, self.w_ks = dense(cfg.lora_r), dense(0)
        self.w_vs, self.fc = dense(cfg.lora_r), dense(cfg.lora_r)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Parameter(
                torch.empty(cfg.attention_num_buckets, n_head, device=device)
            )

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        shape = (b, t, self.n_head, d // self.n_head)
        q = self.w_qs(x).reshape(shape)
        k = self.w_ks(x).reshape(shape)
        v = self.w_vs(x).reshape(shape)
        out = dot_product_attention(q, k, v, bias=position_bias, mask=mask,
                                    impl=self.attention_impl)
        return self.fc(out.reshape(b, t, d))


class FeedForward(nn.Module):
    """GEGLU feed-forward: w_1 to 4d, gate one half by the GELU of the
    other, w_2 from 2d back to d."""

    def __init__(self, d_model: int, cfg: LMConfig, device=None):
        super().__init__()
        self.p = cfg.dropout
        quantize = cfg.quantization == "int8"
        self.w_1 = LoRADense(d_model, 4 * d_model, r=cfg.lora_r,
                             compute_dtype=cfg.dtype, quantize=quantize, device=device)
        self.w_2 = LoRADense(2 * d_model, d_model, r=cfg.lora_r,
                             compute_dtype=cfg.dtype, quantize=quantize, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p1, p2 = self.w_1(x).chunk(2, dim=-1)
        return self.w_2(dropout(p1 * new_gelu(p2), self.p, generator))


class TransformerLayer(nn.Module):
    """Pre-norm block: RMSNorm -> self-attention -> residual,
    RMSNorm -> FFN -> residual. With `ffn_impl="fused"` the second half is
    one call of `fused_geglu_ffn` on the pre-norm x, fed `norm_3.weight` and
    the FFN's weights; the state dict is the unfused path's."""

    def __init__(self, cfg: LMConfig, has_relative_attention_bias: bool, device=None):
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
            d, cfg.n_heads, has_relative_attention_bias, cfg, device=device)
        self.norm_3 = RMSNorm(d, device=device)
        self.feed_forward = FeedForward(d, cfg, device=device)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + dropout(self.self_attn(self.norm_1(x), position_bias, x_mask), self.p, generator)
        if self.fused_ffn:
            if generator is not None:
                raise ValueError("ffn_impl='fused' needs no dropout generator, lora_r=0, no int8")
            ff = self.feed_forward
            return fused_geglu_ffn(x.to(ff.w_1.compute_dtype), self.norm_3.weight,
                                   ff.w_1.weight, ff.w_2.weight, self.norm_3.eps)
        y = self.feed_forward(self.norm_3(x), generator)
        return x + dropout(y, self.p, generator)


class TransformerStack(nn.Module):
    """n_layers layers (`layers_0` holds the bucket table) and a final norm.
    `x_mask` (b, t, t) or (b, 1, t, t), 0 = blocked, reaches every layer's
    attention; it is turned into the kernels' bool (b, t, t) once here."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        self.n_layers = cfg.n_layers
        for i in range(cfg.n_layers):
            self.add_module(f"layers_{i}", TransformerLayer(cfg, i == 0, device=device))
        self.norm = RMSNorm(cfg.embedding_dim, device=device)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x_mask is not None:
            x_mask = attention_mask(x_mask, x)
        for i in range(self.n_layers):
            x = getattr(self, f"layers_{i}")(x, position_bias, generator, x_mask)
        return self.norm(x)


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
                ctrl_masks: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """latents (b, t, n_codebooks*latent_dim) -> fp32 logits
        (b, t, n_predict_codebooks, vocab). A `generator` turns dropout (and
        the controls' CFG dropout) on (training) and its draws come from it;
        without one the forward is deterministic. An LM with `ctrl_dims`
        takes `ctrls` and `ctrl_masks`, one entry per control."""
        cfg = self.config
        if position_bias is None:
            position_bias = position_bias_from_params(self, latents.shape[1])
        x = self.embedding(latents)
        if cfg.ctrl_dims is not None:
            x = x + self.ctrl_encoder(x, ctrls, ctrl_masks, generator)
        elif ctrls is not None:
            raise ValueError("controls given to an LM without ctrl_dims")
        out = self.transformer(x, position_bias, generator)
        logits = self.classifier(out)  # (b, t, C*vocab), codebook-major
        b, t, _ = logits.shape
        return logits.reshape(b, t, cfg.n_predict_codebooks, cfg.vocab_size).float()

    def forward_codes(self, codes: torch.Tensor, codebooks: torch.Tensor,
                      position_bias: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      ctrls: Optional[Dict[str, torch.Tensor]] = None,
                      ctrl_masks: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """codes (b, n_codebooks, t) -> logits in one call (the sampler's
        forward, and the training step's)."""
        return self(self.embedding.from_codes(codes, codebooks), position_bias, generator,
                    ctrls, ctrl_masks)
