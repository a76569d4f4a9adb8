"""MAGNeT's text encoder and masked codec-token LM (Ziv et al., "Masked Audio
Generation using a Single Non-Autoregressive Transformer", arXiv:2401.04577;
audiocraft's `MagnetLMModel` and `T5Conditioner`). No JAX counterpart: the
JAX package serves VampNet alone.

`T5Encoder` is T5-base's encoder (12 pre-norm layers, d = 768, 12 heads of
64, ReLU FFN of 3,072, T5's RMS layer norm with eps 1e-6), one bidirectional
relative-position bias (32 buckets, max distance 128) computed once from
layer 0's table and shared by every layer, no 1/sqrt(d) score scale, padded
text positions masked as keys, then `output_proj` (768 -> the LM's width,
with bias) and the padded positions zeroed. The bias is VampNet's bucketing
(`relative_position_bucket`, `RelativePositionBias`). Its attention goes
through `dot_product_attention` with q times sqrt(d_kv) (a power of two,
exact in bf16) against the kernels' 1/sqrt(d_kv), so that no scale is
applied, and the key mask as its mask: the masked inference kernel (K3) on
the card.

`MagnetLM` (48 layers, d = 1,536, 24 heads of 64, no biases in attention,
FFN or output projections):
    x = sum_k emb_k(codes_k) + sin_pos         (cos | sin, max period 10,000)
    x += SelfAttn(LN_1(x), window)              (full at stage 0; |i - j| <= 5 after)
    x += CrossAttn(LN_c(x), c)                  (no key mask)
    x += W_2 GELU(W_1 LN_2(x))                  (W_1 1,536 -> 6,144, exact GELU)
    logits_k = W_k LN_out(x)                    (4 heads of 1,536 -> 2,048)
The codebooks lie in parallel (no delay pattern); row `card` of each
embedding is the mask id. `forward` returns the current stage's head only,
the only one the stage loop samples. The cross-attention's keys and values
of a text encoding depend on the text alone: `cross_kv` computes them once
per group of requests, and every step of the stage loop reuses them.

Both run their products in `compute_dtype` (bf16 on the card: weights
stored in it, each projection's input cast to it) and keep the residual
stream, the layer norms and the RMS norms in fp32, as the published models
run under bf16 autocast.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.relative_bias import RelativePositionBias
from .layers import Dense
from .transformer import RMSNorm, relative_position_bucket


@dataclasses.dataclass(frozen=True)
class T5Config:
    """T5-base's encoder."""

    vocab_size: int = 32128
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_kv: int = 64
    d_ff: int = 3072
    num_buckets: int = 32
    max_distance: int = 128
    eps: float = 1e-6
    out_dim: int = 1536  # output_proj: the LM's width
    compute_dtype: str = "bfloat16"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class MagnetConfig:
    """MAGNeT medium's LM (audiocraft's `magnet_32khz`, scale `medium`)."""

    dim: int = 1536
    n_layers: int = 48
    n_heads: int = 24
    ffn_dim: int = 6144
    n_q: int = 4
    card: int = 2048
    subcodes_context: int = 5  # the window of stages 1 to n_q - 1
    norm_eps: float = 1e-5
    max_period: float = 10000.0
    compute_dtype: str = "bfloat16"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def mask_id(self) -> int:
        return self.card

    def window(self, stage: int) -> Optional[int]:
        """The self-attention's window at `stage`: none at stage 0."""
        return None if stage == 0 else self.subcodes_context


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` in fp32, whatever its weights are stored in."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


class Attention(nn.Module):
    """Multi-head attention with no biases: q from x, k and v from x (self)
    or from a source (cross, `project_kv` once per source)."""

    def __init__(self, dim: int, n_heads: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.n_heads, self.d_head = n_heads, dim // n_heads
        self.w_q, self.w_k, self.w_v, self.out = (
            Dense(dim, dim, bias=False, compute_dtype=dtype, device=device) for _ in range(4))

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], x.shape[1], self.n_heads, self.d_head)

    def project_kv(self, src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.heads(self.w_k(src)), self.heads(self.w_v(src))

    def forward(self, x: torch.Tensor, kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                window: Optional[int] = None) -> torch.Tensor:
        k, v = self.project_kv(x) if kv is None else kv
        a = dot_product_attention(self.heads(self.w_q(x)), k, v, window=window)
        return self.out(a.reshape(x.shape[0], x.shape[1], -1))


class MagnetLayer(nn.Module):
    def __init__(self, cfg: MagnetConfig, device=None):
        super().__init__()
        d, dt = cfg.dim, cfg.dtype
        self.norm1 = LayerNorm(d, eps=cfg.norm_eps, device=device)
        self.self_attn = Attention(d, cfg.n_heads, dt, device=device)
        self.norm_cross = LayerNorm(d, eps=cfg.norm_eps, device=device)
        self.cross_attn = Attention(d, cfg.n_heads, dt, device=device)
        self.norm2 = LayerNorm(d, eps=cfg.norm_eps, device=device)
        self.linear1 = Dense(d, cfg.ffn_dim, bias=False, compute_dtype=dt, device=device)
        self.linear2 = Dense(cfg.ffn_dim, d, bias=False, compute_dtype=dt, device=device)

    def forward(self, x: torch.Tensor, kv: Tuple[torch.Tensor, torch.Tensor],
                window: Optional[int]) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x), window=window)
        x = x + self.cross_attn(self.norm_cross(x), kv=kv)
        return x + self.linear2(F.gelu(self.linear1(self.norm2(x))))


def sin_embedding(t: int, dim: int, max_period: float, device) -> torch.Tensor:
    """(t, dim) fp32: cos | sin of positions 0..t-1 at periods
    max_period ** (i / (dim / 2 - 1)), audiocraft's `create_sin_embedding`."""
    half = dim // 2
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    adim = torch.arange(half, dtype=torch.float32, device=device)[None, :]
    phase = pos / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


class MagnetLM(nn.Module):
    def __init__(self, cfg: MagnetConfig, device=None):
        super().__init__()
        self.config = cfg
        self.emb = nn.ModuleList([nn.Embedding(cfg.card + 1, cfg.dim, device=device)
                                  for _ in range(cfg.n_q)])
        self.layers = nn.ModuleList([MagnetLayer(cfg, device=device)
                                     for _ in range(cfg.n_layers)])
        self.out_norm = LayerNorm(cfg.dim, eps=cfg.norm_eps, device=device)
        self.linears = nn.ModuleList([Dense(cfg.dim, cfg.card, bias=False,
                                            compute_dtype=cfg.dtype, device=device)
                                      for _ in range(cfg.n_q)])
        self._pos = {}

    def cross_kv(self, c: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Every layer's cross-attention keys and values of the conditioning
        c (b, l, dim): computed once per group, used at every step."""
        c = c.to(self.config.dtype)
        return [layer.cross_attn.project_kv(c) for layer in self.layers]

    def positions(self, t: int, device) -> torch.Tensor:
        key = (t, str(device))
        if key not in self._pos:
            cfg = self.config
            self._pos[key] = sin_embedding(t, cfg.dim, cfg.max_period, device)
        return self._pos[key]

    def forward(self, codes: torch.Tensor, stage: int,
                kv: List[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
        """codes (b, n_q, t) in [0, card] -> the stage head's logits
        (b, t, card) fp32; `kv` from `cross_kv` over b rows of conditioning."""
        cfg = self.config
        x = self.emb[0](codes[:, 0]).float()
        for k in range(1, cfg.n_q):
            x = x + self.emb[k](codes[:, k]).float()
        x = x + self.positions(codes.shape[-1], codes.device)  # the fp32 residual stream
        window = cfg.window(stage)
        for layer, layer_kv in zip(self.layers, kv):
            x = layer(x, layer_kv, window)
        return self.linears[stage](self.out_norm(x)).float()


class T5Layer(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        d, inner, dt = cfg.d_model, cfg.n_heads * cfg.d_kv, cfg.dtype
        self.n_heads, self.d_kv = cfg.n_heads, cfg.d_kv
        self.norm1 = RMSNorm(d, eps=cfg.eps, device=device)
        self.q, self.k, self.v = (Dense(d, inner, bias=False, compute_dtype=dt, device=device)
                                  for _ in range(3))
        self.o = Dense(inner, d, bias=False, compute_dtype=dt, device=device)
        self.norm2 = RMSNorm(d, eps=cfg.eps, device=device)
        self.wi = Dense(d, cfg.d_ff, bias=False, compute_dtype=dt, device=device)
        self.wo = Dense(cfg.d_ff, d, bias=False, compute_dtype=dt, device=device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, key_mask: torch.Tensor):
        b, l, _ = x.shape
        h = self.norm1(x)
        shape = (b, l, self.n_heads, self.d_kv)
        # T5 scales no score: q * sqrt(d_kv) cancels the kernels' 1/sqrt(d_kv)
        q = self.q(h).reshape(shape) * float(math.sqrt(self.d_kv))
        a = dot_product_attention(q, self.k(h).reshape(shape), self.v(h).reshape(shape),
                                  bias=bias, mask=key_mask)
        x = x + self.o(a.reshape(b, l, -1))
        return x + self.wo(F.relu(self.wi(self.norm2(x))))


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.config = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.rel_bias = nn.Embedding(cfg.num_buckets, cfg.n_heads, device=device)
        self.layers = nn.ModuleList([T5Layer(cfg, device=device) for _ in range(cfg.n_layers)])
        self.final_norm = RMSNorm(cfg.d_model, eps=cfg.eps, device=device)
        self.output_proj = Dense(cfg.d_model, cfg.out_dim, bias=True, compute_dtype=cfg.dtype,
                                 device=device)

    def position_bias(self, l: int) -> torch.Tensor:
        """(heads, l, l) in the compute dtype: the bucket of j - i in layer
        0's table, as `RelativePositionBias` builds VampNet's."""
        cfg = self.config
        offsets = relative_position_bucket(
            torch.arange(-(l - 1), l, device=self.rel_bias.weight.device), bidirectional=True,
            num_buckets=cfg.num_buckets, max_distance=cfg.max_distance)
        return RelativePositionBias.apply(self.rel_bias.weight.to(cfg.dtype), offsets, l, l)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ids, mask (b, l) (mask 1 on text, 0 on padding) -> (b, l, out_dim)
        in the compute dtype, zero on the padding."""
        cfg = self.config
        b, l = ids.shape
        x = self.shared(ids).float()  # the fp32 residual stream
        bias = self.position_bias(l)
        key_mask = mask.bool()[:, None, :].expand(b, l, l)
        for layer in self.layers:
            x = layer(x, bias, key_mask)
        c = self.output_proj(self.final_norm(x))
        return c * mask[..., None].to(c.dtype)
