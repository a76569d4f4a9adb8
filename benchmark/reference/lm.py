"""The VampNet masked-token LM in plain fp32 PyTorch.

A bidirectional pre-norm T5-style stack over codec-token embeddings
(upstream vampnet `vampnet/modules/transformer.py`): the tokens' codec
latents (the codec's codebook rows, a learned MASK latent per codebook)
projected to the width; per layer RMSNorm -> self-attention with the
head-shared T5 relative-position bias (the bucket table on layer 0) ->
residual, RMSNorm -> GEGLU feed-forward (tanh GELU) -> residual; a final
RMSNorm and the classifier, whose columns are codebook-major.

Every product runs in fp32 with TF32 off (`fp32_mode`). Dropout, where a
generator is given, sits where the port puts it (the attention output, the
GEGLU hidden units and the feed-forward output, drawn in that order in each
layer, `torch.rand` of the activation's shape, kept below 1 - p) so that
a generator seeded alike draws the same masks.

Departures from upstream, as the port has them: attention scales the scores
by 1/sqrt(d_head) (upstream's T5 layer does too), dropout on the attention
output, and no LoRA adapters (rank 0).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LMConfig:
    n_heads: int
    n_layers: int
    n_codebooks: int
    n_conditioning_codebooks: int
    latent_dim: int
    embedding_dim: int
    vocab_size: int
    dropout: float = 0.1
    attention_num_buckets: int = 32
    attention_max_distance: int = 128

    @property
    def n_predict(self) -> int:
        return self.n_codebooks - self.n_conditioning_codebooks

    @property
    def mask_token(self) -> int:
        return self.vocab_size


def config_from(d: dict) -> LMConfig:
    names = {f.name for f in dataclasses.fields(LMConfig)}
    return LMConfig(**{k: v for k, v in d.items() if k in names})


def fp32_mode() -> None:
    """Full fp32 products: TF32 off in cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def param_shapes(cfg: LMConfig) -> Dict[str, tuple]:
    """Every tensor's name and shape, in the port's names."""
    d, c = cfg.embedding_dim, cfg.n_codebooks
    out = {
        "embedding.special_MASK": (c, cfg.latent_dim),
        "embedding.out_proj.weight": (d, c * cfg.latent_dim),
        "embedding.out_proj.bias": (d,),
    }
    for i in range(cfg.n_layers):
        p = f"transformer.layers_{i}."
        out[p + "norm_1.weight"] = (d,)
        if i == 0:
            out[p + "self_attn.relative_attention_bias"] = (cfg.attention_num_buckets,
                                                            cfg.n_heads)
        for w in ("w_qs", "w_ks", "w_vs", "fc"):
            out[p + f"self_attn.{w}.weight"] = (d, d)
        out[p + "norm_3.weight"] = (d,)
        out[p + "feed_forward.w_1.weight"] = (4 * d, d)
        out[p + "feed_forward.w_2.weight"] = (d, 2 * d)
    out["transformer.norm.weight"] = (d,)
    out["classifier.weight"] = (cfg.vocab_size * cfg.n_predict, d)
    out["classifier.bias"] = (cfg.vocab_size * cfg.n_predict,)
    return out


def relative_position_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int):
    """T5's bidirectional bucketing: half the buckets for each sign, half of
    those exact, the rest log-spaced up to max_distance (the log in fp32,
    truncated)."""
    num_buckets //= 2
    ret = (rel > 0).to(rel.dtype) * num_buckets
    n = torch.abs(rel)
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(torch.clamp(n, min=1).to(torch.float32) / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(rel.dtype)
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


def position_bias(table: torch.Tensor, cfg: LMConfig, t: int) -> torch.Tensor:
    """(heads, t, t) fp32 bias from the bucket table (buckets, heads)."""
    pos = torch.arange(t, device=table.device)
    buckets = relative_position_bucket(pos[None, :] - pos[:, None], cfg.attention_num_buckets,
                                       cfg.attention_max_distance)
    return table.float()[buckets].permute(2, 0, 1)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return w * x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _dropout(x, p: float, gen: Optional[torch.Generator]):
    if gen is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), device=x.device))


def embed(params: Dict[str, torch.Tensor], codes: torch.Tensor,
          codebooks: torch.Tensor) -> torch.Tensor:
    """codes (b, C, t) in [0, vocab] -> (b, t, C * latent): each codebook's
    codec latent, the MASK latent for the mask token."""
    c = codes.shape[1]
    table = torch.cat([codebooks[:c].float(),
                       params["embedding.special_MASK"][:c, None, :].float()], dim=1)
    lat = table[torch.arange(c, device=codes.device)[None, :, None], codes]  # (b, C, t, L)
    b, _, t, ld = lat.shape
    return lat.transpose(1, 2).reshape(b, t, c * ld)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale per tensor (its absmax to 448),
    as fp32; the gradient passes straight through. The precision below
    bf16 for the controls."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


def forward(params: Dict[str, torch.Tensor], cfg: LMConfig, codes: torch.Tensor,
            codebooks: torch.Tensor, generator: Optional[torch.Generator] = None,
            operand: Optional[Callable] = None):
    """codes (b, C, t) -> fp32 logits (b, t, n_predict, vocab). `operand`,
    where given, rounds both operands of every product (`fp8`)."""
    P = params
    o = operand if operand is not None else (lambda x: x)

    def linear(x, w, bias=None):
        return F.linear(o(x), o(w), bias)

    x = embed(P, codes, codebooks)
    x = linear(x, P["embedding.out_proj.weight"], P["embedding.out_proj.bias"])
    b, t, d = x.shape
    h = cfg.n_heads
    dh = d // h
    bias = position_bias(P["transformer.layers_0.self_attn.relative_attention_bias"], cfg, t)
    p = cfg.dropout
    for i in range(cfg.n_layers):
        pre = f"transformer.layers_{i}."
        y = rms_norm(x, P[pre + "norm_1.weight"])
        q, k, v = (linear(y, P[pre + f"self_attn.{w}.weight"]).reshape(b, t, h, dh)
                   .transpose(1, 2) for w in ("w_qs", "w_ks", "w_vs"))
        scores = torch.matmul(o(q), o(k).transpose(-1, -2)) / math.sqrt(dh) + bias[None]
        a = torch.matmul(o(torch.softmax(scores, dim=-1)), o(v))
        a = a.transpose(1, 2).reshape(b, t, d)
        x = x + _dropout(linear(a, P[pre + "self_attn.fc.weight"]), p, generator)
        y = rms_norm(x, P[pre + "norm_3.weight"])
        p1, p2 = linear(y, P[pre + "feed_forward.w_1.weight"]).chunk(2, dim=-1)
        g = _dropout(p1 * gelu_tanh(p2), p, generator)
        x = x + _dropout(linear(g, P[pre + "feed_forward.w_2.weight"]), p, generator)
    x = rms_norm(x, P["transformer.norm.weight"])
    logits = linear(x, P["classifier.weight"], P["classifier.bias"])
    return logits.reshape(b, t, cfg.n_predict, cfg.vocab_size)
