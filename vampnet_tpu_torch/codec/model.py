"""LAC neural audio codec (counterpart of `vampnet_tpu/codec/model.py`):
`encode` to codes (optionally the first `n_quantizers` only), `decode_codes`
and `decode_latents` back to a waveform, `ResidualVectorQuantize.from_codes`
and `from_latents`, and `codebook_tables`.

Snake + weight-norm conv encoder (rates 2, 4, 8, 8 -> hop 512) and decoder,
and a residual vector quantizer whose nearest neighbour is the argmax of a
cosine similarity, taken in fp32. Public functions are channels-last:
audio (b, t, 1) in and out, as in the JAX package; inside, the layers run
channels-first.

The compute options are the JAX package's: `compute_dtype` for every conv
("bfloat16" halves the codec's memory traffic), `decoder_compute_dtype` to
override it in the decoder alone (the encoder's dtype decides the codes), and
`conv_impl` ("xla": cuDNN's convolutions, "matmul": the matmul schedules of
`codec/layers.py`). The RVQ's projections and search stay fp32 under every
option; the encoder hands them fp32 and the decoder returns fp32.

The encoder and the decoder each have two routes to the same bits. For fp32
CUDA tensors that want no gradient (the frozen codec in training, every
serving encode and decode) they take the fused route: every conv before a
snake runs without its bias, and one kernel a snake (`ops/snake.py`) adds
the bias, and the residual where a residual unit ends, then applies the
snake; where the next residual unit needs its input it also writes that
sum. 29 launches an encode and 29 a decode, for about 270 eager ones. CPU
tensors, a call that needs a gradient and the bf16 and fp16 options take
the plain composition (`forward_plain`). The convolutions are the same
calls in both, on the same inputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from .layers import Snake1d, WNConv1d, WNConvTranspose1d, no_tf32


def _fused_route(module: nn.Module, x: torch.Tensor) -> bool:
    """The fused route for fp32 CUDA tensors when no gradient is wanted."""
    if not x.is_cuda or module.conv_in.dtype != torch.float32:
        return False
    return not (torch.is_grad_enabled()
                and (x.requires_grad or any(p.requires_grad for p in module.parameters())))


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """The JAX `CodecConfig`'s fields and defaults. `compute_dtype`,
    `decoder_compute_dtype` (None follows `compute_dtype`) and `conv_impl`
    change the schedule, never the weights."""

    sample_rate: int = 44100
    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 8, 8)
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    n_codebooks: int = 14
    codebook_size: int = 1024
    codebook_dim: int = 8
    compute_dtype: str = "float32"
    conv_impl: str = "xla"
    decoder_compute_dtype: Optional[str] = None

    @property
    def hop_length(self) -> int:
        return math.prod(self.encoder_rates)

    @property
    def latent_dim(self) -> int:
        return self.encoder_dim * (2 ** len(self.encoder_rates))


class ResidualUnit(nn.Module):
    """Snake -> dilated conv(k7) -> Snake -> conv(k1), residual add. `opts`
    are the convs' `dtype` and `impl`."""

    def __init__(self, dim: int, dilation: int, device=None, **opts):
        super().__init__()
        self.snake_1 = Snake1d(dim, device=device)
        self.conv_1 = WNConv1d(dim, dim, 7, dilation=dilation,
                               padding=3 * dilation, device=device, **opts)
        self.snake_2 = Snake1d(dim, device=device)
        self.conv_2 = WNConv1d(dim, dim, 1, device=device, **opts)

    def forward(self, x):
        return x + self.conv_2(self.snake_2(self.conv_1(self.snake_1(x))))

    def forward_fused(self, pre):
        """The fused route: `pre` is the unit's pending input (`Snake1d.fused`),
        the result its pending output, whose residual is the unit's input."""
        x, s = self.snake_1.fused(pre, keep_sum=True)
        s = self.conv_1.forward_nobias(s)
        s = self.snake_2.fused([s, self.conv_1.bias, None])
        return [self.conv_2.forward_nobias(s), self.conv_2.bias, x]


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int, device=None, **opts):
        super().__init__()
        self.res_1 = ResidualUnit(dim // 2, 1, device=device, **opts)
        self.res_2 = ResidualUnit(dim // 2, 3, device=device, **opts)
        self.res_3 = ResidualUnit(dim // 2, 9, device=device, **opts)
        self.snake = Snake1d(dim // 2, device=device)
        self.conv = WNConv1d(dim // 2, dim, 2 * stride, stride=stride,
                             padding=math.ceil(stride / 2), device=device, **opts)

    def forward(self, x):
        return self.conv(self.snake(self.res_3(self.res_2(self.res_1(x)))))

    def forward_fused(self, pre):
        for unit in (self.res_1, self.res_2, self.res_3):
            pre = unit.forward_fused(pre)
        return [self.conv.forward_nobias(self.snake.fused(pre)), self.conv.bias, None]


class Encoder(nn.Module):
    def __init__(self, cfg: CodecConfig, device=None):
        super().__init__()
        opts = dict(dtype=getattr(torch, cfg.compute_dtype), impl=cfg.conv_impl)
        d = cfg.encoder_dim
        self.conv_in = WNConv1d(1, d, 7, padding=3, device=device, **opts)
        self.n_blocks = len(cfg.encoder_rates)
        for i, stride in enumerate(cfg.encoder_rates):
            d *= 2
            self.add_module(f"block_{i}", EncoderBlock(d, stride, device=device, **opts))
        self.snake_out = Snake1d(d, device=device)
        self.conv_out = WNConv1d(d, cfg.latent_dim, 3, padding=1, device=device, **opts)

    def forward(self, x):  # (b, 1, t) -> (b, latent_dim, t / hop) fp32
        if _fused_route(self, x):
            return self.forward_fused(x)
        return self.forward_plain(x)

    def forward_plain(self, x):
        x = self.conv_in(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return self.conv_out(self.snake_out(x)).float()

    def forward_fused(self, x):
        pre = [self.conv_in.forward_nobias(x), self.conv_in.bias, None]
        for i in range(self.n_blocks):
            pre = getattr(self, f"block_{i}").forward_fused(pre)
        return self.conv_out(self.snake_out.fused(pre)).float()


class DecoderBlock(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, stride: int, device=None, **opts):
        super().__init__()
        self.snake = Snake1d(input_dim, device=device)
        self.conv_t = WNConvTranspose1d(input_dim, output_dim, 2 * stride, stride=stride,
                                        padding=math.ceil(stride / 2), device=device, **opts)
        self.res_1 = ResidualUnit(output_dim, 1, device=device, **opts)
        self.res_2 = ResidualUnit(output_dim, 3, device=device, **opts)
        self.res_3 = ResidualUnit(output_dim, 9, device=device, **opts)

    def forward(self, x):
        return self.res_3(self.res_2(self.res_1(self.conv_t(self.snake(x)))))

    def forward_fused(self, pre):
        pre = [self.conv_t.forward_nobias(self.snake.fused(pre)), self.conv_t.bias, None]
        for unit in (self.res_1, self.res_2, self.res_3):
            pre = unit.forward_fused(pre)
        return pre


class Decoder(nn.Module):
    def __init__(self, cfg: CodecConfig, device=None):
        super().__init__()
        dtype = cfg.decoder_compute_dtype or cfg.compute_dtype
        opts = dict(dtype=getattr(torch, dtype), impl=cfg.conv_impl)
        d = cfg.decoder_dim
        self.conv_in = WNConv1d(cfg.latent_dim, d, 7, padding=3, device=device, **opts)
        self.n_blocks = len(cfg.decoder_rates)
        in_dim = d
        for i, stride in enumerate(cfg.decoder_rates):
            out_dim = d // (2 ** (i + 1))
            self.add_module(f"block_{i}", DecoderBlock(in_dim, out_dim, stride, device=device,
                                                       **opts))
            in_dim = out_dim
        self.snake_out = Snake1d(in_dim, device=device)
        self.conv_out = WNConv1d(in_dim, 1, 7, padding=3, device=device, **opts)

    def forward(self, z):  # (b, latent_dim, t / hop) -> (b, 1, t) fp32
        if _fused_route(self, z):
            return self.forward_fused(z)
        return self.forward_plain(z)

    def forward_plain(self, z):
        x = self.conv_in(z)
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return torch.tanh(self.conv_out(self.snake_out(x)).float())

    def forward_fused(self, z):
        pre = [self.conv_in.forward_nobias(z), self.conv_in.bias, None]
        for i in range(self.n_blocks):
            pre = getattr(self, f"block_{i}").forward_fused(pre)
        return torch.tanh(self.conv_out(self.snake_out.fused(pre)).float())


class VectorQuantize(nn.Module):
    """One RVQ stage: in_proj -> cosine nearest neighbour -> out_proj."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int, device=None):
        super().__init__()
        self.in_proj = WNConv1d(input_dim, codebook_dim, 1, device=device)
        self.out_proj = WNConv1d(codebook_dim, input_dim, 1, device=device)
        self.codebook = nn.Parameter(torch.empty(codebook_size, codebook_dim, device=device))

    def decode_latents(self, z_e: torch.Tensor):
        """z_e (b, t, codebook_dim) -> (nearest codebook entries (b, t,
        codebook_dim), their indices (b, t)): the argmax of the cosine
        similarity, one fp32 product per stage."""
        enc = z_e / (torch.linalg.vector_norm(z_e, dim=-1, keepdim=True) + 1e-8)
        cb = self.codebook / (
            torch.linalg.vector_norm(self.codebook, dim=-1, keepdim=True) + 1e-8)
        indices = torch.argmax(torch.matmul(enc, cb.T), dim=-1)
        return self.codebook[indices], indices

    def forward(self, residual: torch.Tensor):
        """residual (b, latent, t) -> (projected z_q (b, latent, t), codes (b, t))."""
        z_e = self.in_proj(residual).transpose(1, 2)  # (b, t, codebook_dim)
        z_q, indices = self.decode_latents(z_e)
        # the straight-through form of the JAX package, kept for its rounding
        z_q = z_e + (z_q - z_e)
        return self.out_proj(z_q.transpose(1, 2)), indices

    def decode_code_proj(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (b, t) -> out_proj(codebook[codes]) (b, latent, t)."""
        return self.out_proj(self.codebook[codes].transpose(1, 2))


class ResidualVectorQuantize(nn.Module):
    def __init__(self, cfg: CodecConfig, device=None):
        super().__init__()
        self.n_codebooks = cfg.n_codebooks
        self.codebook_dim = cfg.codebook_dim
        for i in range(cfg.n_codebooks):
            self.add_module(f"quantizers_{i}", VectorQuantize(
                cfg.latent_dim, cfg.codebook_size, cfg.codebook_dim, device=device))

    def quantizer(self, i: int) -> VectorQuantize:
        return getattr(self, f"quantizers_{i}")

    def forward(self, z: torch.Tensor, n_quantizers: Optional[int] = None):
        """z (b, latent, t) -> (z_q (b, latent, t), codes (b, n_q, t)), n_q the
        first `n_quantizers` stages (all by default)."""
        z_q = torch.zeros_like(z)
        residual = z
        codes = []
        for i in range(self.n_codebooks if n_quantizers is None else n_quantizers):
            z_q_i, idx = self.quantizer(i)(residual)
            z_q = z_q + z_q_i
            residual = residual - z_q_i
            codes.append(idx)
        return z_q, torch.stack(codes, dim=1)

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (b, n_cb, t) -> summed projected z_q (b, latent, t)."""
        z_q = None
        for i in range(codes.shape[1]):
            z_q_i = self.quantizer(i).decode_code_proj(codes[:, i])
            z_q = z_q_i if z_q is None else z_q + z_q_i
        return z_q

    def from_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Concatenated per-stage latents (b, t, n_cb * codebook_dim),
        channels-last as the JAX package takes them -> summed out_proj
        outputs (b, latent, t)."""
        d = self.codebook_dim
        z_q = None
        for i in range(latents.shape[-1] // d):
            z_q_i = self.quantizer(i).out_proj(latents[..., i * d:(i + 1) * d].transpose(1, 2))
            z_q = z_q_i if z_q is None else z_q + z_q_i
        return z_q

    def codebook_tables(self) -> torch.Tensor:
        """(n_codebooks, codebook_size, codebook_dim), the LM's embedding
        tables."""
        return torch.stack([self.quantizer(i).codebook for i in range(self.n_codebooks)])


class LAC(nn.Module):
    """The codec. Channels-last audio: (b, t, 1) in, (b, t, 1) out."""

    def __init__(self, config: CodecConfig = CodecConfig(), device="cuda"):
        super().__init__()
        if str(device) != "meta":
            from ..util import resolve_device

            device = resolve_device(device)
        for dtype in (config.compute_dtype, config.decoder_compute_dtype):
            if dtype not in (None, "float32", "bfloat16", "float16"):
                raise ValueError(f"codec compute dtype must be float32, bfloat16 or float16, "
                                 f"got {dtype!r}")
        self.config = config
        self.encoder = Encoder(config, device=device)
        self.quantizer = ResidualVectorQuantize(config, device=device)
        self.decoder = Decoder(config, device=device)

    def encode(self, audio: torch.Tensor, n_quantizers: Optional[int] = None) -> torch.Tensor:
        """audio (b, t, 1) fp32 -> codes (b, n_q, t / hop) int64, n_q the
        first `n_quantizers` codebooks (all by default)."""
        with no_tf32():
            z = self.encoder(audio.transpose(1, 2))
            return self.quantizer(z, n_quantizers)[1]

    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (b, n_cb, t / hop) -> waveform (b, t, 1) fp32."""
        with no_tf32():
            return self.decoder(self.quantizer.from_codes(codes)).transpose(1, 2)

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Concatenated per-stage latents (b, t / hop, n_cb * codebook_dim) ->
        waveform (b, t, 1) fp32 (upstream's decode path: the quantizer's
        `from_latents`, then the decoder)."""
        with no_tf32():
            return self.decoder(self.quantizer.from_latents(latents)).transpose(1, 2)

    def codebook_tables(self) -> torch.Tensor:
        return self.quantizer.codebook_tables()
