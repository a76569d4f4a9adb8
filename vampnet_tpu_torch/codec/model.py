"""LAC neural audio codec (counterpart of `vampnet_tpu/codec/model.py`), the
parts the serving path uses: `encode` to codes, `decode_codes` back to a
waveform, `ResidualVectorQuantize.from_codes` and `codebook_tables`.

Snake + weight-norm conv encoder (rates 2, 4, 8, 8 -> hop 512) and decoder,
and a residual vector quantizer whose nearest neighbour is the argmax of a
cosine similarity, taken in fp32. Public functions are channels-last:
audio (b, t, 1) in and out, as in the JAX package; inside, the layers run
channels-first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from .layers import Snake1d, WNConv1d, WNConvTranspose1d, no_tf32


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """The JAX `CodecConfig`'s fields and defaults. The port runs fp32 with
    the `conv_impl="xla"` semantics only: `LAC` refuses any other value of
    the three schedule fields (ROADMAP Queue A item 3)."""

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
    """Snake -> dilated conv(k7) -> Snake -> conv(k1), residual add."""

    def __init__(self, dim: int, dilation: int, device=None):
        super().__init__()
        self.snake_1 = Snake1d(dim, device=device)
        self.conv_1 = WNConv1d(dim, dim, 7, dilation=dilation,
                               padding=3 * dilation, device=device)
        self.snake_2 = Snake1d(dim, device=device)
        self.conv_2 = WNConv1d(dim, dim, 1, device=device)

    def forward(self, x):
        return x + self.conv_2(self.snake_2(self.conv_1(self.snake_1(x))))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int, device=None):
        super().__init__()
        self.res_1 = ResidualUnit(dim // 2, 1, device=device)
        self.res_2 = ResidualUnit(dim // 2, 3, device=device)
        self.res_3 = ResidualUnit(dim // 2, 9, device=device)
        self.snake = Snake1d(dim // 2, device=device)
        self.conv = WNConv1d(dim // 2, dim, 2 * stride, stride=stride,
                             padding=math.ceil(stride / 2), device=device)

    def forward(self, x):
        return self.conv(self.snake(self.res_3(self.res_2(self.res_1(x)))))


class Encoder(nn.Module):
    def __init__(self, cfg: CodecConfig, device=None):
        super().__init__()
        d = cfg.encoder_dim
        self.conv_in = WNConv1d(1, d, 7, padding=3, device=device)
        self.n_blocks = len(cfg.encoder_rates)
        for i, stride in enumerate(cfg.encoder_rates):
            d *= 2
            self.add_module(f"block_{i}", EncoderBlock(d, stride, device=device))
        self.snake_out = Snake1d(d, device=device)
        self.conv_out = WNConv1d(d, cfg.latent_dim, 3, padding=1, device=device)

    def forward(self, x):  # (b, 1, t) -> (b, latent_dim, t / hop)
        x = self.conv_in(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return self.conv_out(self.snake_out(x))


class DecoderBlock(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, stride: int, device=None):
        super().__init__()
        self.snake = Snake1d(input_dim, device=device)
        self.conv_t = WNConvTranspose1d(input_dim, output_dim, 2 * stride, stride=stride,
                                        padding=math.ceil(stride / 2), device=device)
        self.res_1 = ResidualUnit(output_dim, 1, device=device)
        self.res_2 = ResidualUnit(output_dim, 3, device=device)
        self.res_3 = ResidualUnit(output_dim, 9, device=device)

    def forward(self, x):
        return self.res_3(self.res_2(self.res_1(self.conv_t(self.snake(x)))))


class Decoder(nn.Module):
    def __init__(self, cfg: CodecConfig, device=None):
        super().__init__()
        d = cfg.decoder_dim
        self.conv_in = WNConv1d(cfg.latent_dim, d, 7, padding=3, device=device)
        self.n_blocks = len(cfg.decoder_rates)
        in_dim = d
        for i, stride in enumerate(cfg.decoder_rates):
            out_dim = d // (2 ** (i + 1))
            self.add_module(f"block_{i}", DecoderBlock(in_dim, out_dim, stride, device=device))
            in_dim = out_dim
        self.snake_out = Snake1d(in_dim, device=device)
        self.conv_out = WNConv1d(in_dim, 1, 7, padding=3, device=device)

    def forward(self, z):  # (b, latent_dim, t / hop) -> (b, 1, t)
        x = self.conv_in(z)
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return torch.tanh(self.conv_out(self.snake_out(x)))


class VectorQuantize(nn.Module):
    """One RVQ stage: in_proj -> cosine nearest neighbour -> out_proj."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int, device=None):
        super().__init__()
        self.in_proj = WNConv1d(input_dim, codebook_dim, 1, device=device)
        self.out_proj = WNConv1d(codebook_dim, input_dim, 1, device=device)
        self.codebook = nn.Parameter(torch.empty(codebook_size, codebook_dim, device=device))

    def forward(self, residual: torch.Tensor):
        """residual (b, latent, t) -> (projected z_q (b, latent, t), codes (b, t))."""
        z_e = self.in_proj(residual).transpose(1, 2)  # (b, t, codebook_dim)
        enc = z_e / (torch.linalg.vector_norm(z_e, dim=-1, keepdim=True) + 1e-8)
        cb = self.codebook / (
            torch.linalg.vector_norm(self.codebook, dim=-1, keepdim=True) + 1e-8)
        indices = torch.argmax(torch.matmul(enc, cb.T), dim=-1)
        z_q = self.codebook[indices]
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
        for i in range(cfg.n_codebooks):
            self.add_module(f"quantizers_{i}", VectorQuantize(
                cfg.latent_dim, cfg.codebook_size, cfg.codebook_dim, device=device))

    def quantizer(self, i: int) -> VectorQuantize:
        return getattr(self, f"quantizers_{i}")

    def forward(self, z: torch.Tensor):
        """z (b, latent, t) -> (z_q (b, latent, t), codes (b, n_codebooks, t))."""
        z_q = torch.zeros_like(z)
        residual = z
        codes = []
        for i in range(self.n_codebooks):
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
        options = (config.compute_dtype, config.conv_impl, config.decoder_compute_dtype)
        if options != ("float32", "xla", None):
            raise NotImplementedError(
                f"codec compute_dtype/conv_impl/decoder_compute_dtype {options}: the port "
                "runs ('float32', 'xla', None) only; ROADMAP Queue A item 3")
        self.config = config
        self.encoder = Encoder(config, device=device)
        self.quantizer = ResidualVectorQuantize(config, device=device)
        self.decoder = Decoder(config, device=device)

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (b, t, 1) fp32 -> codes (b, n_codebooks, t / hop) int64."""
        with no_tf32():
            z = self.encoder(audio.transpose(1, 2))
            return self.quantizer(z)[1]

    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (b, n_cb, t / hop) -> waveform (b, t, 1) fp32."""
        with no_tf32():
            return self.decoder(self.quantizer.from_codes(codes)).transpose(1, 2)

    def codebook_tables(self) -> torch.Tensor:
        return self.quantizer.codebook_tables()
