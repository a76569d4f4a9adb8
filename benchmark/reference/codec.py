"""The LAC codec (descript-audio-codec's DAC layout, as VampNet uses it) in
plain fp32 PyTorch, channels-first.

Encoder: conv(k7) -> per stride s a block of three residual units (snake,
dilated conv k7 at dilations 1, 3, 9, snake, conv k1, residual add), snake
and a strided conv (k 2s) -> snake -> conv(k3). Residual vector quantizer:
per stage an in-projection (k1), the nearest codebook row by cosine
similarity, an out-projection (k1), the residual carried on. Decoder:
conv(k7) -> per stride a block of snake, a transposed conv (k 2s) and three
residual units -> snake -> conv(k7) -> tanh. Every conv is weight-normed,
w = g v / ||v|| (the norm over all but the first axis). Snake is
x + sin^2(alpha x) / alpha.

Departures from upstream, as the port has them: +1e-12 under the weight
norm and +1e-9 under alpha, +1e-8 under the cosine norms; the quantizer's
straight-through form z_e + (z_q - z_e) kept for its rounding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    sample_rate: int = 44100
    encoder_dim: int = 64
    encoder_rates: tuple = (2, 4, 8, 8)
    decoder_dim: int = 1536
    decoder_rates: tuple = (8, 8, 4, 2)
    n_codebooks: int = 14
    codebook_size: int = 1024
    codebook_dim: int = 8

    @property
    def hop_length(self) -> int:
        return math.prod(self.encoder_rates)

    @property
    def latent_dim(self) -> int:
        return self.encoder_dim * 2 ** len(self.encoder_rates)


def config_from(d: dict) -> CodecConfig:
    names = {f.name for f in dataclasses.fields(CodecConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items() if k in names}
    return CodecConfig(**kw)


def _conv(out: dict, name: str, c_in: int, c_out: int, k: int, transposed: bool = False):
    out[name + ".v"] = (c_in, c_out, k) if transposed else (c_out, c_in, k)
    out[name + ".g"] = (c_in if transposed else c_out,)
    out[name + ".bias"] = (c_out,)


def _res(out: dict, name: str, dim: int):
    out[name + ".snake_1.alpha"] = (dim,)
    _conv(out, name + ".conv_1", dim, dim, 7)
    out[name + ".snake_2.alpha"] = (dim,)
    _conv(out, name + ".conv_2", dim, dim, 1)


def param_shapes(cfg: CodecConfig) -> Dict[str, tuple]:
    """Every tensor's name and shape, in the port's names."""
    out: Dict[str, tuple] = {}
    d = cfg.encoder_dim
    _conv(out, "encoder.conv_in", 1, d, 7)
    for i, s in enumerate(cfg.encoder_rates):
        d *= 2
        for j in (1, 2, 3):
            _res(out, f"encoder.block_{i}.res_{j}", d // 2)
        out[f"encoder.block_{i}.snake.alpha"] = (d // 2,)
        _conv(out, f"encoder.block_{i}.conv", d // 2, d, 2 * s)
    out["encoder.snake_out.alpha"] = (d,)
    _conv(out, "encoder.conv_out", d, cfg.latent_dim, 3)
    for i in range(cfg.n_codebooks):
        q = f"quantizer.quantizers_{i}"
        _conv(out, q + ".in_proj", cfg.latent_dim, cfg.codebook_dim, 1)
        _conv(out, q + ".out_proj", cfg.codebook_dim, cfg.latent_dim, 1)
        out[q + ".codebook"] = (cfg.codebook_size, cfg.codebook_dim)
    _conv(out, "decoder.conv_in", cfg.latent_dim, cfg.decoder_dim, 7)
    c_in = cfg.decoder_dim
    for i, s in enumerate(cfg.decoder_rates):
        c_out = cfg.decoder_dim // 2 ** (i + 1)
        out[f"decoder.block_{i}.snake.alpha"] = (c_in,)
        _conv(out, f"decoder.block_{i}.conv_t", c_in, c_out, 2 * s, transposed=True)
        for j in (1, 2, 3):
            _res(out, f"decoder.block_{i}.res_{j}", c_out)
        c_in = c_out
    out["decoder.snake_out.alpha"] = (c_in,)
    _conv(out, "decoder.conv_out", c_in, 1, 7)
    return out


def _w(P, name):
    v, g = P[name + ".v"], P[name + ".g"]
    norm = torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=1)
    return (g / (norm + 1e-12))[:, None, None] * v


def conv(P, name, x, stride=1, padding=0, dilation=1):
    return F.conv1d(x, _w(P, name), P[name + ".bias"], stride=stride, padding=padding,
                    dilation=dilation)


def conv_t(P, name, x, stride, padding):
    return F.conv_transpose1d(x, _w(P, name), P[name + ".bias"], stride=stride, padding=padding)


def snake(x, alpha):
    alpha = alpha[None, :, None]
    return x + (1.0 / (alpha + 1e-9)) * torch.square(torch.sin(alpha * x))


def _res_unit(P, name, x, dilation):
    y = conv(P, name + ".conv_1", snake(x, P[name + ".snake_1.alpha"]), padding=3 * dilation,
             dilation=dilation)
    return x + conv(P, name + ".conv_2", snake(y, P[name + ".snake_2.alpha"]))


def encode(P, cfg: CodecConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio (b, 1, t) fp32, t a whole number of hops -> codes (b, n_cb, t / hop)."""
    x = conv(P, "encoder.conv_in", audio, padding=3)
    for i, s in enumerate(cfg.encoder_rates):
        for j, dil in zip((1, 2, 3), (1, 3, 9)):
            x = _res_unit(P, f"encoder.block_{i}.res_{j}", x, dil)
        x = conv(P, f"encoder.block_{i}.conv", snake(x, P[f"encoder.block_{i}.snake.alpha"]),
                 stride=s, padding=math.ceil(s / 2))
    z = conv(P, "encoder.conv_out", snake(x, P["encoder.snake_out.alpha"]), padding=1)
    residual, codes = z, []
    for i in range(cfg.n_codebooks):
        q = f"quantizer.quantizers_{i}"
        z_e = conv(P, q + ".in_proj", residual).transpose(1, 2)  # (b, t, cb_dim)
        cb = P[q + ".codebook"]
        enc = z_e / (torch.linalg.vector_norm(z_e, dim=-1, keepdim=True) + 1e-8)
        cbn = cb / (torch.linalg.vector_norm(cb, dim=-1, keepdim=True) + 1e-8)
        idx = torch.argmax(torch.matmul(enc, cbn.T), dim=-1)
        z_q = z_e + (cb[idx] - z_e)
        residual = residual - conv(P, q + ".out_proj", z_q.transpose(1, 2))
        codes.append(idx)
    return torch.stack(codes, dim=1)


def decode(P, cfg: CodecConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes (b, n_cb, frames) -> audio (b, 1, frames * hop) fp32."""
    z = None
    for i in range(codes.shape[1]):
        q = f"quantizer.quantizers_{i}"
        zi = conv(P, q + ".out_proj", P[q + ".codebook"][codes[:, i]].transpose(1, 2))
        z = zi if z is None else z + zi
    x = conv(P, "decoder.conv_in", z, padding=3)
    for i, s in enumerate(cfg.decoder_rates):
        x = conv_t(P, f"decoder.block_{i}.conv_t", snake(x, P[f"decoder.block_{i}.snake.alpha"]),
                   stride=s, padding=math.ceil(s / 2))
        for j, dil in zip((1, 2, 3), (1, 3, 9)):
            x = _res_unit(P, f"decoder.block_{i}.res_{j}", x, dil)
    return torch.tanh(conv(P, "decoder.conv_out", snake(x, P["decoder.snake_out.alpha"]),
                           padding=3))
