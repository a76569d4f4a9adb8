"""Operations and bytes counted from shapes, and the published peaks of one
NVIDIA H100 (SXM data sheet, dense rates, at the full 700 W).

Frozen with the benchmark: a later change to the port cannot move this
yardstick. The kernels' counts are those the port's card checks use: each
input byte read once and each output byte written once, whatever a kernel
reads again; the products counted at the work the shapes need. A kernel's
least time is the larger of its operations over the peak rate and its bytes
over the memory bandwidth.

The model FLOPs (`lm_forward_flops`, `codec_*_flops`) count what the
algorithm needs at a request's own token count: the LM's projections,
attention's two products and the classifier; the codec's convolutions.
"""
from __future__ import annotations

import math
from typing import Sequence

H100_BYTES_PER_S = 3.35e12  # HBM3
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores

# fp32 operations per logit that the sampler's function needs: log-softmax,
# entropy and typicality (~10), 6 bisection steps over every logit (compare,
# masked add of p, masked add of the count), and the compaction of the
# undecided band (~3); the rest runs over the band and the kept tokens.
SAMPLER_OPS_PER_LOGIT = 10 + 6 * 3 + 3


def least_s(flops: float, nbytes: float, peak_flops: float = H100_BF16_FLOPS) -> float:
    """The least time of a launch: operations over the peak, or bytes over
    the bandwidth, whichever is longer."""
    return max(flops / peak_flops, nbytes / H100_BYTES_PER_S)


# ---------------------------------------------------------------- kernels


def k1_attention_fwd(b: int, t: int, h: int, d: int, bias_bytes: int = 2):
    """(flops, bytes) of one inference attention launch (K1): q, k, v and o
    in bf16, the head-shared (h, t, t) bias; two score-sized products."""
    io = 4 * b * t * h * d * 2 + h * t * t * bias_bytes
    return 4 * h * b * t * t * d, io


def k10_sampler(b: int, flat: int, vocab: int):
    """(flops, bytes) of one sampler launch (K10) over (b, flat, vocab) fp32
    logits: the logits, the keys, tokens and probabilities, per-row knobs."""
    n = b * flat * vocab
    io = n * 4 + b * 2 * 8 + b * flat * (8 + 4) + 3 * b * 4
    return n * SAMPLER_OPS_PER_LOGIT, io


def k4_attention_fwd_lse(b: int, t: int, h: int, d: int, bias_bytes: int = 4):
    """(flops, bytes) of one training forward launch (K4): q, k, v, o (bf16),
    the bias, and the fp32 lse rows; two products."""
    act = b * t * h * d * 2
    rows = b * h * t * 4
    return 2 * (2 * h * d * b * t * t), 4 * act + h * t * t * bias_bytes + rows


def k8_attention_bwd(b: int, t: int, h: int, d: int, bias_bytes: int = 4):
    """(flops, bytes) of one backward launch (K8, the one-pass K6-K8): q, k,
    v, do, the bias, lse and delta read; dq, dk, dv and dbias written; five
    products."""
    act = b * t * h * d * 2
    rows = b * h * t * 4
    return 5 * (2 * h * d * b * t * t), 7 * act + 2 * h * t * t * bias_bytes + 2 * rows


# ---------------------------------------------------------------- models


def lm_forward_flops(t: int, d: int, n_layers: int, n_codebooks: int, latent_dim: int,
                     n_predict: int, vocab: int) -> float:
    """One LM forward over one row of t tokens: the embedding's projection,
    per layer q, k, v and fc (4 d^2 a token), the GEGLU's w_1 (d -> 4d) and
    w_2 (2d -> d), attention's QK^T and PV (2 t^2 d each over all heads),
    and the classifier."""
    emb = 2 * t * n_codebooks * latent_dim * d
    per_layer = 2 * t * (4 * d * d + d * 4 * d + 2 * d * d) + 4 * t * t * d
    cls = 2 * t * d * n_predict * vocab
    return emb + n_layers * per_layer + cls


def _conv(c_in: int, c_out: int, k: int, length_out: int) -> float:
    return 2.0 * c_in * c_out * k * length_out


def codec_encode_flops(samples: int, encoder_dim: int, encoder_rates: Sequence[int],
                       n_codebooks: int, codebook_size: int, codebook_dim: int) -> float:
    """The encoder's convolutions and the residual quantizer's projections
    and searches over `samples` samples."""
    length = samples
    d = encoder_dim
    f = _conv(1, d, 7, length)
    for s in encoder_rates:
        d *= 2
        f += 3 * (_conv(d // 2, d // 2, 7, length) + _conv(d // 2, d // 2, 1, length))
        length = math.ceil(length / s)
        f += _conv(d // 2, d, 2 * s, length)
    f += _conv(d, d, 3, length)
    # per stage: in_proj, the cosine search over the codebook, out_proj
    f += n_codebooks * length * (2 * d * codebook_dim + 2 * codebook_dim * codebook_size
                                 + 2 * codebook_dim * d)
    return f


def codec_decode_flops(frames: int, encoder_dim: int, encoder_rates: Sequence[int],
                       decoder_dim: int, decoder_rates: Sequence[int],
                       n_codebooks: int, codebook_dim: int) -> float:
    """The quantizer's out-projections and the decoder's convolutions over
    `frames` frames."""
    latent = encoder_dim * 2 ** len(encoder_rates)
    f = n_codebooks * _conv(codebook_dim, latent, 1, frames)
    length = frames
    f += _conv(latent, decoder_dim, 7, length)
    c_in = decoder_dim
    for i, s in enumerate(decoder_rates):
        c_out = decoder_dim // 2 ** (i + 1)
        f += _conv(c_in, c_out, 2 * s, length)  # transposed: each input frame once
        length *= s
        f += 3 * (_conv(c_out, c_out, 7, length) + _conv(c_out, c_out, 1, length))
        c_in = c_out
    f += _conv(c_in, 1, 7, length)
    return f
