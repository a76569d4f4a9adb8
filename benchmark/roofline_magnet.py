"""Operations and bytes of the text-to-music cell's kernels and model,
counted from shapes, against the peaks of `benchmark/roofline.py`.

As there, a kernel's count reads each input byte once and writes each
output byte once, and its products count the work the shapes need; the
model FLOPs count what MAGNeT's algorithm needs for a request: T5 and its
projection over the text's own tokens, the cross-attention's keys and
values once, every step's forward of the two CFG rows (the projections,
the self-attention over all keys at stage 0 and over the band after, the
cross-attention, the FFN and the stage's head), and the codec's decode.

`stream_spans` ties a traced kernel to a benchmark span: its own, or, for
a kernel no torch operator launched (the port's attention and sampler
kernels), the span of the kernel before it on the device, which runs a
group's work on one stream in order.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from benchmark.roofline import H100_BF16_FLOPS, H100_BYTES_PER_S, H100_FP32_FLOPS, least_s

__all__ = ["H100_BF16_FLOPS", "H100_BYTES_PER_S", "H100_FP32_FLOPS", "least_s"]

# fp32 operations per logit of the sampler's top-p path (no typical filter):
# the softmax for top-p (max, exp, sum, scale: 4), 24 bisection steps over
# every logit (compare-select and add: 2 each), the sampling softmax and
# Gumbel-max (exp, sum, add, compare: 4), the Gumbel transform (2 logs) and
# a quarter of a Philox4x32-10 draw (10 rounds of 2 multiplies and 4
# logic operations, shared by four logits: 15)
SAMPLER_TOP_P_OPS_PER_LOGIT = 4 + 24 * 2 + 4 + 2 + 15


def band_keys(t: int, w: int) -> float:
    """The mean number of keys j with |i - j| <= w a query i of t sees."""
    return sum(min(t - 1, i + w) - max(0, i - w) + 1 for i in range(t)) / t


def attention_fwd(b: int, t_q: int, t_k: int, h: int, d: int,
                  keys_per_query: Optional[float] = None) -> Tuple[float, float]:
    """(flops, bytes) of one launch of the no-bias attention forward: q and
    o (b, t_q, h, d) and k, v (b, t_k, h, d) in bf16; two products over
    the keys a query sees (all t_k, or the band's)."""
    kq = t_k if keys_per_query is None else keys_per_query
    return 4.0 * b * h * t_q * kq * d, 2.0 * 2 * b * h * d * (t_q + t_k)


def k10_top_p(b: int, flat: int, vocab: int) -> Tuple[float, float]:
    """(flops, bytes) of one sampler launch over (b, flat, vocab) fp32
    logits with top-p: the logits, the keys, tokens and probabilities, and
    the per-row knobs."""
    n = b * flat * vocab
    return float(n * SAMPLER_TOP_P_OPS_PER_LOGIT), n * 4.0 + b * 2 * 8 + b * flat * 12 + 3 * b * 4


def lm_forward_flops(t: int, text: int, stage: int, lm: dict) -> float:
    """One MAGNeT forward of one row over t frames conditioned on `text`
    tokens, the cross-attention's keys and values given."""
    d, f, w = lm["dim"], lm["ffn_dim"], lm["subcodes_context"]
    kq = t if stage == 0 else band_keys(t, w)
    per_layer = 2 * t * (4 * d * d + 2 * d * d + 2 * d * f) + 4 * t * kq * d + 4 * t * text * d
    return lm["n_layers"] * per_layer + 2 * t * d * lm["card"]


def t5_flops(text: int, t5: dict) -> float:
    d, inner = t5["d_model"], t5["n_heads"] * t5["d_kv"]
    per_layer = 2 * text * (4 * d * inner + 2 * d * t5["d_ff"]) + 4 * text * text * inner
    return t5["n_layers"] * per_layer + 2 * text * d * t5["out_dim"]


def _conv(c_in: int, c_out: int, k: int, length_out: int) -> float:
    return 2.0 * c_in * c_out * k * length_out


def decode_flops(frames: int, codec: dict) -> float:
    """The EnCodec decoder over `frames` frames: the input conv, the LSTM's
    two products a layer and frame, each block's transposed conv (each
    input frame once) and residual unit, the output conv."""
    dim = 2 ** len(codec["ratios"]) * codec["n_filters"]
    f = _conv(codec["dimension"], dim, codec["kernel_size"], frames)
    f += codec["lstm_layers"] * frames * 2 * (2 * 4 * dim * dim)
    length = frames
    for r in codec["ratios"]:
        f += _conv(dim, dim // 2, 2 * r, length)
        length *= r
        dim //= 2
        hidden = dim // codec["compress"]
        f += _conv(dim, hidden, codec["residual_kernel_size"], length) + _conv(hidden, dim, 1,
                                                                              length)
    return f + _conv(dim, 1, codec["last_kernel_size"], length)


def request_flops(cfg: dict, frames: int, text: int, steps) -> float:
    """A request's model FLOPs at its own text length (padding is no work)."""
    lm = cfg["lm"]
    kv = lm["n_layers"] * 2 * text * 2 * lm["dim"] * lm["dim"]
    lm_f = sum(n * 2 * lm_forward_flops(frames, text, stage, lm) for stage, n in enumerate(steps))
    return t5_flops(text, cfg["t5"]) + kv + lm_f + decode_flops(frames, cfg["codec"])


def stream_spans(trace) -> List[tuple]:
    """(name, start ns, end ns, span) of the traced kernels in device order,
    a kernel with no span of its own given the span of the one before it."""
    out, span = [], None
    for name, s, e, own in sorted(trace.kernels, key=lambda k: k[1]):
        span = own if own is not None else span
        out.append((name, s, e, span))
    return out
