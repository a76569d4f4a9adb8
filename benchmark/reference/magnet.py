"""MAGNeT text-to-music in plain fp32 PyTorch, the benchmark's own copy: the
T5-base encoder and its projection, the MAGNeT LM's forward, the EnCodec
32 kHz decoder, and a stage-loop step's sampling and span scores (Ziv et
al., arXiv:2401.04577; audiocraft's `MagnetLMModel`, `T5Conditioner`,
`SEANetDecoder`, `ResidualVectorQuantizer`, `magnet_32khz` medium).

One row at a time, no kernel of the port, no cache (the cross-attention's
keys and values are projected at every forward), TF32 off (`fp32_mode`).
`operand`, where given, rounds both operands of every product of T5 and
the LM (`lm.fp8`: the precision below the configuration's bf16, for the
controls). The parameter names and shapes are the port's
(`vampnet_tpu_torch/modules/magnet.py`, `codec/encodec.py`); the weights
are drawn from the seed as the driver draws them (`weights.lm_state` for
T5 and the LM, `codec_state` here for the codec).

Departures from the published description, as the port has them:
  * a span's score is 1 - the largest probability of its sampled tokens
    under the kept (top-p renormalised) distribution; audiocraft takes the
    probabilities before top-p;
  * the sampler draws Gumbel-max with Philox4x32-10 noise under the key
    (0, seed mod 2^32) at counter (step of the whole loop, position,
    vocab // 4, 0) (the port's stream), where audiocraft calls
    `torch.multinomial`: the same distribution;
  * ties among span scores go to the lower span index;
  * a group's text is padded with zeros to its longest rounded up to the
    text grid, where audiocraft pads to the batch's longest.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.sampling import philox

KEEP_SCORE = -1e4  # audiocraft's DONT_REMASK_ME_SCORE
SPAN = 3  # frames a span: the unit of re-masking (non-overlapping, every stage)
_M = 0xFFFFFFFF


def fp32_mode() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------- shapes


def t5_shapes(c: dict) -> Dict[str, tuple]:
    d, inner = c["d_model"], c["n_heads"] * c["d_kv"]
    out = {"shared.weight": (c["vocab_size"], d), "rel_bias.weight": (c["num_buckets"],
                                                                       c["n_heads"])}
    for i in range(c["n_layers"]):
        p = f"layers.{i}."
        out[p + "norm1.weight"] = (d,)
        for n in ("q", "k", "v"):
            out[p + n + ".weight"] = (inner, d)
        out[p + "o.weight"] = (d, inner)
        out[p + "norm2.weight"] = (d,)
        out[p + "wi.weight"] = (c["d_ff"], d)
        out[p + "wo.weight"] = (d, c["d_ff"])
    out["final_norm.weight"] = (d,)
    out["output_proj.weight"] = (c["out_dim"], d)
    out["output_proj.bias"] = (c["out_dim"],)
    return out


def lm_shapes(c: dict) -> Dict[str, tuple]:
    d = c["dim"]
    out = {f"emb.{k}.weight": (c["card"] + 1, d) for k in range(c["n_q"])}
    for i in range(c["n_layers"]):
        p = f"layers.{i}."
        for norm, attn in (("norm1", "self_attn"), ("norm_cross", "cross_attn")):
            out[p + norm + ".weight"], out[p + norm + ".bias"] = (d,), (d,)
            for w in ("w_q", "w_k", "w_v", "out"):
                out[p + f"{attn}.{w}.weight"] = (d, d)
        out[p + "norm2.weight"], out[p + "norm2.bias"] = (d,), (d,)
        out[p + "linear1.weight"] = (c["ffn_dim"], d)
        out[p + "linear2.weight"] = (d, c["ffn_dim"])
    out["out_norm.weight"], out["out_norm.bias"] = (d,), (d,)
    for k in range(c["n_q"]):
        out[f"linears.{k}.weight"] = (c["card"], d)
    return out


def codec_shapes(c: dict) -> Dict[str, tuple]:
    mult = 2 ** len(c["ratios"])
    dim = mult * c["n_filters"]
    out = {"codebooks": (c["n_q"], c["bins"], c["dimension"])}

    def wn(p, c_out, c_in, k, transposed=False):
        out[p + ".v"] = (c_in, c_out, k) if transposed else (c_out, c_in, k)
        out[p + ".g"] = (c_in,) if transposed else (c_out,)
        out[p + ".bias"] = (c_out,)

    wn("decoder.conv_in", dim, c["dimension"], c["kernel_size"])
    for layer in range(c["lstm_layers"]):
        out[f"decoder.lstm.weight_ih_l{layer}"] = (4 * dim, dim)
        out[f"decoder.lstm.weight_hh_l{layer}"] = (4 * dim, dim)
        out[f"decoder.lstm.bias_ih_l{layer}"] = (4 * dim,)
        out[f"decoder.lstm.bias_hh_l{layer}"] = (4 * dim,)
    for i, r in enumerate(c["ratios"]):
        p = f"decoder.blocks.{i}."
        wn(p + "up", dim // 2, dim, 2 * r, transposed=True)
        hidden = dim // 2 // c["compress"]
        wn(p + "res.conv1", hidden, dim // 2, c["residual_kernel_size"])
        wn(p + "res.conv2", dim // 2, hidden, 1)
        dim //= 2
    wn("decoder.conv_out", 1, dim, c["last_kernel_size"])
    return out


def t5_state(cfg: dict, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """T5's weights as `weights.lm_state` draws an LM's (Dense weights
    normal / sqrt(fan-in), norm scales 1 + 0.1 normal), the query
    projections then scaled by d_kv^-0.5: T5 scales no attention score and
    initialises q at std (d_model d_kv)^-0.5 instead (its own convention),
    so that the scores start O(1) (fp32)."""
    from benchmark.harness import weights

    out = weights.lm_state(t5_shapes(cfg), gen)
    for k in out:
        if k.endswith(".q.weight"):
            out[k] = out[k] * cfg["d_kv"] ** -0.5
    return out


def codec_state(shapes: Dict[str, tuple], gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Codec weights from one normal and one uniform draw over all of them:
    weight-norm directions and codebooks normal, gains 0.8-1.2, biases 0.01
    normal, LSTM weights normal / (2 sqrt(hidden)) (fp32)."""
    total = sum(math.prod(s) for s in shapes.values())
    n = torch.randn((total,), generator=gen, device=gen.device)
    u = torch.rand((total,), generator=gen, device=gen.device)
    out, at = {}, 0
    for k, s in shapes.items():
        size = math.prod(s)
        x, y = n[at:at + size].view(s), u[at:at + size].view(s)
        at += size
        if k.endswith(".g"):
            x = 0.8 + 0.4 * y
        elif "lstm.weight" in k:
            x = 0.5 * x / s[-1] ** 0.5
        elif k.endswith("bias") or "lstm.bias" in k:
            x = 0.01 * x
        out[k] = x
    return out


# ---------------------------------------------------------------- T5

Operand = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _lin(x, w, b=None, o: Operand = None):
    return F.linear(x, w, b) if o is None else F.linear(o(x), o(w), b)


def _mm(a: str, x, y, o: Operand = None):
    return torch.einsum(a, x, y) if o is None else torch.einsum(a, o(x), o(y))


def t5_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    half = num_buckets // 2
    ret = (rel > 0).long() * half
    n = rel.abs()
    max_exact = half // 2
    large = max_exact + (torch.log(n.clamp(min=1).float() / max_exact)
                         / math.log(max_distance / max_exact) * (half - max_exact)).long()
    return ret + torch.where(n < max_exact, n, large.clamp(max=half - 1))


def rms_norm(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def t5_encode(sd, cfg, ids, length: int, o: Operand = None) -> torch.Tensor:
    """One text's T5 ids (l,) padded with zeros to `length` -> c (length,
    out_dim): the encoder, `output_proj`, zero at the padding."""
    dev = sd["shared.weight"].device
    l = len(ids)
    full = torch.zeros(length, dtype=torch.long, device=dev)
    full[:l] = torch.as_tensor(ids, device=dev)
    keep = torch.arange(length, device=dev) < l
    x = sd["shared.weight"][full]
    pos = torch.arange(length, device=dev)
    buckets = t5_bucket(pos[None, :] - pos[:, None], cfg["num_buckets"], cfg["max_distance"])
    bias = sd["rel_bias.weight"][buckets].permute(2, 0, 1)
    bias = bias.masked_fill(~keep[None, None, :], float("-inf"))  # padded keys: no weight
    h, dk = cfg["n_heads"], cfg["d_kv"]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        y = rms_norm(x, sd[p + "norm1.weight"], cfg["eps"])
        q, k, v = (_lin(y, sd[p + n + ".weight"], o=o).reshape(length, h, dk)
                   for n in ("q", "k", "v"))
        s = _mm("qhd,khd->hqk", q, k, o) + bias  # T5: no 1/sqrt(d) scale
        a = _mm("hqk,khd->qhd", torch.softmax(s, -1), v, o).reshape(length, h * dk)
        x = x + _lin(a, sd[p + "o.weight"], o=o)
        y = rms_norm(x, sd[p + "norm2.weight"], cfg["eps"])
        x = x + _lin(F.relu(_lin(y, sd[p + "wi.weight"], o=o)), sd[p + "wo.weight"], o=o)
    x = rms_norm(x, sd["final_norm.weight"], cfg["eps"])
    return _lin(x, sd["output_proj.weight"], sd["output_proj.bias"], o) * keep[:, None]


# ---------------------------------------------------------------- LM


def sin_embedding(t: int, dim: int, max_period: float, device) -> torch.Tensor:
    """cos | sin at periods max_period ** (i / (dim / 2 - 1))."""
    half = dim // 2
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    adim = torch.arange(half, dtype=torch.float32, device=device)[None, :]
    phase = pos / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def _attention(sd, p, x, src, n_heads, window=None, o: Operand = None):
    t, d = x.shape
    dh = d // n_heads
    q = _lin(x, sd[p + "w_q.weight"], o=o).reshape(t, n_heads, dh)
    k = _lin(src, sd[p + "w_k.weight"], o=o).reshape(src.shape[0], n_heads, dh)
    v = _lin(src, sd[p + "w_v.weight"], o=o).reshape(src.shape[0], n_heads, dh)
    s = _mm("qhd,khd->hqk", q, k, o) / math.sqrt(dh)
    if window is not None:  # the restricted context: keys with |i - j| <= window
        pos = torch.arange(t, device=x.device)
        s = s.masked_fill((pos[None, :] - pos[:, None]).abs()[None] > window, float("-inf"))
    a = _mm("hqk,khd->qhd", torch.softmax(s, -1), v, o).reshape(t, d)
    return _lin(a, sd[p + "out.weight"], o=o)


def _ln(sd, p, x, eps):
    return F.layer_norm(x, x.shape[-1:], sd[p + ".weight"], sd[p + ".bias"], eps)


def lm_logits(sd, cfg, codes, stage: int, c, o: Operand = None) -> torch.Tensor:
    """One row: codes (n_q, t) in [0, card], the conditioning c (l, dim) ->
    the stage head's logits (t, card). No bias anywhere but the layer
    norms'; the cross-attention has no key mask."""
    t = codes.shape[-1]
    x = sum(sd[f"emb.{k}.weight"][codes[k]] for k in range(cfg["n_q"]))
    x = x + sin_embedding(t, cfg["dim"], cfg["max_period"], x.device)
    window = None if stage == 0 else cfg["subcodes_context"]
    eps = cfg["norm_eps"]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        y = _ln(sd, p + "norm1", x, eps)
        x = x + _attention(sd, p + "self_attn.", y, y, cfg["n_heads"], window, o)
        x = x + _attention(sd, p + "cross_attn.", _ln(sd, p + "norm_cross", x, eps), c,
                           cfg["n_heads"], None, o)
        y = _ln(sd, p + "norm2", x, eps)
        x = x + _lin(F.gelu(_lin(y, sd[p + "linear1.weight"], o=o)), sd[p + "linear2.weight"],
                     o=o)
    return _lin(_ln(sd, "out_norm", x, eps), sd[f"linears.{stage}.weight"], o=o)


# ---------------------------------------------------------------- codec


def _wn(sd, p):
    v, g = sd[p + ".v"], sd[p + ".g"]
    return g[:, None, None] * v / (v.reshape(v.shape[0], -1).norm(dim=1)[:, None, None] + 1e-12)


def _conv(sd, p, x, pad: int):
    return F.conv1d(F.pad(x, (pad, pad)), _wn(sd, p), sd[p + ".bias"])


def _lstm(sd, x, layers: int):
    """x (t, d) through the stacked LSTM, step by step (gates i, f, g, o)."""
    for layer in range(layers):
        w_ih, w_hh = sd[f"decoder.lstm.weight_ih_l{layer}"], sd[f"decoder.lstm.weight_hh_l{layer}"]
        pre = F.linear(x, w_ih) + sd[f"decoder.lstm.bias_ih_l{layer}"] \
            + sd[f"decoder.lstm.bias_hh_l{layer}"]
        h = torch.zeros(w_hh.shape[1], device=x.device)
        cell = torch.zeros_like(h)
        out = []
        for t in range(x.shape[0]):
            i, f, g, o = (pre[t] + w_hh @ h).chunk(4)
            cell = torch.sigmoid(f) * cell + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(cell)
            out.append(h)
        x = torch.stack(out)
    return x


def decode(sd, cfg, codes) -> torch.Tensor:
    """One row's codes (n_q, frames) -> audio (frames * hop,)."""
    z = sum(sd["codebooks"][k][codes[k]] for k in range(cfg["n_q"])).T[None]
    k = cfg["kernel_size"]
    x = _conv(sd, "decoder.conv_in", z, (k - 1) // 2)  # pad_mode "constant" (assumed)
    x = x + _lstm(sd, x[0].T, cfg["lstm_layers"]).T[None]  # the LSTM's skip
    for i, r in enumerate(cfg["ratios"]):
        p = f"decoder.blocks.{i}."
        y = F.conv_transpose1d(F.elu(x), _wn(sd, p + "up"), sd[p + "up.bias"], stride=r)
        y = y[..., r - r // 2: y.shape[-1] - r // 2]  # the non-causal trim
        rk = cfg["residual_kernel_size"]
        res = _conv(sd, p + "res.conv1", F.elu(y), (rk - 1) // 2)
        x = y + _conv(sd, p + "res.conv2", F.elu(res), 0)  # true_skip: identity
    k = cfg["last_kernel_size"]
    return _conv(sd, "decoder.conv_out", F.elu(x), (k - 1) // 2)[0, 0]


# ---------------------------------------------------------------- sampling


def gumbel(seed: int, step: int, t: int, vocab: int, device) -> torch.Tensor:
    """(t, vocab) Gumbel noise of a request's row at a step of the whole
    loop (see the module docstring)."""
    c1 = torch.arange(t, device=device)[:, None].expand(t, vocab // 4)
    c2 = torch.arange(vocab // 4, device=device)[None, :].expand(t, vocab // 4)
    words = torch.stack(philox(torch.full_like(c1, int(step) & _M), c1, c2, torch.zeros_like(c1),
                               0, int(seed) & _M), dim=-1).reshape(t, vocab)
    u = ((words >> 9).float() + 0.5) * 2.0 ** -23
    return -torch.log(-torch.log(u))


def top_p_keep(probs: torch.Tensor, top_p: float) -> torch.Tensor:
    """audiocraft's `sample_top_p` set: a token stays where the mass of the
    tokens sorted before it is at most top_p."""
    p_sort, order = torch.sort(probs, dim=-1, descending=True)
    drop_sorted = (torch.cumsum(p_sort, -1) - p_sort) > top_p
    return ~torch.zeros_like(drop_sorted).scatter(-1, order, drop_sorted)


def schedule(step: int, steps: int) -> float:
    """The mask share cos(pi / 2 * step / (steps - 1)) over torch.linspace."""
    return float(torch.cos(torch.linspace(0, 1, steps)[step] * math.pi * 0.5))


def n_masked(step: int, steps: int, n_spans: int) -> int:
    return max(int(schedule(step, steps) * n_spans), 1)


def guided(cond, uncond, step: int, steps: int, knobs: dict):
    """The step's logits as the sampler takes them: CFG at the annealed
    coefficient, over the annealed temperature (at least 0.01)."""
    p = schedule(step, steps)
    coef = p * knobs["max_cfg_coef"] + (1 - p) * knobs["min_cfg_coef"]
    temp = knobs["temperature"] * (steps - 1 - step) / steps
    return (uncond + (cond - uncond) * coef) / max(temp, 1e-2)


def sample(logits, noise, top_p):
    """Gumbel-max over the top-p set -> (tokens, the kept set, every token's
    probability under the kept set renormalised)."""
    keep = top_p_keep(torch.softmax(logits, -1), top_p)
    kept = logits.masked_fill(~keep, float("-inf"))
    return torch.argmax(kept + noise, dim=-1), keep, torch.softmax(kept, -1)


def span_scores(probs_of_tokens: torch.Tensor, span: int) -> torch.Tensor:
    """1 - the largest of each span's sampled tokens' probabilities."""
    return 1.0 - probs_of_tokens.reshape(-1, span).amax(-1)
