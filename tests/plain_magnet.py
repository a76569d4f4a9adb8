"""MAGNeT text-to-music in plain fp32 PyTorch: the T5-base encoder and its
projection, the MAGNeT LM's forward, the EnCodec 32 kHz decoder and the
stage loop, one request at a time, as the published description has them
(Ziv et al., arXiv:2401.04577; audiocraft's `MagnetLMModel`,
`T5Conditioner`, `SEANetDecoder`, `ResidualVectorQuantizer`).

It imports nothing of the port or of the JAX package, calls no kernel,
keeps no cache (the cross-attention's keys and values are projected again
at every forward) and batches nothing (the conditioned and unconditioned
rows of classifier-free guidance are two forwards). TF32 is off for matmuls
and convolutions. Weights are state dicts with the port's key names
(`vampnet_tpu_torch/modules/magnet.py`, `codec/encodec.py`), configs plain
dicts (`T5`, `LM`, `CODEC` below hold the published sizes).

Departures from the published description, each noted at its line too:
  * the span score: 1 - the largest probability of a span's sampled tokens
    under the kept (top-p renormalised) distribution; audiocraft takes the
    probabilities before top-p;
  * the sampler's randomness: Gumbel-max with Philox4x32-10 noise keyed by
    the request's seed (the port's stream), where audiocraft draws with
    `torch.multinomial`; the same distribution;
  * span ties: the stable order (lower span index first), where
    audiocraft's `topk` leaves them to the device;
  * the text is padded with zeros to a length the caller gives (the port's
    text grid), where audiocraft pads to the batch's longest.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T5 = dict(vocab_size=32128, d_model=768, n_layers=12, n_heads=12, d_kv=64, d_ff=3072,
          num_buckets=32, max_distance=128, eps=1e-6, out_dim=1536)
LM = dict(dim=1536, n_layers=48, n_heads=24, ffn_dim=6144, n_q=4, card=2048,
          subcodes_context=5, norm_eps=1e-5, max_period=10000.0)
CODEC = dict(sample_rate=32000, dimension=128, n_filters=64, ratios=(8, 5, 4, 4), n_q=4,
             bins=2048, lstm_layers=2, kernel_size=7, last_kernel_size=7,
             residual_kernel_size=3, compress=2)
GENERATION = dict(decoding_steps=(60, 10, 10, 10), top_p=0.9, temperature=3.0,
                  max_cfg_coef=10.0, min_cfg_coef=1.0)
SPAN = 3  # frames a span: the unit of re-masking (non-overlapping, every stage)
KEEP_SCORE = -1e4  # audiocraft's DONT_REMASK_ME_SCORE


def _w(sd, name):
    return sd[name].float()


# ---------------------------------------------------------------- T5


def t5_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's bidirectional bucket of each key - query offset."""
    half = num_buckets // 2
    ret = (rel > 0).long() * half
    n = rel.abs()
    max_exact = half // 2
    large = max_exact + (torch.log(n.clamp(min=1).float() / max_exact)
                         / math.log(max_distance / max_exact) * (half - max_exact)).long()
    return ret + torch.where(n < max_exact, n, large.clamp(max=half - 1))


def rms_norm(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def t5_encode(sd, cfg, ids, length: int) -> torch.Tensor:
    """One text's T5 ids (l,) padded to `length` -> c (length, out_dim): the
    encoder, `output_proj`, zero at the padding."""
    l = len(ids)
    full = torch.zeros(length, dtype=torch.long, device=sd["shared.weight"].device)
    full[:l] = torch.as_tensor(ids, device=full.device)
    keep = torch.arange(length, device=full.device) < l
    x = _w(sd, "shared.weight")[full]
    pos = torch.arange(length, device=full.device)
    buckets = t5_bucket(pos[None, :] - pos[:, None], cfg["num_buckets"], cfg["max_distance"])
    bias = _w(sd, "rel_bias.weight")[buckets].permute(2, 0, 1)  # (h, l, l)
    bias = bias.masked_fill(~keep[None, None, :], float("-inf"))  # padded keys: no weight
    h, dk = cfg["n_heads"], cfg["d_kv"]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        y = rms_norm(x, _w(sd, p + "norm1.weight"), cfg["eps"])
        q, k, v = (F.linear(y, _w(sd, p + n + ".weight")).reshape(length, h, dk)
                   for n in ("q", "k", "v"))
        s = torch.einsum("qhd,khd->hqk", q, k) + bias  # T5: no 1/sqrt(d) scale
        a = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v).reshape(length, h * dk)
        x = x + F.linear(a, _w(sd, p + "o.weight"))
        y = rms_norm(x, _w(sd, p + "norm2.weight"), cfg["eps"])
        x = x + F.linear(F.relu(F.linear(y, _w(sd, p + "wi.weight"))), _w(sd, p + "wo.weight"))
    x = rms_norm(x, _w(sd, "final_norm.weight"), cfg["eps"])
    c = F.linear(x, _w(sd, "output_proj.weight"), _w(sd, "output_proj.bias"))
    return c * keep[:, None]


# ---------------------------------------------------------------- LM


def sin_embedding(t: int, dim: int, max_period: float, device) -> torch.Tensor:
    half = dim // 2
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    adim = torch.arange(half, dtype=torch.float32, device=device)[None, :]
    phase = pos / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def attention(sd, p, x, src, n_heads, window=None):
    """Multi-head attention of x (t, d) over src (s, d), no biases; keys with
    |i - j| > window get no weight."""
    t, d = x.shape
    dh = d // n_heads
    q = F.linear(x, _w(sd, p + "w_q.weight")).reshape(t, n_heads, dh)
    k = F.linear(src, _w(sd, p + "w_k.weight")).reshape(src.shape[0], n_heads, dh)
    v = F.linear(src, _w(sd, p + "w_v.weight")).reshape(src.shape[0], n_heads, dh)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(dh)
    if window is not None:
        pos = torch.arange(t, device=x.device)
        s = s.masked_fill((pos[None, :] - pos[:, None]).abs()[None] > window, float("-inf"))
    a = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v).reshape(t, d)
    return F.linear(a, _w(sd, p + "out.weight"))


def layer_norm(sd, p, x, eps):
    return F.layer_norm(x, x.shape[-1:], _w(sd, p + ".weight"), _w(sd, p + ".bias"), eps)


def lm_hidden(sd, cfg, codes, stage: int, c) -> torch.Tensor:
    """One row: codes (n_q, t) in [0, card], c (l, dim) -> the final layer
    norm's output (t, dim)."""
    t = codes.shape[-1]
    x = sum(_w(sd, f"emb.{k}.weight")[codes[k]] for k in range(cfg["n_q"]))
    x = x + sin_embedding(t, cfg["dim"], cfg["max_period"], x.device)
    window = None if stage == 0 else cfg["subcodes_context"]
    eps = cfg["norm_eps"]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        x = x + attention(sd, p + "self_attn.", layer_norm(sd, p + "norm1", x, eps),
                          layer_norm(sd, p + "norm1", x, eps), cfg["n_heads"], window)
        x = x + attention(sd, p + "cross_attn.", layer_norm(sd, p + "norm_cross", x, eps), c,
                          cfg["n_heads"])
        y = layer_norm(sd, p + "norm2", x, eps)
        x = x + F.linear(F.gelu(F.linear(y, _w(sd, p + "linear1.weight"))),
                         _w(sd, p + "linear2.weight"))
    return layer_norm(sd, "out_norm", x, eps)


def lm_logits(sd, cfg, codes, stage: int, c) -> torch.Tensor:
    """One row's logits of the stage's head, (t, card)."""
    return F.linear(lm_hidden(sd, cfg, codes, stage, c), _w(sd, f"linears.{stage}.weight"))


# ---------------------------------------------------------------- codec


def wn(sd, p):
    v, g = _w(sd, p + ".v"), _w(sd, p + ".g")
    return g[:, None, None] * v / (v.reshape(v.shape[0], -1).norm(dim=1)[:, None, None] + 1e-12)


def conv(sd, p, x, pad: int):
    return F.conv1d(F.pad(x, (pad, pad)), wn(sd, p), _w(sd, p + ".bias"))


def lstm(sd, x, layers: int):
    """x (t, d) through a stacked LSTM (PyTorch's gate order i, f, g, o)."""
    for layer in range(layers):
        w_ih, w_hh = _w(sd, f"decoder.lstm.weight_ih_l{layer}"), \
            _w(sd, f"decoder.lstm.weight_hh_l{layer}")
        b = _w(sd, f"decoder.lstm.bias_ih_l{layer}") + _w(sd, f"decoder.lstm.bias_hh_l{layer}")
        pre = F.linear(x, w_ih) + b
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
    z = sum(_w(sd, "codebooks")[k][codes[k]] for k in range(cfg["n_q"])).T[None]  # (1, 128, t)
    k = cfg["kernel_size"]
    x = conv(sd, "decoder.conv_in", z, (k - 1) // 2)  # pad_mode "constant" (assumed)
    x = x + lstm(sd, x[0].T, cfg["lstm_layers"]).T[None]  # the LSTM's skip
    for i, r in enumerate(cfg["ratios"]):
        p = f"decoder.blocks.{i}."
        y = F.conv_transpose1d(F.elu(x), wn(sd, p + "up"), _w(sd, p + "up.bias"), stride=r)
        y = y[..., r - r // 2: y.shape[-1] - r // 2]  # the non-causal trim
        rk = cfg["residual_kernel_size"]
        res = conv(sd, p + "res.conv1", F.elu(y), (rk - 1) // 2)
        x = y + conv(sd, p + "res.conv2", F.elu(res), 0)  # true_skip: identity
    k = cfg["last_kernel_size"]
    return conv(sd, "decoder.conv_out", F.elu(x), (k - 1) // 2)[0, 0]


# ---------------------------------------------------------------- sampling

_M = 0xFFFFFFFF


def _mulhilo(a: int, c: torch.Tensor):
    lo16, hi16 = a * (c & 0xFFFF), a * (c >> 16)
    mid = (hi16 & 0xFFFF) * 65536 + lo16
    return (hi16 >> 16) + (mid >> 32), mid & _M


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors of 32-bit words."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _M, (k1 + 0xBB67AE85) & _M
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def gumbel(seed: int, step: int, t: int, vocab: int, device) -> torch.Tensor:
    """(t, vocab) Gumbel noise of a request at a step of the whole loop:
    Philox under the key (0, seed mod 2^32) at counter (step, position,
    vocab // 4, 0), word i for vocab index 4 (index // 4) + i."""
    c1 = torch.arange(t, device=device)[:, None].expand(t, vocab // 4)
    c2 = torch.arange(vocab // 4, device=device)[None, :].expand(t, vocab // 4)
    words = torch.stack(philox(torch.full_like(c1, step), c1, c2, torch.zeros_like(c1), 0,
                               int(seed) & _M), dim=-1).reshape(t, vocab)
    u = ((words >> 9).float() + 0.5) * 2.0 ** -23
    return -torch.log(-torch.log(u))


def top_p_keep(probs: torch.Tensor, top_p: float) -> torch.Tensor:
    """audiocraft's `sample_top_p` set: a token stays where the mass of the
    tokens sorted before it is at most top_p."""
    p_sort, order = torch.sort(probs, dim=-1, descending=True)
    drop_sorted = (torch.cumsum(p_sort, -1) - p_sort) > top_p
    return ~torch.zeros_like(drop_sorted).scatter(-1, order, drop_sorted)


def sample(logits, noise, top_p):
    """Gumbel-max over the top-p set of softmax(logits) -> (tokens, their
    probabilities under the kept set renormalised)."""
    keep = top_p_keep(torch.softmax(logits, -1), top_p)
    kept = logits.masked_fill(~keep, float("-inf"))
    tokens = torch.argmax(kept + noise, dim=-1)
    probs = torch.softmax(kept, -1).gather(-1, tokens[:, None])[:, 0]
    return tokens, probs


def schedule(step: int, steps: int) -> float:
    """cos(pi / 2 * step / (steps - 1)) over torch.linspace (fp32)."""
    return float(torch.cos(torch.linspace(0, 1, steps)[step] * math.pi * 0.5))


def stage_loop(logits_fn, seed: int, n_q: int, t: int, card: int, gen=None):
    """One request's whole loop; `logits_fn(codes (n_q, t), stage, cond)`
    gives one row's stage logits (t, card) with the text's conditioning
    (cond True) or the all-zero one. Returns (codes (n_q, t), the chosen
    span masks of every step, each (n_spans,) bool)."""
    g = {**GENERATION, **(gen or {})}
    span = SPAN
    n_spans = t // span
    codes = torch.full((n_q, t), card, dtype=torch.long)
    chosen_all = []
    step_id = 0
    for stage, n in enumerate(g["decoding_steps"]):
        scores = torch.zeros(n_spans)
        for i in range(n):
            p = schedule(i, n)
            n_masked = max(int(p * n_spans), 1)
            order = torch.sort(scores, descending=True, stable=True).indices  # ties: lower first
            chosen = torch.zeros(n_spans, dtype=torch.bool)
            chosen[order[:n_masked]] = True
            frame_mask = chosen.repeat_interleave(span)
            codes[stage] = torch.where(frame_mask, card, codes[stage])
            cond = logits_fn(codes.clone(), stage, True).cpu()
            uncond = logits_fn(codes.clone(), stage, False).cpu()
            coef = p * g["max_cfg_coef"] + (1 - p) * g["min_cfg_coef"]
            temp = g["temperature"] * (n - 1 - i) / n
            logits = (uncond + (cond - uncond) * coef) / max(temp, 1e-2)
            tokens, probs = sample(logits, gumbel(seed, step_id, t, card, "cpu"), g["top_p"])
            codes[stage] = torch.where(frame_mask, tokens, codes[stage])
            best = probs.reshape(n_spans, span).amax(-1)  # span score: the kept set's probs
            scores = torch.where(chosen, 1.0 - best, torch.tensor(KEEP_SCORE))
            chosen_all.append(chosen)
            step_id += 1
    return codes, chosen_all
