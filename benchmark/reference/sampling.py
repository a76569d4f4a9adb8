"""The request arithmetic around the LM in plain PyTorch: the mask a web
request asks for, the chunk rows the LMs see, the MaskGIT schedule, and a
MaskGIT step's sampling and re-masking (upstream vampnet
`interface.build_mask`, `VampNet.generate`, `sampling.typical_filter`,
`sample_from_logits` and `mask_by_random_topk`).

The mask draws from a `torch.Generator` seeded with the request's seed, in
the port's order (a Bernoulli mask, the periodic prompt's random roll, the
dropped steps), so a generator on the same device draws what the port's
drew. The typical and top-p filters are upstream's sort forms; the port
bisects for the same thresholds.

The random draws of a step replay the streams the port documents for its
per-row keys (`vampnet_tpu_torch/sampling/sample.py` and
`ops/sampler_kernel.py`), written again here: Philox4x32-10 under the row's
two 32-bit key words; the sampler's Gumbel noise for vocab entry v at
position p of step s is word v % 4 of the counter (s, p, v // 4, 0), the
re-masking noise word 0 of (s, p, 0, 1), and a key folded with d the first
two words of (d, 0, 0, 2); a word w is the uniform ((w >> 9) + 0.5) 2^-23
and the noise -log(-log(u)). A request's row takes the key (0, seed mod
2^32), folded with its chunk's index where the request has several chunk
rows.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo32(a: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of a * c for a 32-bit constant a and int64
    tensors c holding 32-bit values, in 16-bit halves so nothing overflows."""
    p_lo = a * (c & 0xFFFF)
    p_hi = a * (c >> 16)
    mid = (p_hi & 0xFFFF) * 65536 + p_lo
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words (broadcasting)."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo32(_M0, c0)
        hi1, lo1 = _mulhilo32(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform(words: torch.Tensor) -> torch.Tensor:
    return ((words >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u))


def row_key(seed: int, chunk: Optional[int] = None) -> tuple:
    """The key (k0, k1) of a request's row: (0, seed mod 2^32), folded with
    the chunk's index where given."""
    key = (0, int(seed) & _MASK32)
    if chunk is None:
        return key
    z = torch.zeros((1,), dtype=torch.int64)
    w0, w1, _, _ = philox(torch.tensor([int(chunk) & _MASK32]), z, z, z + 2, *key)
    return int(w0), int(w1)


def sampler_noise(key: tuple, step: int, n: int, vocab: int, device) -> torch.Tensor:
    """(n, vocab) Gumbel noise of the sampler at step `step`, positions 0..n-1."""
    c1 = torch.arange(n, dtype=torch.int64, device=device)[:, None].expand(n, vocab // 4)
    c2 = torch.arange(vocab // 4, dtype=torch.int64, device=device)[None, :].expand(n, vocab // 4)
    c0 = torch.full_like(c1, int(step) & _MASK32)
    words = torch.stack(philox(c0, c1, c2, torch.zeros_like(c1), *key), dim=-1)
    return _gumbel(_uniform(words.reshape(n, vocab)))


def remask_noise(key: tuple, step: int, n: int, device) -> torch.Tensor:
    """(n,) Gumbel noise of the re-masking at step `step`."""
    c1 = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(c1)
    w0, _, _, _ = philox(zero + (int(step) & _MASK32), c1, zero, zero + 1, *key)
    return _gumbel(_uniform(w0))


def web_mask(shape, period: int, dropout: float, upper_codebook_mask: int, seed: int,
             device) -> torch.Tensor:
    """The mask (1 = regenerate) of a web request's codes of `shape` (1, C, t):
    all-random at intensity 1, a periodic prompt of width 1 rolled by a
    random offset (period 0 masks everything), `dropout` of the steps
    forced back, and every codebook from `upper_codebook_mask` up forced."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    b, c, t = shape
    u = torch.rand(shape, generator=gen, device=device)
    m = (u < 1.0).to(torch.int64)
    if period:
        pos = torch.arange(t, device=device)
        dmod = pos % period
        keep = (dmod <= 0) | ((period - dmod <= 0) & (pos - dmod + period < t))
        per = torch.where(keep, 0, 1).to(torch.int64)[None, None, :].expand(shape)
        offset = int(torch.randint(0, period, (), generator=gen, device=device))
        m = torch.minimum(m, torch.roll(per, offset, dims=-1))
    n_drop = int(t * dropout)
    if n_drop:
        idx = torch.randint(0, t, (n_drop,), generator=gen, device=device)
        dropped = torch.zeros((t,), dtype=torch.int64, device=device)
        dropped[idx] = 1
        m = torch.maximum(m, dropped[None, None, :])
    cb = torch.arange(c, device=device)[None, :, None]
    return torch.where(cb >= upper_codebook_mask, 1, m)


def chunk_rows(z: torch.Tensor, m: torch.Tensor, chunk: int, mask_token: int,
               pin_edges: bool, pinned=None):
    """(b, C, t) codes and mask -> the LM's rows (n_chunks * b, C, chunk),
    chunk-major, padded with code 0 and mask 1; with `pin_edges` a chunk's
    first and last steps are kept wherever any step of it is kept, or, given
    `pinned` (one bool per chunk), where that says. Returns (masked rows,
    mask rows)."""
    b, c, t = z.shape
    n = math.ceil(t / chunk)
    pad = n * chunk - t
    if pin_edges:
        if pinned is None:
            padded = torch.nn.functional.pad(m, (0, pad), value=1).reshape(b, c, n, chunk)
            pinned = (padded == 0).any(dim=3).any(dim=1).any(dim=0).tolist()
        m = m.clone()
        for i in range(n):
            if pinned[i]:
                lo, hi = i * chunk, min(t, (i + 1) * chunk) - 1
                m[:, :, lo] = 0
                m[:, :, hi] = 0

    def rows(x, value):
        x = torch.nn.functional.pad(x, (0, pad), value=value).reshape(b, c, n, chunk)
        return x.permute(2, 0, 1, 3).reshape(n * b, c, chunk)

    zc, mc = rows(z, 0), rows(m, 1)
    return torch.where(mc.bool(), mask_token, zc), mc


def coarse_starts(z: torch.Tensor, m: torch.Tensor, chunk: int, mask_token: int) -> list:
    """The coarse loop's possible first inputs for one request: the port
    pins a chunk's edges where any request of its engine group keeps a step
    of that chunk, so a chunk the request keeps nothing of may come pinned
    or not."""
    n = math.ceil(z.shape[-1] / chunk)
    own = chunk_rows(z, m, chunk, mask_token, True)[0]
    pinned = chunk_rows(z, m, chunk, mask_token, True, pinned=[True] * n)[0]
    return [own] if torch.equal(own, pinned) else [own, pinned]


def n_to_mask(step: int, steps: int, n0: int, remaining: int) -> int:
    """How many positions the MaskGIT loop leaves masked after `step`: the
    cosine schedule gamma(r) = cos(r pi / 2) of N0 (fp32), and before the
    last step at least 1 and at most the remaining positions less one."""
    r = (torch.tensor(float(step), dtype=torch.float32) + 1.0) / steps
    g = torch.clamp(torch.cos(r * math.pi / 2), 1e-10, 1.0)
    k = int(torch.floor(g * torch.tensor(float(n0), dtype=torch.float32)))
    if step != steps - 1:
        k = max(min(remaining - 1, k), 1)
    return k


def typical_keep(logits: torch.Tensor, mass: float, min_tokens: int):
    """Locally typical sets (Meister et al.), upstream's sort form: per row
    of fp32 logits (..., vocab), keep the tokens whose surprisal is nearest
    the entropy until `mass` is covered, and at least `min_tokens`. Returns
    (keep, each token's distance from the entropy, the largest kept)."""
    logp = torch.log_softmax(logits, dim=-1)
    p = logp.exp()
    entropy = -(logp * p).nansum(-1, keepdim=True)
    dist = torch.abs(-logp - entropy)
    sorted_dist, order = torch.sort(dist, dim=-1)
    cum = torch.gather(p, -1, order).cumsum(-1)
    last = (cum < mass).sum(-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
    last = torch.maximum(last, torch.full_like(last, min(min_tokens, logits.shape[-1]) - 1))
    thr = torch.gather(sorted_dist, -1, last)
    return dist <= thr, dist, thr


def top_p_keep(logits: torch.Tensor, top_p: float):
    """Nucleus sets, sort form: token i is kept where the probability mass
    strictly above p_i is at most `top_p`. Returns (keep, that mass)."""
    p = torch.softmax(logits, dim=-1)
    sorted_p, order = torch.sort(p, dim=-1, descending=True)
    above_sorted = sorted_p.cumsum(-1) - sorted_p
    above = torch.empty_like(p).scatter_(-1, order, above_sorted)
    return above <= top_p, above


class Step:
    """One MaskGIT step of one row in the reference's arithmetic: the kept
    set of each position's logits (typical filter, then top-p) with each
    token's margin to its edge, the temperature-scaled scores with the
    step's Gumbel noise where the step samples, and the reference's pick.
    logits (n, vocab) fp32 over the row's flat positions (time-major, as
    the port flattens)."""

    def __init__(self, logits: torch.Tensor, key: tuple, step: int, steps: int, knobs: dict):
        n, vocab = logits.shape
        neg = torch.full_like(logits, float("-inf"))
        keep = torch.ones_like(logits, dtype=torch.bool)
        # how far inside the kept set a token lies: the least change of a
        # filter's measure that drops it (+inf where no filter is on)
        self.margin = torch.full_like(logits, float("inf"))
        self.dist = self.dist_thr = self.above = None
        if knobs["typical_filtering"]:
            keep, self.dist, self.dist_thr = typical_keep(
                logits, knobs["typical_mass"], knobs["typical_min_tokens"])
            self.margin = self.dist_thr - self.dist
        self.top_p = knobs.get("top_p")
        if self.top_p is not None:
            keep_p, self.above = top_p_keep(torch.where(keep, logits, neg), self.top_p)
            keep = keep & keep_p
            self.margin = torch.minimum(self.margin, self.top_p - self.above)
        self.keep = keep
        self.scaled = logits / max(float(knobs["temperature"]), 1e-10)
        self.log_z = torch.logsumexp(torch.where(keep, self.scaled, neg), dim=-1)
        self.sampled = step / steps <= float(knobs["sample_cutoff"])
        noise = sampler_noise(key, step, n, vocab, logits.device) if self.sampled else 0.0
        self.score = self.scaled + noise
        top2 = torch.where(keep, self.score, neg).topk(min(2, vocab), dim=-1)
        self.best, self.pick = top2.values[:, 0], top2.indices[:, 0]
        # how far outside the kept set each token lies (0 inside)
        self.excess = torch.zeros_like(logits)
        if self.dist is not None:
            self.excess += torch.clamp(self.dist - self.dist_thr, min=0.0)
        if self.above is not None:
            self.excess += torch.clamp(self.above - self.top_p, min=0.0)
        # what a different pick would take: the runner-up's deficit, the
        # pick's own margin in the kept set, or the least excess of a token
        # outside it that scores above the pick
        runner_up = top2.values[:, -1] if vocab > 1 else torch.full_like(self.best, float("inf"))
        inf = torch.full_like(logits, float("inf"))
        outside = torch.where(~keep & (self.score > self.best[:, None]), self.excess, inf)
        self.flip_cost = torch.minimum(
            torch.minimum(self.best - runner_up,
                          torch.gather(self.margin, -1, self.pick[:, None])[:, 0]),
            outside.amin(-1))

    def token_gap(self, idx: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The least error that explains each token placed at positions
        `idx` (0 for the reference's pick): over the kept tokens that score
        above it, the larger of the least of their lead and their margin in
        the kept set; and for a token outside the kept set, also how far
        outside (its distance from the entropy past the typical set's
        largest, its nucleus mass past top-p)."""
        t = tokens[:, None]
        score = self.score[idx]
        got = torch.gather(score, -1, t)
        beats = self.keep[idx] & (score > got)
        explain = torch.minimum(score - got, self.margin[idx])
        gap = torch.where(beats, explain, torch.zeros_like(explain)).amax(-1)
        return gap + torch.gather(self.excess[idx], -1, t)[:, 0]

    def confidence(self, key: tuple, step: int, steps: int, mask_temperature: float,
                   masked: torch.Tensor, tokens: Optional[torch.Tensor] = None,
                   filled: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The re-masking confidence of each position: log p of its token
        plus mask_temperature (1 - r) times the step's re-masking noise, +inf
        where the position was not masked. The token is `tokens`' where
        `filled` (a token outside the kept set counted as if kept), else the
        reference's pick."""
        tok = self.pick if tokens is None else torch.where(filled, tokens, self.pick)
        s_tok = torch.gather(self.scaled, -1, tok[:, None])[:, 0]
        in_kept = torch.gather(self.keep, -1, tok[:, None])[:, 0]
        logp = torch.where(in_kept, s_tok - self.log_z,
                           s_tok - torch.logaddexp(self.log_z, s_tok))
        r = (torch.tensor(float(step), dtype=torch.float32) + 1.0) / steps
        noise = remask_noise(key, step, masked.shape[0], masked.device)
        c = logp + float(mask_temperature) * (1.0 - float(r)) * noise
        return torch.where(masked, c, torch.full_like(c, float("inf")))


def remask(confidence: torch.Tensor, num_to_mask: int) -> torch.Tensor:
    """The positions a step masks again: confidence below the `num_to_mask`-th
    smallest (upstream's rule)."""
    cut = torch.sort(confidence).values[num_to_mask]
    return confidence < cut


def keep_gap(confidence: torch.Tensor, kept: torch.Tensor, masked_again: torch.Tensor,
             flip_cost: torch.Tensor) -> torch.Tensor:
    """The least error that explains a step's choice of which sampled
    positions to keep: over every cut, the least sum of how far each kept
    position's confidence lies below it and each position masked again lies
    above it, or, where less, what a different pick there would take
    (`flip_cost`: the port's token at a position masked again is not seen)."""
    ck, cr, fr = confidence[kept], confidence[masked_again], flip_cost[masked_again]
    if not ck.numel() or not cr.numel():
        return torch.zeros((), device=confidence.device)
    cuts = torch.cat([ck, cr, cr - fr])
    best = torch.full((), float("inf"), device=confidence.device)
    # the cost is piecewise linear in the cut, so its least is at a breakpoint
    for c in cuts[torch.isfinite(cuts)].split(256):
        c = c[:, None]
        cost = (torch.clamp(c - ck[None], min=0.0).sum(1)
                + torch.minimum(torch.clamp(cr[None] - c, min=0.0), fr[None]).sum(1))
        best = torch.minimum(best, cost.min())
    return best
