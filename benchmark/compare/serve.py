"""What decides `correct` in a serving cell.

Once the window has closed:

  * encode: every request finished in the window; the reference encodes
    each clip (fp32, TF32 off), and the share of the 14 x T codes that
    differ from the ones the port handed the engine is read
    (`encode_code_mismatch`, exact: the port's encode matches bit for bit);
  * mask: the reference builds each such request's mask from its seed and
    preset (`mask_mismatch`, exact);
  * the MaskGIT loops, on a sample of the finished requests drawn from the
    seed, the longest among them: each variation's rows are found among the
    LMs' recorded forward inputs (coarse, then its coarse-to-fine chunks).
    The first input must be the request's codes and mask cut into the LM's
    rows (`start_mismatch`, exact; a chunk's edges pinned or not where the
    request keeps none of it, as its engine group decides). At each step
    the reference runs its own fp32 LM over the port's input of that step
    and samples it itself with the row's replayed random draws
    (`reference/sampling.py`): its typical and top-p sets, the temperature,
    the sampler's Gumbel noise, and the re-masking's noise. Each token the
    step placed is judged by the least error that explains it where it is
    not the reference's pick (`Step.token_gap`: a kept token's lead over it,
    or that token's margin in the kept set, and how far outside the kept
    set the token lies), and the step's choice of which positions to keep
    likewise (`keep_gap`: over every cut of the reference's confidences,
    the least sum of how far positions lie on its wrong side); the means
    over the positions are compared
    (`lm_mean_gap_*`, `keep_mean_gap_*`) and the
    widest token gap and the share of tokens that differ from the
    reference's pick are reported beside them. The reference follows the
    port's own states step by step. Besides: a step changes no position
    already filled (`kept_changed`), leaves masked the number the cosine
    schedule gives, or up to two fewer where confidences tie at the cut
    (`schedule_mismatch`), and the served codes hold no MASK (`unfilled`);
  * decode: the reference decodes the sampled requests' served codes and
    matches their loudness to the input's, and the relative l2 distance to
    the port's audio is read (`decode_rel_err`).

`missing` counts the sampled variations whose rows were not found, and
`failed` the requests of the window that failed or never came.

The controls read the same numbers with the reference put in the port's
place one precision down (`readings(control=...)`): the codec with TF32 on,
and the LMs through the port's own int8 path (`Interface.quantize()`, w8a8;
`int8_side`), whose tokens and keep choices on the same states, sampled
with the same draws, are judged the same way.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import audio as ref_audio
from benchmark.reference import codec as ref_codec
from benchmark.reference import lm as ref_lm
from benchmark.reference import sampling as ref_s

EXACT = ("mask_mismatch", "start_mismatch", "kept_changed", "schedule_mismatch", "unfilled",
         "missing", "failed")
TIE_SHORTFALL = 2
C2F_STEPS = 2  # the coarse-to-fine loop's steps (`Interface.coarse_to_fine`'s default)
C2F_SEED_OFFSET = 0x9E3779B9  # the engine's coarse-to-fine seed: the request's plus this


class Trajectory:
    """One variation's row in one LM's recorded forward inputs: states
    (steps, C, chunk) int64, the final served tokens, which of their
    positions are known (the served codes stop at the request's length),
    the row's key and the request's sampling settings."""

    def __init__(self, lm: str, states, final, known, ncc: int, key: tuple, knobs: dict):
        self.lm, self.states, self.final, self.known, self.ncc = lm, states, final, known, ncc
        self.key, self.knobs = key, knobs


def knobs_of(req, steps: int) -> dict:
    """A request's sampling settings as the engine hands them to both LMs."""
    return dict(steps=steps, temperature=req.temperature, top_p=req.top_p,
                sample_cutoff=req.sample_cutoff, mask_temperature=req.mask_temperature,
                typical_filtering=req.typical_filtering, typical_mass=req.typical_mass,
                typical_min_tokens=req.typical_min_tokens)


def _segments(calls) -> List[tuple]:
    """Consecutive forwards of one LM: [(lm, [codes, ...])] (one engine group each)."""
    out = []
    for tag, _at, codes in calls:
        if out and out[-1][0] == tag:
            out[-1][1].append(codes)
        else:
            out.append((tag, [codes]))
    return out


def _pad(x: np.ndarray, t: int, value: int) -> np.ndarray:
    return np.pad(x, ((0, 0), (0, 0), (0, t - x.shape[-1])), constant_values=value)


def sample_requests(sv, rng: np.random.Generator, n: int):
    """Up to n requests sent in the window and finished: the longest clip
    first, the rest drawn."""
    t0, t1 = sv.window
    pool = [d for d in sv.done if d.ok and t0 <= d.t_sent < t1]
    if not pool:
        return []
    pool.sort(key=lambda d: d.spec.rid)
    longest = max(pool, key=lambda d: d.spec.clip_s)
    rest = [d for d in pool if d is not longest]
    pick = [rest[i] for i in rng.permutation(len(rest))[:max(0, n - 1)]]
    return [longest] + pick


def trajectories(req, served: np.ndarray, segments, cfg) -> Optional[List[Trajectory]]:
    """The variation's coarse trajectory (a request of one coarse chunk)
    and its coarse-to-fine chunk rows, found by their first input (and,
    among a request's variations, by the served coarse tokens); None where
    they are missing."""
    dev = segments[0][1][0].device if segments else "cpu"
    mask_tok = cfg["coarse"]["vocab_size"]
    sr, hop = cfg["codec"]["sample_rate"], math.prod(cfg["codec"]["encoder_rates"])
    t_coarse = math.ceil(cfg["coarse_chunk_size_s"] * sr / hop)
    t_c2f = math.ceil(cfg["c2f_chunk_size_s"] * sr / hop)
    n_co = cfg["coarse"]["n_codebooks"]
    ncc = cfg["c2f"]["n_conditioning_codebooks"]
    length = req.codes.shape[-1]
    bucket = math.ceil(length / t_coarse) * t_coarse
    codes = torch.from_numpy(_pad(req.codes, bucket, 0)).to(dev)
    mask = torch.from_numpy(_pad(req.mask, bucket, 1)).to(dev)
    served_t = torch.from_numpy(served).to(dev)
    starts = [z.to(torch.int16) for z in
              ref_s.coarse_starts(codes[:, :n_co], mask[:, :n_co], t_coarse, mask_tok)]
    pos = torch.arange(bucket, device=dev)
    known = pos < length
    out = []
    # coarse: the row whose first input is z0 and whose last input agrees
    # with the served coarse tokens wherever it is filled
    found = None
    for lm, calls in segments:
        if lm != "coarse" or calls[0].shape[1:] != starts[0].shape[1:]:
            continue
        hit = torch.zeros(calls[0].shape[0], dtype=torch.bool, device=dev)
        for z0 in starts:
            hit |= (calls[0] == z0).flatten(1).all(1)
        rows = hit.nonzero().flatten().tolist()
        for r in rows:
            last = calls[-1][r].long()
            filled = (last != mask_tok) & known[None, :]
            if bool((last[:, :length] == served_t[0, :n_co])[filled[:, :length]].all()):
                found = (calls, r)
                break
        if found:
            break
    if found is None:
        return None
    calls, r = found
    final = torch.full((n_co, bucket), mask_tok, dtype=torch.long, device=dev)
    final[:, :length] = served_t[0, :n_co]
    seed = int(req.seed) & 0xFFFFFFFF
    steps = {"coarse": int(req.sampling_steps), "c2f": C2F_STEPS}
    out.append(Trajectory("coarse", torch.stack([c[r].long() for c in calls]), final,
                          known[None, :].expand(n_co, bucket), 0, ref_s.row_key(seed),
                          knobs_of(req, steps["coarse"])))
    # coarse to fine: chunk rows whose known conditioning is the served
    # coarse tokens and whose fine codebooks are the request's, masked
    n_cb = served.shape[1]
    z = torch.cat([final, codes[0, n_co:]], dim=0)[None]
    m = mask.clone()
    m[:, :ncc] = 0
    zc, _ = ref_s.chunk_rows(z, m, t_c2f, mask_tok, False)
    n_chunks = zc.shape[0]
    k_pad = math.ceil(bucket / t_c2f) * t_c2f
    kc = torch.nn.functional.pad(known, (0, k_pad - bucket), value=True)
    kc = kc.reshape(n_chunks, t_c2f)
    # positions past the bucket are padding (known); conditioning past the
    # request's length is the coarse loop's and unknown here
    for lm, calls in segments:
        if lm != "c2f" or calls[0].shape[1:] != zc.shape[1:] or calls[0].shape[0] % n_chunks:
            continue
        b = calls[0].shape[0] // n_chunks
        first = calls[0].long().reshape(n_chunks, b, n_cb, t_c2f)
        ok = ((first == zc[:, None]) | ~kc[:, None, None, :]).flatten(2).all(2).all(0)
        rows = ok.nonzero().flatten().tolist()
        if not rows:
            continue
        j = rows[0]
        seed_c2f = (seed + C2F_SEED_OFFSET) & 0xFFFFFFFF
        for c in range(n_chunks):
            states = torch.stack([x.long().reshape(n_chunks, b, n_cb, t_c2f)[c, j] for x in calls])
            fin = torch.full((n_cb, t_c2f), mask_tok, dtype=torch.long, device=dev)
            lo, hi = c * t_c2f, min(length, (c + 1) * t_c2f)
            if hi > lo:
                fin[:, :hi - lo] = served_t[0, :, lo:hi]
            kn = (torch.arange(t_c2f, device=dev) + lo < length)[None, :].expand(n_cb, t_c2f)
            key = ref_s.row_key(seed_c2f, c if n_chunks > 1 else None)
            out.append(Trajectory("c2f", states, fin, kn, ncc, key, knobs_of(req, steps["c2f"])))
        return out
    return None


def _flat(x):
    """(C, t) -> (t * C,): the port's flat order of a row's positions."""
    return x.transpose(0, 1).reshape(-1)


def port_side(traj: Trajectory, mask_tok: int) -> List[tuple]:
    """What the port did at each step of a trajectory, as (tokens, filled,
    masked_again) over the row's flat positions of the predicted codebooks:
    the tokens of its next state, the masked positions it filled (and, at
    the last step, whose served token is known), and those it masked again."""
    out = []
    n_steps = traj.states.shape[0]
    for s in range(n_steps):
        last = s == n_steps - 1
        inp = traj.states[s][traj.ncc:]
        nxt = (traj.final if last else traj.states[s + 1])[traj.ncc:]
        known = traj.known[traj.ncc:] if last else torch.ones_like(inp, dtype=torch.bool)
        masked = inp == mask_tok
        out.append((_flat(nxt), _flat(masked & (nxt != mask_tok) & known),
                    _flat(masked & (nxt == mask_tok))))
    return out


def step_readings(traj: Trajectory, logits, side: List[tuple], mask_tok: int) -> Dict[str, float]:
    """Walk one trajectory with the reference's logits (steps, t,
    n_predict, vocab): judge the tokens and keep choices of `side` (the
    port's, or a control's, as `port_side` gives them) against the
    reference's own sampling of each step, and make the exact checks of the
    port's states."""
    s_all = traj.states
    n_steps = s_all.shape[0]
    ncc = traj.ncc
    knobs = traj.knobs
    steps = knobs["steps"]
    n0 = int((s_all[0] == mask_tok).sum())
    acc = {"gap": 0.0, "gap_sum": 0.0, "filled": 0, "flips": 0, "keep_sum": 0.0, "keep_n": 0,
           "kept_changed": 0, "schedule_mismatch": 0}
    for s in range(n_steps):
        inp = s_all[s][ncc:]
        last = s == n_steps - 1
        nxt = traj.final if last else s_all[s + 1]
        known = traj.known if last else torch.ones_like(traj.known)
        acc["kept_changed"] += int(((inp != mask_tok) & (nxt[ncc:] != inp)
                                    & known[ncc:]).sum())
        masked = _flat(inp == mask_tok)
        remaining = int(masked.sum())
        want = ref_s.n_to_mask(s, steps, n0, remaining)
        if not last:
            left = int((nxt[ncc:] == mask_tok).sum())
            if left > want or left < want - TIE_SHORTFALL:
                acc["schedule_mismatch"] += 1
        lg = logits[s].reshape(-1, logits.shape[-1])
        st = ref_s.Step(lg, traj.key, s, steps, knobs)
        tokens, filled, masked_again = side[s]
        idx = filled.nonzero().flatten()
        if idx.numel():
            gap = st.token_gap(idx, tokens[idx])
            acc["gap"] = max(acc["gap"], float(gap.max()))
            acc["gap_sum"] += float(gap.sum())
            acc["filled"] += idx.numel()
            acc["flips"] += int((tokens[idx] != st.pick[idx]).sum())
        if not last and remaining:
            conf = st.confidence(traj.key, s, steps, knobs["mask_temperature"], masked, tokens,
                                 filled)
            acc["keep_sum"] += float(ref_s.keep_gap(conf, filled & masked, masked_again,
                                                    st.flip_cost))
            acc["keep_n"] += remaining
    acc["unfilled"] = int(((traj.final == mask_tok) & traj.known)[ncc:].sum())
    return acc


class Reference:
    """The reference's weights, made again from the seed in the driver's order."""

    def __init__(self, cfg: dict, seed: int, device):
        from benchmark.harness import weights

        ref_lm.fp32_mode()
        self.cfg = cfg
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.codec_cfg = ref_codec.config_from(cfg["codec"])
        self.codec = weights.codec_state(ref_codec.param_shapes(self.codec_cfg), gen)
        dtype = getattr(torch, cfg["serving_dtype"])
        self.lm_cfg, self.lm = {}, {}
        for name in ("coarse", "c2f"):
            c = ref_lm.config_from(cfg[name])
            self.lm_cfg[name] = c
            self.lm[name] = {k: v.to(dtype).float()
                             for k, v in weights.lm_state(ref_lm.param_shapes(c), gen).items()}
        self.codebooks = torch.stack([self.codec[f"quantizer.quantizers_{i}.codebook"]
                                      for i in range(self.codec_cfg.n_codebooks)])

    def logits(self, name: str, states):
        with torch.no_grad():
            return torch.cat([ref_lm.forward(self.lm[name], self.lm_cfg[name], s[None],
                                             self.codebooks) for s in states])

    def encode(self, clip: np.ndarray, device, tf32: bool = False):
        x = ref_audio.codec_input(clip, self.codec_cfg.sample_rate, self.codec_cfg.hop_length)
        with torch.no_grad(), _tf32(tf32):
            return ref_codec.encode(self.codec, self.codec_cfg, torch.from_numpy(x).to(device))

    def decode(self, codes: np.ndarray, device, tf32: bool = False) -> np.ndarray:
        with torch.no_grad(), _tf32(tf32):
            return ref_codec.decode(self.codec, self.codec_cfg,
                                    torch.from_numpy(codes).to(device)).cpu().numpy()


class _tf32:
    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        if self.on:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def gather(sv, ctx) -> dict:
    """Before the port's state is freed: the sampled requests, their engine
    submissions and results, and their trajectories (tokens on the device)."""
    cfg = ctx.cell.config
    n = int(ctx.cell.traffic["check_requests"])
    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed & 0xFFFFFFFFFFFFFFFF, 7]))
    segments = _segments(sv.recorder.calls)
    picked = []
    missing = 0
    for d in sample_requests(sv, rng, n):
        subs = [(req, fut.result()) for rid, req, fut in sv.proxy.log if rid == d.spec.rid]
        trajs = []
        for req, served in subs:
            t = trajectories(req, served, segments, cfg)
            if t is None:
                missing += 1
            else:
                trajs.append((req, served, t))
        picked.append((d, sv.clips[d.spec.clip][1], subs, trajs))
    # every finished request's codes and mask, as the port handed them the
    # engine (its first variation's submission)
    done = {d.spec.rid: d for d in sv.done if d.ok and d.t_sent >= sv.window[0]}
    seen, requests = set(), []
    for rid, req, _fut in sv.proxy.log:
        if rid in done and rid not in seen:
            seen.add(rid)
            requests.append((done[rid].spec, req.codes, req.mask))
    return {"picked": picked, "missing": missing + (0 if picked else 1),
            "failed": sv.attempted_failed()[1], "requests": requests,
            "clips": {spec.clip: sv.clips[spec.clip][1] for spec, _, _ in requests}}


def readings(g: dict, ctx, control: Optional[str] = None,
             control_sides: Optional[dict] = None) -> Dict[str, float]:
    """The numbers compared, from `gather`'s output, after the port is freed.
    `control`: None (the port's outputs), "tf32" (the reference's codec one
    precision down in the port's place) or "int8" (`control_sides`, what
    the port's int8 path did at each step, in the LMs' place)."""
    cfg = ctx.cell.config
    dev = ctx.device
    ref = Reference(cfg, ctx.seed, dev)
    mask_tok = cfg["coarse"]["vocab_size"]
    sr = ref.codec_cfg.sample_rate
    out = {"encode_code_mismatch": 0.0, "decode_rel_err": 0.0}
    out.update({k: 0 for k in EXACT})
    out["missing"], out["failed"] = g["missing"], g["failed"]
    from benchmark.drivers.serve import PRESETS

    # encode and mask: every request finished in the window, each clip
    # encoded once by the reference (the port's encode is a function of it)
    want_codes = {k: ref.encode(clip, dev) for k, clip in g["clips"].items()}
    if control == "tf32":
        got_codes = {k: ref.encode(clip, dev, tf32=True) for k, clip in g["clips"].items()}
    differ = total = 0
    for spec, codes, mask in g["requests"]:
        got = got_codes[spec.clip] if control == "tf32" else torch.from_numpy(codes).to(dev)
        differ += int((got != want_codes[spec.clip]).sum())
        total += got.numel()
        p = PRESETS[spec.preset]
        want_mask = ref_s.web_mask(tuple(mask.shape), p["periodic_p"], p["dropout"],
                                   p["n_mask_codebooks"], spec.seed, dev)
        out["mask_mismatch"] += int((torch.from_numpy(mask).to(dev) != want_mask).sum())
    out["encode_code_mismatch"] = differ / max(total, 1)
    lm = {k: {"gap": 0.0, "gap_sum": 0.0, "filled": 0, "flips": 0, "keep_sum": 0.0,
              "keep_n": 0} for k in ("coarse", "c2f")}
    for pi, (d, clip, subs, trajs) in enumerate(g["picked"]):
        p = PRESETS[d.spec.preset]
        want_mask = ref_s.web_mask(tuple(subs[0][0].mask.shape), p["periodic_p"], p["dropout"],
                                   p["n_mask_codebooks"], d.spec.seed, dev)
        for vi, (req, served, ts) in enumerate(trajs):
            out["start_mismatch"] += _start_mismatch(req, ts, want_mask, cfg, dev)
            for j, tr in enumerate(ts):
                side = control_sides[(pi, vi, j)] if control == "int8" else port_side(tr, mask_tok)
                r = step_readings(tr, ref.logits(tr.lm, tr.states), side, mask_tok)
                acc = lm[tr.lm]
                acc["gap"] = max(acc["gap"], r["gap"])
                for k in ("gap_sum", "filled", "flips", "keep_sum", "keep_n"):
                    acc[k] += r[k]
                for k in ("kept_changed", "schedule_mismatch", "unfilled"):
                    out[k] += r[k]
        served = np.concatenate([s for _, s in subs], axis=0)
        audio = ref.decode(served, dev)
        loud = ref_audio.loudness(clip[None, None].astype(np.float32), sr)[0]
        want = ref_audio.match_loudness(audio, sr, loud)
        if control == "tf32":
            got = ref_audio.match_loudness(ref.decode(served, dev, tf32=True), sr, loud)
        else:
            got = np.stack([v[1] for v in d.variations])[:, None, :]
        err = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))
        out["decode_rel_err"] = max(out["decode_rel_err"], err)
    for k, acc in lm.items():
        n = max(acc["filled"], 1)
        out[f"lm_mean_gap_{k}"] = acc["gap_sum"] / n
        out[f"keep_mean_gap_{k}"] = acc["keep_sum"] / max(acc["keep_n"], 1)
        out[f"lm_flip_share_{k}"] = acc["flips"] / n
        out[f"lm_widest_gap_{k}"] = acc["gap"]
        out[f"lm_tokens_{k}"] = acc["filled"]
    return out


def _start_mismatch(req, trajs, want_mask, cfg, dev) -> int:
    """Entries of the coarse loop's first input that differ from the
    request's codes under the reference's mask, cut into the LM's rows."""
    mask_tok = cfg["coarse"]["vocab_size"]
    sr, hop = cfg["codec"]["sample_rate"], math.prod(cfg["codec"]["encoder_rates"])
    t_coarse = math.ceil(cfg["coarse_chunk_size_s"] * sr / hop)
    n_co = cfg["coarse"]["n_codebooks"]
    length = req.codes.shape[-1]
    bucket = math.ceil(length / t_coarse) * t_coarse
    codes = torch.from_numpy(_pad(req.codes, bucket, 0)).to(dev)
    m = torch.nn.functional.pad(want_mask, (0, bucket - length), value=1)
    coarse = [t for t in trajs if t.lm == "coarse"][0]
    return min(int((coarse.states[0] != z0[0]).sum())
               for z0 in ref_s.coarse_starts(codes[:, :n_co], m[:, :n_co], t_coarse, mask_tok))


def int8_side(sv, g: dict, ctx) -> dict:
    """The control's steps: the port's LMs switched to their int8 path
    (`Interface.quantize()`) run over the same states, each step sampled
    with the row's replayed draws and its keep choice made by upstream's
    rule, as `port_side` gives the port's. Call before `release`."""
    from vampnet_tpu_torch.modules.transformer import position_bias_from_params

    iface = sv.iface
    iface.quantize()
    mask_tok = ctx.cell.config["coarse"]["vocab_size"]
    out = {}
    with torch.inference_mode():
        for pi, (_d, _clip, _subs, trajs) in enumerate(g["picked"]):
            for vi, (_req, _served, ts) in enumerate(trajs):
                for j, tr in enumerate(ts):
                    lm = iface.coarse if tr.lm == "coarse" else iface.c2f
                    n_cb = tr.states.shape[1]
                    bias = position_bias_from_params(lm, tr.states.shape[2])
                    n0 = int((tr.states[0] == mask_tok).sum())
                    steps = tr.knobs["steps"]
                    side = []
                    for s, state in enumerate(tr.states):
                        lg = lm.forward_codes(state[None], iface.codebooks[:n_cb],
                                              position_bias=bias).float()
                        st = ref_s.Step(lg.reshape(-1, lg.shape[-1]), tr.key, s, steps, tr.knobs)
                        masked = _flat(state[tr.ncc:] == mask_tok)
                        k = ref_s.n_to_mask(s, steps, n0, int(masked.sum()))
                        conf = st.confidence(tr.key, s, steps, tr.knobs["mask_temperature"],
                                             masked)
                        again = ref_s.remask(conf, k) & masked
                        filled = masked & ~again
                        if s == steps - 1:
                            filled &= _flat(tr.known[tr.ncc:])
                        side.append((st.pick, filled, again))
                    out[(pi, vi, j)] = side
    return out


def check(sv, ctx) -> Dict[str, float]:
    """The run's numbers: gather what the port served, free it, compare."""
    g = gather(sv, ctx)
    sv.release()
    return readings(g, ctx)
