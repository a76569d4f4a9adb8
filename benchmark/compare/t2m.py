"""What decides `correct` in a text-to-music cell (`"kind": "t2m"`).

Once the window has closed, on `check_requests` requests drawn from the seed
among those sent in the window and finished, each found in its engine group
by its text (the conditioned row r and its unconditioned row r + b):

  * T5: the reference encodes the request's text at the group's padded
    length (fp32), and the port's conditioning is compared over the text's
    positions (`t5_rel_err`, relative l2);
  * the LM: the reference runs its own fp32 LM over the port's input tokens
    of every step, conditioned and not. At the mix's `logit_steps` (step 0
    and a middle step of stage 0, with full attention, and a step of each
    banded stage) the port's logits, which the driver kept, are compared
    with the reference's: the mean absolute gap over the mean absolute
    deviation of the reference's logits from their row mean, both rows,
    every position (`lm_mean_gap_full` at stage 0, `lm_mean_gap_banded`
    after);
  * the re-masking: at every step the reference samples its own guided
    logits with the row's replayed draws (its top-p set, the annealed
    temperature and CFG coefficient, the sampler's Philox noise), scores
    each span masked at the step (the port's token's probability where the
    next state shows it, else the reference's own token's), and the port's
    choice of spans to mask again is judged by the least error that
    explains it: over every cut of the reference's scores, the least sum of
    how far chosen spans lie below it and unchosen ones above it, over the
    candidate spans (`keep_mean_gap`). Besides, exactly: the number of spans
    masked again is the schedule's (`schedule_mismatch`), no position kept
    at a step changes and a span is masked whole (`kept_changed`), the
    unconditioned row holds the conditioned row's tokens, the codebooks
    below the stage their served tokens and those above it the mask id
    (`state_mismatch`), and the served codes hold no mask id (`unfilled`);
  * the codec: the reference decodes the served codes, and the port's
    audio's relative l2 distance to it is read (`decode_rel_err`).

`missing` counts sampled requests whose group or rows were not found,
`failed` the requests of the window that failed or never came.

The controls (`benchmark/control_t2m.py`) read the same numbers with the
reference one precision down in the port's place: T5 and the LM with every
product's operands in fp8 (`reference/lm.fp8`), whose own samples and span
choices are judged the same way, and the codec in TF32.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference import lm as ref_lm
from benchmark.reference import magnet as ref_m

EXACT = ("state_mismatch", "kept_changed", "schedule_mismatch", "unfilled", "missing", "failed")


class Reference:
    """The reference's weights, made again from the seed in the driver's
    order: T5 and the LM rounded to their compute dtype and held in fp32."""

    def __init__(self, cfg: dict, seed: int, device):
        from benchmark.harness import weights

        ref_m.fp32_mode()
        self.cfg = cfg
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        t5_dt, lm_dt = (getattr(torch, cfg[k].get("compute_dtype", "bfloat16"))
                        for k in ("t5", "lm"))
        self.t5 = {k: v.to(t5_dt).float() for k, v in ref_m.t5_state(cfg["t5"], gen).items()}
        self.lm = {k: v.to(lm_dt).float() for k, v in
                   weights.lm_state(ref_m.lm_shapes(cfg["lm"]), gen).items()}
        self.codec = ref_m.codec_state(ref_m.codec_shapes(cfg["codec"]), gen)

    def encode(self, text, length: int, operand=None):
        with torch.no_grad():
            return ref_m.t5_encode(self.t5, self.cfg["t5"], text, length, operand)

    def logits(self, codes, stage: int, c, operand=None):
        with torch.no_grad():
            return ref_m.lm_logits(self.lm, self.cfg["lm"], codes, stage, c, operand)

    def decode(self, codes, tf32: bool = False):
        with torch.no_grad():
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
            try:
                return ref_m.decode(self.codec, self.cfg["codec"], codes)
            finally:
                ref_m.fp32_mode()


def _sample_requests(sv, rng, n: int):
    t0, t1 = sv.window
    pool = sorted((d for d in sv.done if d.ok and t0 <= d.t_sent < t1), key=lambda d: d.spec.rid)
    return [pool[i] for i in rng.permutation(len(pool))[:n]]


def _find(groups, text: np.ndarray, served: torch.Tensor):
    """(group, row) of a request: the row whose text and mask are the
    request's and whose last forward agrees with the served codes wherever
    it is filled."""
    l = len(text)
    want = torch.as_tensor(text)
    for g in groups:
        ids, mask = g["ids"], g["mask"]
        if ids.shape[1] < l or not g["forwards"]:
            continue
        for r in range(ids.shape[0]):
            if int(mask[r].sum()) != l or not bool((ids[r, :l] == want).all()):
                continue
            last = g["forwards"][-1][2][r].long()
            filled = last != g["mask_id"]
            if bool((last[filled] == served.to(last.device)[filled]).all()):
                return g, r
    return None, None


def gather(sv, ctx) -> dict:
    """Before the port is freed: the sampled requests' texts, knobs,
    conditioning, every step's input rows and kept logits, served codes
    and audio (on the device)."""
    n = int(ctx.cell.traffic["check_requests"])
    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed & 0xFFFFFFFFFFFFFFFF, 7]))
    mask_id = ctx.cell.config["lm"]["card"]
    groups = sv.recorder.groups
    for g in groups:
        g["mask_id"] = mask_id
    reqs = {(rid, s): req for rid, s, req, _ in sv.log}
    picked, missing = [], 0
    for d in _sample_requests(sv, rng, n):
        codes, audio = d.result
        served = torch.as_tensor(codes[0])
        g, r = _find(groups, d.spec.text, served)
        if g is None:
            missing += 1
            continue
        b = g["ids"].shape[0]
        steps = [(stage, i, x[r].long(), x[r + b].long(), None if lg is None
                  else torch.stack([lg[r], lg[r + b]]).float())
                 for stage, i, x, lg, _at in g["forwards"]]
        picked.append(dict(text=d.spec.text, length=g["ids"].shape[1], req=reqs[(d.spec.rid, 0)],
                           c=g["c"][r].float(), steps=steps, served=served.to(sv.ctx.device),
                           audio=torch.as_tensor(audio[0, 0])))
    return {"picked": picked, "missing": missing + (0 if picked else 1),
            "failed": sv.attempted_failed()[1]}


def keep_gap(scores: torch.Tensor, chosen: torch.Tensor) -> float:
    """The least error that explains a choice of the highest scores: over
    every cut, the least sum of how far each chosen score lies below it and
    each unchosen one above it."""
    sc, su = scores[chosen], scores[~chosen]
    if not sc.numel() or not su.numel():
        return 0.0
    cuts = scores[:, None]
    cost = (torch.clamp(cuts - sc[None], min=0).sum(1) + torch.clamp(su[None] - cuts, min=0).sum(1))
    return float(cost.min())


def knobs_of(req) -> dict:
    return dict(top_p=req.top_p, temperature=req.temperature, max_cfg_coef=req.max_cfg_coef,
                min_cfg_coef=req.min_cfg_coef)


def _choose(scores: torch.Tensor, n: int) -> torch.Tensor:
    """The n highest scores, ties to the lower index (the port's rule)."""
    order = torch.sort(scores, descending=True, stable=True).indices
    return torch.zeros_like(scores, dtype=torch.bool).scatter(0, order[:n], True)


def readings(g: dict, ctx, control: Optional[str] = None) -> Dict[str, float]:
    """The numbers compared, from `gather`'s output, after the port is
    freed. `control`: None (the port's outputs), "fp8" (T5's and the LM's
    outputs and span choices from the reference with fp8 operands) or
    "tf32" (the codec's audio from the reference in TF32)."""
    cfg = ctx.cell.config
    lmc = cfg["lm"]
    mask_id = lmc["card"]
    ref = Reference(cfg, ctx.seed, ctx.device)
    fp8 = ref_lm.fp8 if control == "fp8" else None
    out = {k: 0 for k in EXACT}
    out["missing"], out["failed"] = g["missing"], g["failed"]
    acc = dict(t5_num=0.0, t5_den=0.0, full=[0.0, 0.0], banded=[0.0, 0.0], keep_sum=0.0,
               keep_n=0, flips=0, filled=0, dec=0.0)
    for p in g["picked"]:
        req = p["req"]
        knobs = knobs_of(req)
        span = ref_m.SPAN
        l = len(p["text"])
        c_ref = ref.encode(p["text"], p["length"])
        c_side = ref.encode(p["text"], p["length"], fp8) if fp8 else p["c"]
        acc["t5_num"] += float((c_side[:l] - c_ref[:l]).pow(2).sum())
        acc["t5_den"] += float(c_ref[:l].pow(2).sum())
        zero = torch.zeros_like(c_ref)
        served = p["served"]
        steps = p["steps"]
        n_steps = {s: sum(1 for x in steps if x[0] == s) for s in range(lmc["n_q"])}
        for j, (stage, i, x, xu, port_logits) in enumerate(steps):
            n = n_steps[stage]
            t = x.shape[-1]
            n_spans = t // span
            out["state_mismatch"] += int((xu != x).sum()) + int((x[stage + 1:] != mask_id).sum()) \
                + int((x[:stage] != served[:stage]).sum())
            cond, uncond = ref.logits(x, stage, c_ref), ref.logits(x, stage, zero)
            if fp8 is not None:
                side_c = ref.logits(x, stage, c_side, fp8)
                side_u = ref.logits(x, stage, torch.zeros_like(c_side), fp8)
            if port_logits is not None:
                want = torch.stack([cond, uncond])
                got = torch.stack([side_c, side_u]) if fp8 is not None else port_logits
                dev = (want - want.mean(-1, keepdim=True)).abs().sum()
                a = acc["full" if stage == 0 else "banded"]
                a[0] += float((got - want).abs().sum())
                a[1] += float(dev)
            step_id = sum(n_steps[s] for s in range(stage)) + i
            noise = ref_m.gumbel(req.seed, step_id, t, lmc["card"], x.device)
            tok, _keep, probs = ref_m.sample(ref_m.guided(cond, uncond, i, n, knobs), noise,
                                             knobs["top_p"])
            now = x[stage] == mask_id
            nxt = steps[j + 1][2][stage] if i < n - 1 else served[stage]
            if fp8 is not None:  # the control's own tokens and choice
                tok8, _, probs8 = ref_m.sample(ref_m.guided(side_c, side_u, i, n, knobs), noise,
                                               knobs["top_p"])
                chosen = _choose(ref_m.span_scores(probs8.gather(-1, tok8[:, None])[:, 0], span)
                                 .where(now.reshape(n_spans, span).all(-1),
                                        torch.tensor(ref_m.KEEP_SCORE, device=x.device)),
                                 ref_m.n_masked(i + 1, n, n_spans) if i < n - 1 else 0)
                nxt = torch.where(now, tok8, x[stage])
                if i < n - 1:
                    nxt = torch.where(chosen.repeat_interleave(span), mask_id, nxt)
            out["kept_changed"] += int((~now & (nxt != x[stage])).sum())
            filled = now & (nxt != mask_id)
            acc["flips"] += int((filled & (nxt != tok)).sum())
            acc["filled"] += int(filled.sum())
            if i < n - 1:
                again = (nxt == mask_id).reshape(n_spans, span)
                out["kept_changed"] += int((again.any(-1) & ~again.all(-1)).sum())
                chosen = again.all(-1)
                if int(chosen.sum()) != ref_m.n_masked(i + 1, n, n_spans):
                    out["schedule_mismatch"] += 1
                cand = now.reshape(n_spans, span).all(-1)
                seen = torch.where(filled, nxt, tok)  # the port's token where it shows
                scores = ref_m.span_scores(probs.gather(-1, seen[:, None])[:, 0], span)
                acc["keep_sum"] += keep_gap(scores[cand], chosen[cand])
                acc["keep_n"] += int(cand.sum())
        out["unfilled"] += int((served == mask_id).sum())
        want = torch.stack([ref.decode(served)])
        got = torch.stack([ref.decode(served, tf32=True)]) if control == "tf32" \
            else p["audio"].to(want.device)[None]
        acc["dec"] = max(acc["dec"], float((got - want).norm() / want.norm().clamp(min=1e-12)))
    out["t5_rel_err"] = (acc["t5_num"] / max(acc["t5_den"], 1e-30)) ** 0.5
    out["lm_mean_gap_full"] = acc["full"][0] / max(acc["full"][1], 1e-30)
    out["lm_mean_gap_banded"] = acc["banded"][0] / max(acc["banded"][1], 1e-30)
    out["keep_mean_gap"] = acc["keep_sum"] / max(acc["keep_n"], 1)
    out["decode_rel_err"] = acc["dec"]
    out["lm_flip_share"] = acc["flips"] / max(acc["filled"], 1)
    out["lm_tokens"] = acc["filled"]
    return out


def check(sv, ctx) -> Dict[str, float]:
    """The run's numbers: gather what the port served, free it, compare."""
    g = gather(sv, ctx)
    sv.release()
    return readings(g, ctx)
