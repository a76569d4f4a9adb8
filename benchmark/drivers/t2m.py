"""Text-to-music requests through `VampEngine`: the driver of `"kind": "t2m"`
mixes (MAGNeT, `vampnet_tpu_torch/magnet.py`).

Set-up builds the configuration's `MagnetInterface` from weights made on
the device from the seed (the LM by `weights.lm_state`, T5 by
`reference/magnet.t5_state`, both stored in their compute dtype; the codec
by `reference/magnet.codec_state`, fp32) and
a `VampEngine` serving it at the configuration's engine settings, then warms
every shape the mix uses: engine groups of each of the mix's `warm_rows`,
with one decoding step a stage (the stage loop's shapes do not depend on
the number of steps), at the mix's text grid.

The window sends `MagnetRequest`s from `clients` client threads, each
sending its next request when the last returns (a closed loop; the window
opens once every client has had a reply). A request asks for `seconds` of
audio (`samples` of them) from a text of `text_tokens` T5 ids drawn from the
seed (ids 2 to 32,127, then T5's end-of-text id 1), with the mix's sampling
settings and a seed of its own. At the window's close no request is sent
any more; the ones in flight get `drain_s` to finish, and one that fails or
does not finish counts as failed. A traced run measures its window
untraced, then profiles `traced_seconds` more of the same load.

The driver watches the port through what it hands it: the interface's
`encode_text`, its LM's `forward` and its `decode` are wrapped on the
instances, to record each group's text and conditioning, each forward's
stage and input tokens (and, at the mix's `logit_steps`, its logits), and
to open the trace's spans (`t5`, `lm.s<stage>`, `codec.decode`). The engine
runs a group's work on one stream in order, so the readers tie each kernel
that no span holds (those launched outside any torch operator: the
attention and sampler kernels) to the span of the kernel before it
(`benchmark/roofline_magnet.py`).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark.harness.trace import now_ns, traced_seconds
from benchmark.harness.traffic import _rng

T5_EOS = 1
T5_FIRST_WORD = 2
WARM_CLIENT = 10 ** 6  # the warm-up's requests: a client index no window uses


@dataclasses.dataclass
class T2MSpec:
    rid: int
    client: int
    text: np.ndarray
    seed: int


@dataclasses.dataclass
class Done:
    spec: T2MSpec
    t_sent: float
    t_done: float = 0.0
    ok: bool = False
    error: str = ""
    result: Optional[tuple] = None  # (codes (1, n_q, t), audio (1, 1, n))


class T2MMix:
    """The request mix of a `t2m` traffic file, drawn from the seed."""

    def __init__(self, traffic: dict, t5_vocab: int, seed: int):
        self.t = traffic
        self.seed = int(seed)
        self.vocab = t5_vocab
        arrival = traffic["arrival"]
        if arrival["process"] != "closed":
            raise ValueError(f"unknown arrival process {arrival['process']!r}")
        self.clients = int(arrival["clients"])
        self.seconds = float(traffic["seconds"])
        self.samples = int(traffic["samples"])
        self.lo, self.hi = (int(x) for x in traffic["text_tokens"])

    def closed(self, client: int, k: int) -> T2MSpec:
        rng = _rng(self.seed, 8, client, k)
        n = int(rng.integers(self.lo, self.hi + 1))
        words = rng.integers(T5_FIRST_WORD, self.vocab, size=n - 1)
        return T2MSpec(client * 1_000_000 + k, client, np.append(words, T5_EOS).astype(np.int64),
                       int(rng.integers(1, 2 ** 31 - 1)))

    def request(self, spec: T2MSpec, sample: int = 0):
        from vampnet_tpu_torch.serve.engine import MagnetRequest

        r = self.t["request"]
        return MagnetRequest(text_ids=spec.text, seconds=self.seconds,
                             seed=(spec.seed + sample) & 0xFFFFFFFF, top_p=r["top_p"],
                             temperature=r["temperature"], max_cfg_coef=r["max_cfg_coef"],
                             min_cfg_coef=r["min_cfg_coef"],
                             decoding_steps=tuple(r["decoding_steps"]))


class Recorder:
    """Per group, in the dispatcher's order: the text (ids, mask, the
    port's conditioning), then each forward (stage, step in its stage,
    input tokens as int16, logits as bf16 where the step is one of
    `logit_steps`, the time it was called)."""

    def __init__(self, iface, trace, logit_steps: Dict[int, List[int]]):
        import torch

        self.groups: List[dict] = []
        self.logit_steps = logit_steps
        self._stage, self._step = None, 0
        encode, forward, decode = iface.encode_text, iface.lm.forward, iface.decode
        dtype = iface.lm.config.dtype  # the head's output dtype: the logits kept exactly

        def encode_text(ids, mask):
            with trace.span("t5"):
                c = encode(ids, mask)
            self.groups.append(dict(at=now_ns(), ids=ids.cpu(), mask=mask.cpu(), c=c.clone(),
                                    forwards=[]))
            self._stage = None
            return c

        def lm_forward(codes, stage, kv):
            if stage != self._stage:
                self._stage, self._step = stage, 0
            else:
                self._step += 1
            with trace.span(f"lm.s{stage}"):
                out = forward(codes, stage, kv)
            keep = self._step in self.logit_steps.get(stage, ())
            self.groups[-1]["forwards"].append(
                (stage, self._step, codes.to(torch.int16), out.to(dtype) if keep else None,
                 now_ns()))
            return out

        def decode_codes(codes):
            with trace.span("codec.decode"):
                return decode(codes)

        iface.encode_text, iface.lm.forward, iface.decode = encode_text, lm_forward, decode_codes


class T2M:
    """The system under test and everything the window recorded."""

    def __init__(self, ctx):
        import torch

        from benchmark.harness import weights
        from benchmark.reference import magnet as ref
        from vampnet_tpu_torch.codec.encodec import EncodecConfig
        from vampnet_tpu_torch.magnet import MagnetInterface
        from vampnet_tpu_torch.modules.magnet import MagnetConfig, T5Config
        from vampnet_tpu_torch.serve.engine import VampEngine

        self.ctx = ctx
        cfg, traffic = ctx.cell.config, ctx.cell.traffic
        self.mix = T2MMix(traffic, cfg["t5"]["vocab_size"], ctx.seed)
        dev = ctx.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(ctx.seed)
        t5_cfg, lm_cfg = T5Config(**cfg["t5"]), MagnetConfig(**cfg["lm"])
        t5 = {k: v.to(t5_cfg.dtype) for k, v in ref.t5_state(cfg["t5"], gen).items()}
        lm = {k: v.to(lm_cfg.dtype) for k, v in
              weights.lm_state(ref.lm_shapes(cfg["lm"]), gen).items()}
        codec = ref.codec_state(ref.codec_shapes(cfg["codec"]), gen)
        ctx.log("weights made")
        codec_cfg = EncodecConfig(**{k: tuple(v) if isinstance(v, list) else v
                                     for k, v in cfg["codec"].items()
                                     if k in EncodecConfig.__dataclass_fields__})
        self.iface = MagnetInterface.from_modules(t5_cfg, t5, lm_cfg, lm, codec_cfg, codec,
                                                  text_bucket=cfg["text_bucket"], device=dev)
        del t5, lm, codec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ctx.log("interface built")
        self.frames = self.iface.frames(self.mix.seconds)
        self.engine = VampEngine(None, magnet=self.iface, **cfg["engine"])
        steps = {int(k): [int(s) for s in v] for k, v in traffic["logit_steps"].items()}
        self.recorder = Recorder(self.iface, ctx.trace, steps)
        self.log: List[tuple] = []  # (rid, sample, request, future)
        self.done: List[Done] = []
        self._lock = threading.Lock()
        self.window = (0.0, 0.0)
        self.stats0 = self.stats1 = None
        self._warm()

    def _warm(self):
        """Engine groups of each of `warm_rows`, one step a stage, at the
        mix's duration and text grid."""
        rows = [int(r) for r in self.ctx.cell.traffic["warm_rows"]]
        for n in rows:
            reqs = [dataclasses.replace(self.mix.request(self.mix.closed(WARM_CLIENT, i)),
                                        decoding_steps=(1,) * 4) for i in range(n)]
            futs = [self.engine.submit(r) for r in reqs]
            for f in futs:
                f.result()
        self.recorder.groups.clear()
        self.ctx.log(f"warmed engine groups of {rows} rows")

    # ------------------------------------------------------------ window

    def serve_one(self, spec: T2MSpec) -> Done:
        d = Done(spec, time.perf_counter())
        with self._lock:
            self.done.append(d)
        try:
            futs = []
            for s in range(self.mix.samples):
                req = self.mix.request(spec, s)
                fut = self.engine.submit(req)
                with self._lock:
                    self.log.append((spec.rid, s, req, fut))
                futs.append(fut)
            results = [f.result() for f in futs]
            d.result = results[0] if len(results) == 1 else results
        except Exception as e:  # a failed request is counted, not raised
            d.error = f"{type(e).__name__}: {e}"
        d.t_done = time.perf_counter()
        d.ok = not d.error
        return d

    def run_window(self, seconds: float, trace) -> float:
        n = self.mix.clients
        stop = threading.Event()
        replies = [0] * n

        def client(ci):
            k = 0
            while not stop.is_set():
                d = self.serve_one(self.mix.closed(ci, k))
                k += 1
                replies[ci] += 1
                if not d.ok:
                    return

        threads = [threading.Thread(target=client, args=(ci,), daemon=True) for ci in range(n)]
        for th in threads:
            th.start()
        deadline = time.perf_counter() + self.ctx.cell.traffic["drain_s"]
        while min(replies) < 1 and time.perf_counter() < deadline:
            time.sleep(0.01)
        self.ctx.log("every client has had a reply")
        self.stats0 = dict(self.engine.stats)
        t0 = time.perf_counter()
        _sleep_until(t0 + seconds)
        t1 = time.perf_counter()
        self.stats1 = dict(self.engine.stats)
        self.window = (t0, t1)
        if trace.enabled:
            trace.start()
            ts, ts_ns = time.perf_counter(), now_ns()
            _sleep_until(ts + traced_seconds(seconds))
            self.trace_window = (ts, time.perf_counter())
            trace.mark(ts_ns, now_ns())
            trace.stop()
        stop.set()
        deadline = time.perf_counter() + self.ctx.cell.traffic["drain_s"]
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.perf_counter()))
        self.stragglers = [th for th in threads if th.is_alive()]
        return t0

    # ------------------------------------------------------------ results

    def in_window(self) -> List[Done]:
        t0, t1 = self.window
        return [d for d in self.done if t0 <= d.t_sent < t1]

    def attempted_failed(self):
        sent = self.in_window()
        return len(sent), sum(1 for d in sent if not d.ok)

    def credited(self, ta: float, tb: float) -> List[tuple]:
        """(request, share) of every finished request whose time from send
        to reply overlaps [ta, tb), by the share of that time inside."""
        out = []
        for d in self.done:
            if d.ok:
                inside = min(d.t_done, tb) - max(d.t_sent, ta)
                if inside > 0:
                    out.append((d, inside / max(d.t_done - d.t_sent, 1e-9)))
        return out

    def audio_rate(self, ta: float, tb: float) -> float:
        audio = sum(share * self.mix.seconds * self.mix.samples
                    for _d, share in self.credited(ta, tb))
        return audio / (tb - ta)

    def end_to_end(self) -> Dict[str, float]:
        """audio_s_per_s: the audio returned over the window, each request
        credited by the share of its time inside."""
        return {"audio_s_per_s": self.audio_rate(*self.window)}

    def notes(self) -> Dict[str, float]:
        t0, t1 = self.window
        sent = self.in_window()
        out = {"requests_sent": len(sent),
               "requests_completed": sum(1 for d in self.done if d.ok and t0 <= d.t_done < t1),
               "in_flight_at_close": sum(1 for d in sent if not d.ok or d.t_done >= t1)}
        if self.stats1:
            dd = {k: self.stats1[k] - self.stats0[k] for k in self.stats0}
            out["rows_per_group"] = dd["magnet_rows"] / max(dd["batches"], 1)
            out["cfg_rows"] = dd["cfg_rows"]
        if hasattr(self, "trace_window"):
            out["audio_s_per_s_traced"] = self.audio_rate(*self.trace_window)
        errors = [d.error for d in sent if d.error]
        if errors:
            out["errors"] = errors[:3]
        return out

    def forwards_between(self, t0_ns: int, t1_ns: int):
        """(stage, rows, frames, text length) of each LM forward called
        between the two times."""
        return [(stage, x.shape[0], x.shape[-1], g["ids"].shape[1])
                for g in self.recorder.groups for stage, _i, x, _lg, at in g["forwards"]
                if t0_ns <= at < t1_ns]

    def release(self):
        import gc

        import torch

        self.engine.close()
        for th in getattr(self, "stragglers", []):
            th.join(timeout=60)
        self.iface = self.engine = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def setup(ctx) -> T2M:
    return T2M(ctx)


def _sleep_until(t: float) -> None:
    rest = t - time.perf_counter()
    if rest > 0:
        time.sleep(rest)
