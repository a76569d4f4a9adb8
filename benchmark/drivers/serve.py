"""Web vamp requests through `VampEngine`: the driver of `"kind": "serve"` mixes.

Set-up builds the configuration's `Interface` from weights made on the
device from the seed (`Interface.from_modules`) and a `VampEngine` at the
configuration's settings, then warms every shape the mix uses: engine
groups of the mix's `warm_rows` (with top-p on and off where the mix has
both), and one request per clip length through `vamp_core_engine`, whose
encode and decode run in the caller's thread.

The window sends `vamp_core_engine` requests, each in a thread of its own
as the web app's `ThreadingHTTPServer` handles them, from `clients` client
threads that send again when a reply returns (a closed loop, which opens
the window once every client has had a reply). At the window's close no
request is sent any more; the ones in flight get `drain_s` to finish, and
one that fails or does not finish counts as failed. A traced run measures
its window untraced, then profiles `traced_seconds` more of the same load
before the clients stop.

The driver watches the port only through what it hands it: the engine
passed to `vamp_core_engine` is a proxy that records each request and its
future; the LMs' `forward_codes` and the Interface's `encode` and `decode`
are wrapped on the instances, to record each forward's input tokens (the
reference follows the MaskGIT loop step by step from them) and to open the
trace's spans.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark.harness.trace import now_ns, traced_seconds
from benchmark.harness.traffic import RequestSpec, ServeMix

PRESETS = {  # the web app's presets without a beat mask
    "timbre transfer": dict(periodic_p=2, n_mask_codebooks=1, dropout=0.0),
    "small variation": dict(periodic_p=5, n_mask_codebooks=4, dropout=0.0),
    "medium variation": dict(periodic_p=7, n_mask_codebooks=4, dropout=0.0),
    "large variation": dict(periodic_p=13, n_mask_codebooks=4, dropout=0.2),
    "unconditional": dict(periodic_p=0, n_mask_codebooks=1, dropout=0.0),
}
TYPICAL = dict(typical_filtering=True, typical_mass=0.15, typical_min_tokens=64)


@dataclasses.dataclass
class Done:
    spec: RequestSpec
    t_sent: float  # perf_counter seconds
    t_done: float = 0.0
    ok: bool = False
    error: str = ""
    variations: Optional[list] = None  # [(sr, samples)]


class EngineProxy:
    """What `vamp_core_engine` sees as its engine: submits to the real one
    and records (request id, VampRequest, future)."""

    def __init__(self, engine):
        self.engine = engine
        self.local = threading.local()
        self.log: List[tuple] = []
        self._lock = threading.Lock()

    def submit(self, req):
        fut = self.engine.submit(req)
        with self._lock:
            self.log.append((getattr(self.local, "rid", None), req, fut))
        return fut


class Recorder:
    """Each LM forward's (lm, time, input tokens as int16 on the device)."""

    def __init__(self, iface, trace):
        import torch

        self.calls: List[tuple] = []
        for tag, lm in (("coarse", iface.coarse), ("c2f", iface.c2f)):
            orig = lm.forward_codes

            def wrapped(codes, *a, _orig=orig, _tag=tag, **kw):
                self.calls.append((_tag, now_ns(), codes.to(torch.int16)))
                with trace.span("lm." + _tag):
                    return _orig(codes, *a, **kw)

            lm.forward_codes = wrapped
        for name in ("encode", "decode"):
            orig = getattr(iface, name)

            def spanned(*a, _orig=orig, _name=name, **kw):
                with trace.span("codec." + _name):
                    return _orig(*a, **kw)

            setattr(iface, name, spanned)


class Serving:
    """The system under test and everything the window recorded."""

    def __init__(self, ctx):
        import torch

        from benchmark.harness import weights
        from benchmark.reference import codec as ref_codec
        from benchmark.reference import lm as ref_lm
        from vampnet_tpu_torch.codec import CodecConfig
        from vampnet_tpu_torch.interface import Interface
        from vampnet_tpu_torch.modules import LMConfig
        from vampnet_tpu_torch.serve.engine import VampEngine

        self.ctx = ctx
        cfg = ctx.cell.config
        self.mix = ServeMix(ctx.cell.traffic, ctx.seed)
        dev = ctx.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(ctx.seed)
        codec_sd = weights.codec_state(ref_codec.param_shapes(ref_codec.config_from(cfg["codec"])),
                                       gen)
        dtype = getattr(torch, cfg["serving_dtype"])
        lms = {}
        for name in ("coarse", "c2f"):
            shapes = ref_lm.param_shapes(ref_lm.config_from(cfg[name]))
            lms[name] = {k: v.to(dtype) for k, v in weights.lm_state(shapes, gen).items()}
        ctx.log("weights made")
        codec_cfg = CodecConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in cfg["codec"].items()})
        self.iface = Interface.from_modules(
            codec_cfg, codec_sd, LMConfig(**cfg["coarse"]), lms["coarse"],
            LMConfig(**cfg["c2f"]), lms["c2f"],
            coarse_chunk_size_s=cfg["coarse_chunk_size_s"],
            coarse2fine_chunk_size_s=cfg["c2f_chunk_size_s"], device=dev)
        del codec_sd, lms
        ctx.log("interface built")
        self.sr = codec_cfg.sample_rate
        self.engine = VampEngine(self.iface, **cfg["engine"])
        self.proxy = EngineProxy(self.engine)
        self.recorder = Recorder(self.iface, ctx.trace)
        self.clips = self.mix.clip_pool(self.sr)
        ctx.log("engine started, clips made")
        self.done: List[Done] = []
        self._lock = threading.Lock()
        self.window = (0.0, 0.0)  # perf_counter seconds
        self.stats0 = self.stats1 = None
        self._warm()

    # ------------------------------------------------------------ requests

    def request_kwargs(self, spec: RequestSpec) -> dict:
        return dict(seed=spec.seed, batch_size=self.mix.variations,
                    sampling_steps=self.mix.steps, sampletemp=self.mix.temperature,
                    top_p=spec.top_p, sample_cutoff=1.0,
                    onset_mask_width=0, beat_mask_ms=0, **PRESETS[spec.preset], **TYPICAL)

    def serve_one(self, spec: RequestSpec) -> Done:
        from vampnet_tpu_torch.serve.webapp import vamp_core_engine

        d = Done(spec, time.perf_counter())
        with self._lock:  # recorded at once: one that never returns counts as failed
            self.done.append(d)
        self.proxy.local.rid = spec.rid
        try:
            res = vamp_core_engine(self.iface, self.proxy, (self.sr, self.clips[spec.clip][1]),
                                   **self.request_kwargs(spec))
            d.variations = res.variations
        except Exception as e:  # a failed request is counted, not raised
            d.error = f"{type(e).__name__}: {e}"
        d.t_done = time.perf_counter()
        d.ok = not d.error
        return d

    def _warm(self):
        """Every shape of the mix: engine groups of the mix's `warm_rows`
        (every size a group of its window takes) with each top-p setting of
        the mix, then the codec's encode (one row) and decode (a row per
        variation) at each clip length."""
        from vampnet_tpu_torch.audio import AudioSignal
        from vampnet_tpu_torch.serve.engine import VampRequest

        iface, mix = self.iface, self.mix
        t = iface.s2t(iface.coarse.chunk_size_s)
        n_cb = iface.c2f.config.n_codebooks
        codes = np.zeros((1, n_cb, t), dtype=np.int64)
        mask = np.ones((1, n_cb, t), dtype=np.int64)
        top_ps = list(dict.fromkeys(mix.top_p))
        rows = [int(r) for r in self.ctx.cell.traffic["warm_rows"]]
        sizes = [(bs, top_ps[0]) for bs in rows] + [(rows[-1], p) for p in top_ps[1:]]
        for bs, top_p in sizes:
            futs = [self.engine.submit(VampRequest(
                codes=codes, mask=mask, seed=i + 1, sampling_steps=mix.steps, top_p=top_p,
                **TYPICAL)) for i in range(bs)]
            for f in futs:
                f.result()
        self.ctx.log(f"warmed engine groups of {rows} rows")
        for k, clip_s in enumerate(mix.clip_s):
            sig = AudioSignal(self.clips[k * mix.clips_per_length][1], self.sr)
            z = iface.encode(sig).cpu().numpy()
            iface.decode(np.repeat(z, mix.variations, axis=0))
        self.ctx.log(f"warmed the codec at {len(mix.clip_s)} clip lengths")

    # ------------------------------------------------------------ window

    def run_window(self, seconds: float, trace) -> float:
        """The closed loop's window; returns the perf_counter time it opened
        at. A traced run then profiles `traced_seconds` more of the same
        load."""
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
        """The requests sent in the window."""
        t0, t1 = self.window
        return [d for d in self.done if t0 <= d.t_sent < t1]

    def attempted_failed(self):
        """Requests sent in the window, and those of them that failed or
        never came back within `drain_s` of the clients' stop."""
        sent = self.in_window()
        return len(sent), sum(1 for d in sent if not d.ok)

    def credited(self, ta: float, tb: float) -> List[tuple]:
        """(request, share) of every finished request whose time from send
        to reply overlaps [ta, tb): the share of that time inside it (1 for
        a request sent and answered inside)."""
        out = []
        for d in self.done:
            if d.ok:
                inside = min(d.t_done, tb) - max(d.t_sent, ta)
                if inside > 0:
                    out.append((d, inside / max(d.t_done - d.t_sent, 1e-9)))
        return out

    def audio_rate(self, ta: float, tb: float) -> float:
        """Seconds of audio returned per second over [ta, tb): each request's
        clip seconds x variations, credited by its share inside."""
        audio = sum(share * d.spec.clip_s * self.mix.variations
                    for d, share in self.credited(ta, tb))
        return audio / (tb - ta)

    def end_to_end(self) -> Dict[str, float]:
        """audio_s_per_s: the audio returned over the whole window, divided
        by the window; a request in flight at the opening or the close
        counts by the share of its time inside."""
        return {"audio_s_per_s": self.audio_rate(*self.window)}

    def notes(self) -> Dict[str, float]:
        """Counts for the run's log: requests sent and completed in the
        window, those still in flight at the close, rows per engine group;
        in a traced run the audio rate while the profiler ran (against the
        window's, its host cost)."""
        t0, t1 = self.window
        sent = self.in_window()
        out = {"requests_sent": len(sent),
               "requests_completed": sum(1 for d in self.done if d.ok and t0 <= d.t_done < t1),
               "in_flight_at_close": sum(1 for d in sent if not d.ok or d.t_done >= t1)}
        if self.stats1:
            d = {k: self.stats1[k] - self.stats0[k] for k in self.stats0}
            out["rows_per_group"] = d["requests"] / max(d["batches"], 1)
        if hasattr(self, "trace_window"):
            out["audio_s_per_s_traced"] = self.audio_rate(*self.trace_window)
        errors = [d.error for d in sent if d.error]
        if errors:
            out["errors"] = errors[:3]
        return out

    def forwards_between(self, t0_ns: int, t1_ns: int) -> List[tuple]:
        """(lm, rows, tokens) of each LM forward started between the two times."""
        return [(tag, c.shape[0], c.shape[2]) for tag, at, c in self.recorder.calls
                if t0_ns <= at < t1_ns]

    def release(self):
        """Close the engine and free the models (the reference runs next)."""
        import gc

        import torch

        self.engine.close()
        for th in getattr(self, "stragglers", []):
            th.join(timeout=60)
        self.iface = self.engine = None
        self.proxy.engine = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def setup(ctx) -> Serving:
    return Serving(ctx)


def _sleep_until(t: float) -> None:
    rest = t - time.perf_counter()
    if rest > 0:
        time.sleep(rest)
