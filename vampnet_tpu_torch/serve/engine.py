"""Continuous-batching vamp engine (counterpart of
`vampnet_tpu/serve/engine.py`).

Concurrent requests are merged into shared device batches:

  * requests land in a queue; a dispatcher thread drains whatever is pending
    (up to `max_batch`, waiting at most `max_wait_ms` after the first) and
    runs one batched two-stage generate for each group of them;
  * per-request sampling knobs (temperature, mask_temperature, top_p,
    sample_cutoff, seed) are per-row tensors, so heterogeneous requests share
    a batch;
  * token lengths are padded to the coarse chunk grid, so requests of
    different lengths can share a group (on an sp interface, to
    `Interface.sp_pad_len`: the chunk-free path's own grid, so a request's
    batched tokens are its solo ones);
  * the static sampling config (steps, typical filter, whether top-p is on,
    coarse only) keys the groups: requests that differ there run in separate
    batches;
  * batches are pipelined: the dispatcher's eager calls queue their kernels
    on the card's stream and return, and a collector thread copies each
    batch's result to the host (`.cpu()` waits for its kernels) and resolves
    the futures. `pipeline_depth` bounds the batches in flight.

While tracing is on (`profiling.py`) the engine records an `engine.queue`
span per request, from `submit` to its group's start, with the request's
`trace_id`, and an `engine.dispatch` span per group around the host's
enqueue of its coarse and c2f loops, with the group's trace ids and rows.

Each request's tokens depend only on its own seed: its row takes per-row
keys (`Interface.coarse_vamp(seed=array)`), so it gets the same tokens
served alone or batched, up to the card's choice of GEMM algorithm for the
batch's row count (bf16 logits may differ in their last bits).

With `data_parallel=True` (after `Interface.shard()` or `shard_pipeline()`)
a group is rounded up to a multiple of the mesh's dp size by repeating its
last request (the extra rows' outputs are dropped), and its rows split over
the dp groups of the mesh (`parallel/placement.py`).

A second kind of request, `MagnetRequest` (text-to-music through a
`MagnetInterface`, `magnet=`), goes through the same queue, dispatcher,
collector and static-key grouping: its key is the duration's frames, the
decoding steps and the group's text length (the longest text rounded up to
`MagnetInterface.text_bucket`). A group runs T5 and its projection, the
stage loop on doubled CFG rows, and the EnCodec decode; each future gets
(codes (1, n_q, frames), audio (1, 1, samples)). Its rows' keys come from
their own seeds, so a request gets the same tokens alone or batched with
requests of the same text length. The engine counts the groups' rows and
their CFG rows (`stats["magnet_rows"]`, `stats["cfg_rows"]`).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import profiling
from ..util import to_device


@dataclasses.dataclass
class VampRequest:
    codes: np.ndarray  # (1, n_codebooks, t)
    mask: np.ndarray  # (1, n_codebooks, t)
    seed: int = 0
    temperature: float = 1.0
    mask_temperature: float = 10.5
    top_p: Optional[float] = None
    sample_cutoff: float = 1.0
    sampling_steps: int = 12
    typical_filtering: bool = True
    typical_mass: float = 0.15
    typical_min_tokens: int = 64
    coarse_only: bool = False
    trace_id: Optional[int] = None  # shared with the caller's spans (profiling.py)


@dataclasses.dataclass
class MagnetRequest:
    """Text-to-music: T5 ids (any length), the seconds of audio, the seed of
    the row's key and the sampling knobs (`magnet.DEFAULTS`)."""

    text_ids: np.ndarray  # (l,) int
    seconds: float = 30.0
    seed: int = 0
    top_p: float = 0.9
    temperature: float = 3.0
    max_cfg_coef: float = 10.0
    min_cfg_coef: float = 1.0
    decoding_steps: Tuple[int, ...] = (60, 10, 10, 10)
    trace_id: Optional[int] = None


class VampEngine:
    def __init__(
        self,
        interface=None,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        bucket_tokens: Optional[int] = None,
        data_parallel: bool = False,
        pipeline_depth: int = 2,
        magnet=None,
    ):
        """With `data_parallel=True` (which needs a prior `interface.shard()`),
        a group's rows split over the mesh's dp groups while the weights
        stay replicated. `interface` (VampNet's) serves `VampRequest`s,
        `magnet` (a `MagnetInterface`) `MagnetRequest`s; either may be None."""
        self.interface = interface
        self.magnet = magnet
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.bucket_tokens = bucket_tokens or (
            interface.s2t(interface.coarse.chunk_size_s) if interface is not None else None)
        self.data_parallel = data_parallel
        mesh = interface.placement.mesh if interface is not None else None
        if data_parallel:
            assert mesh is not None, "data_parallel serving requires interface.shard(mesh) first"
        self.dp = mesh.shape.get("dp", 1) if data_parallel else 1
        # (request, future, its submit time while tracing)
        self._q: "queue.Queue[Tuple[VampRequest, Future, Optional[int]]]" = queue.Queue()
        # dispatched batches whose results are not on the host yet; the
        # bounded put() is the backpressure that caps device memory at
        # pipeline_depth batches
        self._inflight: "queue.Queue[Optional[Tuple[Any, List, List[int]]]]" = queue.Queue(
            maxsize=max(1, pipeline_depth))
        self._stop = threading.Event()
        self.stats = {"batches": 0, "requests": 0, "batched_requests": 0, "magnet_rows": 0,
                      "cfg_rows": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._collector = threading.Thread(target=self._collect_loop, daemon=True)
        self._thread.start()
        self._collector.start()

    # ---------------- public API ----------------

    def warmup(self, batch_sizes=(1, 2, 4, 8), seconds=None, sampling_steps=12):
        """Run fully masked requests at each batch size through the normal
        path at server start-up, so the first users do not pay the
        libraries' start-up (cuBLAS and cuDNN handles, the kernel library's
        build and load)."""
        iface = self.interface
        t = self.bucket_tokens if seconds is None else iface.s2t(seconds)
        n_cb = iface.c2f.config.n_codebooks if iface.c2f is not None else \
            iface.coarse.config.n_codebooks
        codes = np.zeros((1, n_cb, t), dtype=np.int64)
        mask = np.ones((1, n_cb, t), dtype=np.int64)
        for bs in sorted(set(batch_sizes)):
            futs = [self.submit(VampRequest(codes=codes, mask=mask, seed=i,
                                            sampling_steps=sampling_steps))
                    for i in range(bs)]
            for f in futs:
                f.result()
        return self

    def submit(self, req) -> Future:
        fut: Future = Future()
        self._q.put((req, fut, profiling.stamp()))
        return fut

    def vamp(self, req: VampRequest, timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(req).result(timeout)

    def close(self):
        # order matters: stop the dispatcher first and join it, so nothing
        # can enter _inflight after the collector's shutdown sentinel (a
        # batch dispatched during close() would otherwise hang its futures)
        self._stop.set()
        self._thread.join(timeout=30)
        try:  # the sentinel: drain, then exit (a timeout in case the
            # collector is wedged on a hung device call)
            self._inflight.put(None, timeout=30)
        except queue.Full:  # pragma: no cover - wedged collector
            pass
        self._collector.join(timeout=30)
        # fail whatever a wedged collector left behind, and the requests
        # that were still queued when the dispatcher stopped
        while True:
            try:
                item = self._inflight.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _fail(item[1], RuntimeError("engine closed"))
        while True:
            try:
                _req, fut, _t = self._q.get_nowait()
            except queue.Empty:
                break
            _fail([(_req, fut)], RuntimeError("engine closed"))

    # ---------------- scheduler ----------------

    def _key(self, req):
        if isinstance(req, MagnetRequest):
            m = self.magnet
            if m is None:
                raise ValueError("a MagnetRequest needs an engine built with magnet=")
            return ("magnet", m.frames(req.seconds), tuple(int(n) for n in req.decoding_steps),
                    m.text_len(len(req.text_ids)))
        return self._static_key(req, self._bucket_len(req.codes.shape[-1]))

    def _static_key(self, req: VampRequest, t_bucket: int):
        return (
            t_bucket,
            req.sampling_steps,
            req.typical_filtering,
            round(req.typical_mass, 6),
            req.typical_min_tokens,
            req.top_p is not None,
            req.coarse_only,
        )

    def _bucket_len(self, t: int) -> int:
        if self.interface.placement.sp > 1:
            return self.interface.sp_pad_len(t)
        b = self.bucket_tokens
        return ((t + b - 1) // b) * b

    def _loop(self):
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    first = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                batch: List[Tuple[VampRequest, Future, Optional[int]]] = [first]
                deadline = time.monotonic() + self.max_wait_ms / 1000.0
                while len(batch) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._q.get(timeout=remaining))
                    except queue.Empty:
                        break
                groups: Dict[Any, List[Tuple[Any, Future]]] = {}
                for req, fut, t_submit in batch:
                    if t_submit is not None:
                        profiling.record("engine.queue", t_submit, request=req.trace_id)
                    try:
                        key = self._key(req)
                    except Exception as e:  # the request's future carries it
                        _fail([(req, fut)], e)
                        continue
                    groups.setdefault(key, []).append((req, fut))
                # stats before any future resolves: callers read them as
                # soon as their result lands
                self.stats["batches"] += len(groups)
                self.stats["requests"] += len(batch)
                self.stats["batched_requests"] += sum(
                    len(v) for v in groups.values() if len(v) > 1)
                for key, items in groups.items():
                    try:
                        with profiling.span("engine.dispatch",
                                            requests=[r.trace_id for r, _ in items],
                                            rows=len(items)):
                            if key[0] == "magnet":
                                out, lens = self._dispatch_magnet(key, items)
                            else:
                                out, lens = self._dispatch_group(key, items)
                    except Exception as e:  # the group's futures carry it
                        _fail(items, RuntimeError(f"{e}\n{traceback.format_exc()}"))
                        continue
                    # blocks while pipeline_depth batches are in flight; polls
                    # _stop so that a close() with a wedged collector cannot
                    # strand this batch after the drain ran
                    while True:
                        try:
                            self._inflight.put((out, items, lens), timeout=0.5)
                            break
                        except queue.Full:
                            if self._stop.is_set():
                                _fail(items, RuntimeError("engine closed during dispatch"))
                                break

    def _collect_loop(self):
        """Copy dispatched batches to the host and resolve their futures,
        while the dispatcher forms and queues the next batch."""
        with torch.inference_mode():
            while True:
                item = self._inflight.get()  # None: the shutdown sentinel
                if item is None:
                    return
                out, items, lens = item
                try:  # a MAGNeT group's out is (codes, audio), its lens None
                    out_np = tuple(x.cpu().numpy() for x in out) if lens is None \
                        else out.cpu().numpy()
                except Exception as e:  # a failure on the card
                    _fail(items, RuntimeError(f"{e}\n{traceback.format_exc()}"))
                    continue
                for i, (_req, fut) in enumerate(items):
                    if not fut.done():
                        fut.set_result(tuple(x[i:i + 1] for x in out_np) if lens is None
                                       else out_np[i:i + 1, :, :lens[i]])

    def _dispatch_group(self, key, items: List[Tuple[VampRequest, Future]]):
        iface = self.interface
        t_bucket = key[0]
        reqs = [r for r, _ in items]
        n = len(reqs)
        lens = [r.codes.shape[-1] for r in reqs]
        # data parallel: a multiple of dp rows, the last request repeated
        reqs = reqs + [reqs[-1]] * (-n % self.dp)
        n_cb = reqs[0].codes.shape[1]
        codes = np.zeros((len(reqs), n_cb, t_bucket), dtype=np.int64)
        mask = np.ones((len(reqs), n_cb, t_bucket), dtype=np.int64)
        for i, r in enumerate(reqs):
            t = r.codes.shape[-1]
            codes[i, :, :t] = r.codes[0]
            mask[i, :, :t] = r.mask[0]

        dev = iface.device

        def rows(values):
            return to_device(np.array(values, dtype=np.float32), dev)

        temp = rows([r.temperature for r in reqs])
        mtemp = rows([r.mask_temperature for r in reqs])
        top_p = rows([r.top_p if r.top_p is not None else 1.0 for r in reqs]) if key[5] \
            else None
        cutoff = rows([r.sample_cutoff for r in reqs])
        # per-row seeds: a request's tokens depend only on its own seed; c2f
        # takes a fixed odd offset (the golden-ratio increment) from it
        seeds = np.array([r.seed for r in reqs], dtype=np.int64) & 0xFFFFFFFF
        seeds_c2f = (seeds + 0x9E3779B9) & 0xFFFFFFFF
        knobs = dict(temperature=temp, mask_temperature=mtemp,
                     typical_filtering=reqs[0].typical_filtering,
                     typical_mass=reqs[0].typical_mass,
                     typical_min_tokens=reqs[0].typical_min_tokens, top_p=top_p,
                     sample_cutoff=cutoff)
        mask_d = to_device(mask, dev)
        out = iface.coarse_vamp(to_device(codes, dev), mask_d, seed=seeds,
                                _sampling_steps=reqs[0].sampling_steps, **knobs)
        if not reqs[0].coarse_only and iface.c2f is not None:
            out = iface.coarse_to_fine(out, mask=mask_d, seed=seeds_c2f, **knobs)
        # no sync here: the collector's copy to the host waits for the kernels
        return out, lens

    def _dispatch_magnet(self, key, items):
        """One MAGNeT group: T5, the stage loop and the decode, queued on the
        card; returns ((codes, audio), None)."""
        from ..magnet import text_batch

        if self.data_parallel:
            raise ValueError("MAGNeT requests are not served data parallel")
        m = self.magnet
        _, frames, steps, text_len = key
        reqs = [r for r, _ in items]
        n = len(reqs)
        ids, mask = text_batch([r.text_ids for r in reqs], text_len, m.device)
        dev = m.device

        def rows(values):
            return to_device(np.array(values, dtype=np.float32), dev)

        keys = np.zeros((n, 2), dtype=np.int64)  # a seed s is the key (0, s mod 2^32)
        keys[:, 1] = np.array([r.seed for r in reqs], dtype=np.int64) & 0xFFFFFFFF
        self.stats["magnet_rows"] += n
        self.stats["cfg_rows"] += n
        codes = m.generate(
            m.encode_text(ids, mask), frames, to_device(keys, dev), decoding_steps=steps,
            top_p=rows([r.top_p for r in reqs]), temperature=rows([r.temperature for r in reqs]),
            max_cfg_coef=rows([r.max_cfg_coef for r in reqs]),
            min_cfg_coef=rows([r.min_cfg_coef for r in reqs]))
        return (codes, m.decode(codes)), None


def _fail(items, exc: BaseException):
    for _req, fut in items:
        if not fut.done():
            fut.set_exception(exc)
