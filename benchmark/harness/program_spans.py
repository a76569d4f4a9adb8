"""The port's own spans (`vampnet_tpu_torch/profiling.py`), as the per-layer
readers take them.

The port records a span at its layer boundaries (`engine.queue`,
`engine.dispatch`, `webapp.request`, `webapp.engine_wait`, `train.forward`,
`train.backward`, `train.optimizer`) while its tracer is on, which it is
while a `torch.profiler` profile runs: in a `--trace 1` run, the traced
stretch. A record's start and end are `time.time_ns()`, the clock of the
profiler's events and of `TraceSummary`'s window and busy union. A port
without the tracer records nothing, and every reader of these then reads
None.

`kernel_spans` ties each kernel of a profile to the innermost program span
that launched it; the card's tests use it (`TraceSummary` ties kernels to
the benchmark's own spans only). A kernel the port launches through its
ctypes library outside any torch operator (K1 and K10 in inference) has no
launch record in the profile, and ties to no span.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "vampnet/"
# autograd runs a CUDA backward's operators on its own device thread: a
# kernel launched on any thread inside such a span's interval is the span's
ANY_THREAD = ("train.backward",)


def records(name: str) -> list:
    """Every record of the span `name` the program holds (none from a port
    without the tracer)."""
    from vampnet_tpu_torch import profiling

    read = getattr(profiling, "records", None)
    return [r for r in read() if r.name == name] if read is not None else []


def ended_in(run, name: str) -> list:
    """The records of `name` that ended inside the traced stretch."""
    t0, t1 = run.trace.window_ns
    return [r for r in records(name) if t0 <= r.end_ns < t1]


def ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def idle_share_split(run) -> Optional[Tuple[float, float]]:
    """(device-idle time with an `engine.dispatch` span open, device-idle
    time with none open), each as a share of the traced stretch in %; None
    without dispatch records. The two add up to the stretch's idle share."""
    spans = records("engine.dispatch")
    if not spans:
        return None
    t0, t1 = run.trace.window_ns
    edges = [t0] + [x for iv in run.trace.union for x in iv] + [t1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    open_ = _union([(max(r.start_ns, t0), min(r.end_ns, t1)) for r in spans
                    if r.end_ns > t0 and r.start_ns < t1])
    both = _overlap_ns(idle, open_)
    window = t1 - t0
    return 100.0 * both / window, 100.0 * (sum(b - a for a, b in idle) - both) / window


def kernel_spans(prof) -> List[tuple]:
    """(kernel name, device start ns, device end ns, span or None, launch ns
    or None) for every kernel of a finished `torch.profiler` profile: the
    innermost program span open on the launching thread at the launch, else
    an `ANY_THREAD` span open on any thread then. A span ties its kernels
    only if the profile holds its whole range."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops: Dict[int, Tuple[int, int]] = {}
    spans: Dict[int, list] = defaultdict(list)
    device = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        if e.device_type() == cuda:
            name = e.name()
            if not e.is_user_annotation() and not name.startswith(("Memcpy", "Memset")):
                device.append((name, start, start + e.duration_ns(), e.linked_correlation_id()))
            continue
        tid = e.start_thread_id()
        ops[e.correlation_id()] = (tid, start)
        if e.name().startswith(PREFIX):
            spans[tid].append((start, start + e.duration_ns(), e.name()[len(PREFIX):]))
    for v in spans.values():
        v.sort()
    starts = {tid: [s for s, _, _ in v] for tid, v in spans.items()}
    anywhere = sorted(s for v in spans.values() for s in v if s[2] in ANY_THREAD)

    def span_at(tid: int, at: int) -> Optional[str]:
        v = spans.get(tid, [])
        i = bisect.bisect_right(starts.get(tid, []), at) - 1
        while i >= 0:  # the latest-starting span still open: the innermost
            s, e, name = v[i]
            if e >= at:
                return name
            i -= 1
        for s, e, name in anywhere:
            if s <= at <= e:
                return name
        return None

    out = []
    for name, s, e, linked in device:
        op = ops.get(linked)
        out.append((name, s, e, *((span_at(*op), op[1]) if op is not None else (None, None))))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(e, out[-1][1]))
        else:
            out.append((s, e))
    return out


def _overlap_ns(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
