"""The device trace of a `--trace 1` run, read from the profiler's raw events.

`torch.profiler` records the card's activities (kernels, copies, sets)
through CUPTI and the host's operators beside them. The raw kineto events are
read once (`key_averages()` takes tens of seconds over the hundreds of
thousands of launches of a window). Each kernel is tied to the host operator
that launched it (`linked_correlation_id`), and through that operator's
thread and start to the benchmark's own spans (`span`), which the drivers
open around the calls into each layer of the port: the codec's encode and
decode, each LM forward, the training step. A run without `--trace` opens no
profiler and its spans cost nothing.

The busy time is the union of the activities' intervals, clipped to the
window: a sum of durations would count twice where streams overlap.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "portbench/"
# a traced run measures its window untraced, then profiles this many more
# seconds of the same load, at most half the window (`traced_seconds`): the
# profiler's start, stop and reading cost the host seconds, which would
# slow the rates read from the window
TRACE_SECONDS = 20.0


def traced_seconds(window_s: float) -> float:
    """How long a traced run profiles the load after a window of `window_s` seconds."""
    return min(TRACE_SECONDS, window_s / 2)


def now_ns() -> int:
    """The clock of the profiler's events (wall-clock nanoseconds)."""
    return time.time_ns()


class Trace:
    """Start it after the window closes (its start can take seconds while
    the load runs), `mark` the traced stretch, stop it at the stretch's
    end; `summary` then holds the reading."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self.window: Optional[Tuple[int, int]] = None
        self.summary: Optional["TraceSummary"] = None

    def span(self, name: str):
        """A host span named `portbench/<name>` on this thread (traced runs only)."""
        if self._prof is None:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(SPAN_PREFIX + name)

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        try:  # the host's operators on every thread (the engine's and the clients')
            cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
            self._prof = profile(activities=acts, experimental_config=cfg)
        except TypeError:
            self._prof = profile(activities=acts)
        self._prof.__enter__()

    def mark(self, t0_ns: int, t1_ns: int) -> None:
        self.window = (t0_ns, t1_ns)

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        t0 = time.perf_counter()
        self.summary = TraceSummary.read(prof, *self.window)
        self.summary.read_s = time.perf_counter() - t0


class TraceSummary:
    """What the per-layer readers take from a trace: the kernels started in
    the window (name, start, end, the innermost benchmark span that launched
    it), the busy time, the window, and the idle gaps."""

    def __init__(self, window_ns: Tuple[int, int], kernels, activities: List[Tuple[int, int]],
                 spans: Dict[int, list]):
        self.window_ns = window_ns
        self.kernels = kernels  # list of (name, start_ns, end_ns, span or None)
        t0, t1 = window_ns
        self.union = _union([(max(s, t0), min(e, t1)) for s, e in activities if e > t0 and s < t1])
        self.busy_ns = sum(e - s for s, e in self.union)
        self.spans = spans
        self.read_s = 0.0

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    @classmethod
    def read(cls, prof, t0_ns: int, t1_ns: int) -> "TraceSummary":
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        cpu_ops: Dict[int, Tuple[int, int]] = {}
        spans: Dict[int, list] = defaultdict(list)
        device = []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            if e.device_type() == cuda:
                if e.is_user_annotation():  # a span's range on the device's timeline
                    continue
                device.append((e.name(), start, start + e.duration_ns(),
                               e.linked_correlation_id()))
                continue
            tid = e.start_thread_id()
            cpu_ops[e.correlation_id()] = (tid, start)
            name = e.name()
            if name.startswith(SPAN_PREFIX):
                spans[tid].append((start, start + e.duration_ns(), name[len(SPAN_PREFIX):]))
        for v in spans.values():
            v.sort()
        starts = {tid: [s for s, _, _ in v] for tid, v in spans.items()}

        def span_of(linked: int) -> Optional[str]:
            op = cpu_ops.get(linked)
            if op is None:
                return None
            tid, at = op
            v = spans.get(tid)
            if not v:
                return None
            i = bisect.bisect_right(starts[tid], at) - 1
            # the innermost span holding `at`: the latest-starting one that
            # has not ended (spans nest on a thread)
            while i >= 0:
                s, e, name = v[i]
                if e >= at:
                    return name
                i -= 1
            return None

        kernels, activities = [], []
        for name, s, e, linked in device:
            activities.append((s, e))
            # copies and sets are activities, not kernels (CUPTI's names)
            if t0_ns <= s < t1_ns and not name.startswith(("Memcpy", "Memset")):
                kernels.append((name, s, e, span_of(linked)))
        return cls((t0_ns, t1_ns), kernels, activities, spans)

    def idle_share(self) -> float:
        return 1.0 - self.busy_ns / max(1, self.window_ns[1] - self.window_ns[0])

    def device_ops(self, n: int = 10) -> list:
        """The n kernel names that took the most device time: [[name, s], ...]."""
        total: Dict[str, int] = defaultdict(int)
        for name, s, e, _ in self.kernels:
            total[name[:160]] += e - s
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest gaps with no device activity in the window, each
        named by the benchmark spans open on the host at its middle:
        [[label, s], ...]."""
        t0, t1 = self.window_ns
        edges = [t0] + [x for iv in self.union for x in iv] + [t1]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:n]:
            mid = (a + b) // 2
            open_spans = sorted({name for v in self.spans.values()
                                 for s, e, name in v if s <= mid <= e})
            out.append([("host in " + "+".join(open_spans)) if open_spans else "host outside spans",
                        length / 1e9])
        return out

    def kernel_time(self, select) -> Tuple[int, int]:
        """(device ns, launches) of the window's kernels for which
        `select(name, span)` holds."""
        ns = n = 0
        for name, s, e, span in self.kernels:
            if select(name, span):
                ns += e - s
                n += 1
        return ns, n


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out
