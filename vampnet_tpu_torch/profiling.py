"""The port's tracer, and its timing utilities (counterpart of
`vampnet_tpu/profiling.py`).

  * `span(name, **ids)`: a span around the work at one layer boundary
    (`engine.dispatch`, `webapp.request`, `train.forward`, ...). While
    tracing is off it returns one shared no-op context, at the cost of a
    flag read. While it is on, the span opens
    `torch.profiler.record_function("vampnet/<name>")`, so a profiler
    running beside it shows the span on its own threads and clock, and on
    its exit appends a `Record` (name, span id, the enclosing span's id on
    this thread, the native thread id, start and end in `time.time_ns()`,
    the profiler's clock, and `ids`) to an in-memory buffer.
  * `stamp()` and `record(name, start_ns, **ids)`: a span that starts on
    one thread and ends on another (a request's wait in a queue), recorded
    where it ends, without a profiler range (those cannot cross threads).
  * Tracing is on while `enable()` holds (until `disable()`) and while a
    `torch.profiler` profile runs in the process, so that every profile,
    `trace()`'s and `start_server()`'s included, shows the program's layers
    beside its kernels. `records()` reads the buffer, `clear()` empties it,
    `summary()` gives p50, p95, mean and count per span name.
  * `Timer`: a host wall-clock tick/tock timer, the unloop bridge's.
  * `trace(log_dir)`: a `torch.profiler` trace of the CPU and the card
    around a region, written to `log_dir` as a Chrome trace.
  * `start_server(log_dir)`: a profiler that the caller starts and stops
    (the JAX package's live profiling server has no PyTorch counterpart);
    `stop()` writes its trace to `log_dir`.

Importing this module starts nothing.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _torch_profiler  # its _is_profiler_enabled: a profiler runs


class Timer:
    """tick/tock wall timer."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    def tick(self, name: str):
        self.times[name] = time.time()

    def tock(self, name: str) -> float:
        toc = time.time() - self.times[name]
        print(f"{name} took {toc} seconds")
        return toc


PREFIX = "vampnet/"

_on = False
_records: List["Record"] = []
_next_id = itertools.count(1)
_local = threading.local()


class Record(NamedTuple):
    name: str
    id: int
    parent: Optional[int]  # the enclosing span on the same thread
    tid: int  # threading.get_native_id() of the thread that recorded it
    start_ns: int  # time.time_ns()
    end_ns: int
    ids: dict


class _Off:
    """The span while tracing is off: one shared object that does nothing."""

    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "ids", "id", "parent", "_start", "_range")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids, self.id = name, ids, next(_next_id)

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._range.__exit__(*exc)
        _stack().pop()
        _records.append(Record(self.name, self.id, self.parent, threading.get_native_id(),
                               self._start, end, self.ids))
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **ids):
    """A span named `name` with `ids` (see the module docstring); its `id`
    is None while tracing is off."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, ids)


def stamp() -> Optional[int]:
    """Now on the spans' clock while tracing, else None (then `record`
    nothing for it)."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return None
    return time.time_ns()


def record(name: str, start_ns: int, **ids) -> None:
    """Record a span from `start_ns` (a `stamp()`, possibly taken on another
    thread) to now, on this thread, with no parent."""
    _records.append(Record(name, next(_next_id), None, threading.get_native_id(), start_ns,
                           time.time_ns(), ids))


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def records() -> List[Record]:
    """The spans recorded so far, in the order they ended."""
    return list(_records)


def clear() -> None:
    _records.clear()


def summary() -> Dict[str, Dict[str, float]]:
    """p50/p95/mean/count of the recorded spans' durations, per name."""
    import numpy as np

    by_name: Dict[str, list] = defaultdict(list)
    for r in records():
        by_name[r.name].append((r.end_ns - r.start_ns) / 1e9)
    out = {}
    for k, v in by_name.items():
        arr = np.asarray(v)
        out[k] = {
            "count": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
        }
    return out


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """A `torch.profiler` trace of the region, written to
    `<log_dir>/trace.json` (Chrome trace format; Perfetto opens it). The
    program's spans are on inside it and show as `vampnet/<name>` ranges."""
    from torch.profiler import profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield str(out)
    prof.export_chrome_trace(str(out / "trace.json"))


class _Session:
    """A started profiler; `stop()` ends it and writes its trace."""

    def __init__(self, log_dir: str):
        from torch.profiler import profile

        self.log_dir = Path(log_dir)
        self._prof = profile(activities=_activities())
        self._prof.start()

    def stop(self) -> str:
        self._prof.stop()
        self.log_dir.mkdir(parents=True, exist_ok=True)
        path = self.log_dir / "trace.json"
        self._prof.export_chrome_trace(str(path))
        return str(path)


def start_server(log_dir: str) -> _Session:
    """Start profiling now; the returned session's `stop()` writes the
    trace to `<log_dir>/trace.json`."""
    return _Session(log_dir)
