"""Tracing and timing utilities (counterpart of `vampnet_tpu/profiling.py`).

  * `Timer`: a host wall-clock tick/tock timer, the unloop bridge's.
  * `timing(name)` and the decorator `timer(name)`: record stage latencies
    into a registry that `summary()` reads (p50, p95, mean, count) and
    `reset()` clears.
  * `trace(log_dir)`: a `torch.profiler` trace of the CPU and the card
    around a region, written to `log_dir` as a Chrome trace.
  * `start_server(log_dir)`: a profiler that the caller starts and stops
    (the JAX package's live profiling server has no PyTorch counterpart);
    `stop()` writes its trace to `log_dir`.

Importing this module starts nothing.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional


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


_STAGE_TIMES: Dict[str, List[float]] = defaultdict(list)


@contextlib.contextmanager
def timing(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _STAGE_TIMES[name].append(time.perf_counter() - t0)


def timer(name: Optional[str] = None):
    """Decorator recording each call's latency under `name` (default: the
    function's name)."""

    def deco(fn):
        label = name or fn.__name__

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with timing(label):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def summary() -> Dict[str, Dict[str, float]]:
    """p50/p95/mean/count for every recorded stage."""
    import numpy as np

    out = {}
    for k, v in _STAGE_TIMES.items():
        arr = np.asarray(v)
        out[k] = {
            "count": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
        }
    return out


def reset():
    _STAGE_TIMES.clear()


def _activities():
    from torch.profiler import ProfilerActivity
    import torch

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """A `torch.profiler` trace of the region, written to
    `<log_dir>/trace.json` (Chrome trace format; Perfetto opens it)."""
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
