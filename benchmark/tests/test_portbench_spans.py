"""The port's own spans in the benchmark: the readers of the metrics built on
them (`benchmark/harness/program_spans.py`), the tracer off in untraced
runs, the existing readings untouched by the spans' profiler ranges, and,
on the card, each kernel tied to the span that launched it on the
profiler's clock.

    python -m pytest --noconftest benchmark/tests/test_portbench_spans.py -q -s

On the card the last test drives the cells at their own sizes (the root
`conftest.py` imports JAX, which the card's machine need not have) and
prints each cell's device time by the port's span; on the CPU it drives
`tiny.py`'s cells, where no kernel runs.
"""
from __future__ import annotations

import ast
import math
import subprocess
import sys
import types
from collections import defaultdict
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tiny  # noqa: E402

SPAN_METRICS = ("queue_wait_ms.closed", "enqueue_ms_per_group.closed", "request_host_ms.closed")


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


def test_a_traced_serving_run_reads_the_programs_spans(copy):
    out = tiny.result(tiny.run(copy, "--workload", "tiny.closed", "--seed", "2147483713",
                               "--seconds", "6", "--trace", "1"))
    m = {k: v["value"] for k, v in out["metrics"].items()}
    for name in SPAN_METRICS:
        assert m[name] > 0, (name, m)
    assert m["idle_dispatching.closed"] > 0
    assert math.isclose(m["idle_dispatching.closed"] + m["idle_starved.closed"],
                        m["idle_share.closed"], rel_tol=1e-9, abs_tol=1e-9)


@pytest.mark.parametrize("trace", ["0", "1"])
def test_the_tracer_is_on_only_in_a_traced_runs_stretch(copy, trace):
    code = ("import sys; sys.path.insert(0, %r); from benchmark import run; "
            "rc = run.main(sys.argv[1:], allow_cpu=True); "
            "from vampnet_tpu_torch import profiling; "
            "print(sorted({r.name for r in profiling.records()}), file=sys.stderr); "
            "print(profiling.span('x') is profiling.span('y'), file=sys.stderr); "
            "sys.exit(rc)" % str(copy))
    env = {"PYTHONPATH": str(tiny.REPO), "PATH": "/usr/bin:/bin", "HOME": str(copy),
           "TMPDIR": str(copy), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code, "--workload", "tiny.closed", "--seed",
                           "2147483717", "--seconds", "3", "--trace", trace],
                          capture_output=True, text=True, env=env, cwd=copy, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names, off_after = proc.stderr.strip().splitlines()[-2:]
    want = [] if trace == "0" else ["engine.dispatch", "engine.queue", "webapp.engine_wait",
                                    "webapp.request"]
    assert ast.literal_eval(names) == want
    assert off_after == "True"


def _kept_trace():
    """The harness's `Trace` (on), keeping its profiler after `stop()`."""
    from benchmark.harness.trace import Trace

    class Kept(Trace):
        def stop(self):
            self.prof = self._prof
            super().stop()

    return Kept(True)


def _without_program_spans(prof):
    """The profile's events less the port's `vampnet/` ranges, as
    `TraceSummary.read` takes a profile."""
    events = [e for e in prof.profiler.kineto_results.events()
              if not e.name().startswith("vampnet/")]
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_spans_leave_the_readings_alone_and_tie_each_kernel(kind, tmp_path):
    """One traced stretch of the cell's load as `run.py` runs it, read as
    the harness reads it and again without the port's ranges: the kernels,
    the benchmark's spans, the idle gaps and every per-layer reading agree.
    On the card each span's record lies inside its profiler range (one
    clock); every kernel the harness ties to its `lm.*` spans ties to
    `engine.dispatch` where the profile holds the dispatch's whole range;
    K4 ties to `train.forward`, K8 (on autograd's device thread) to
    `train.backward`, AdamW's kernels to `train.optimizer`."""
    from benchmark.harness import program_spans
    from benchmark.harness.cells import Cell
    from benchmark.harness.trace import TraceSummary
    from benchmark.run import Context, Reading
    from vampnet_tpu_torch import profiling

    card = torch.cuda.is_available()
    if card:
        from vampnet_tpu_torch.ops import build

        build.library()
        cell = Cell({"serve": "vampnet.loop-closed16", "train": "coarse-train.b8"}[kind])
        device, seconds = torch.device("cuda:0"), 8.0
    else:
        copy = tiny.make_copy(tmp_path)
        cell = Cell({"serve": "tiny.closed", "train": "tiny-train.b2"}[kind],
                    bench_dir=copy / "benchmark")
        device, seconds = torch.device("cpu"), 3.0
    trace = _kept_trace()
    profiling.clear()
    sut = cell.driver().setup(Context(cell, 2147483723, seconds, trace, device))
    try:
        sut.run_window(seconds, trace)
        if kind == "train":  # the stretch's steps, as the train readers take the window
            sut.window, sut.n_window = sut.trace_window, sut.traced_steps
        plain = TraceSummary.read(_without_program_spans(trace.prof), *trace.window)
        a, b = trace.summary, plain
        assert (a.kernels, a.spans, a.busy_ns, a.idle_gaps()) == \
            (b.kernels, b.spans, b.busy_ns, b.idle_gaps())
        readings = [{name: cell.reader(name).read(Reading(cell, sut, s))
                     for name in cell.metrics("per_layer")} for s in (a, b)]
        assert readings[0] == readings[1]
        print(f"\n{cell.name} readings: {readings[0]}")
        if not card:
            return
        ranges = [(e.name()[len("vampnet/"):], e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in trace.prof.profiler.kineto_results.events()
                  if e.name().startswith("vampnet/")
                  and e.device_type() != torch.autograd.DeviceType.CUDA]
        held = [r for r in profiling.records() if r.name != "engine.queue"]  # no range
        assert ranges
        for name, s, e in ranges:  # its record starts after the range opens, ends before
            (rec,) = [r for r in held if r.name == name and s <= r.start_ns <= r.end_ns <= e]
            assert rec.start_ns - s < 2_000_000 and e - rec.end_ns < 2_000_000
        t0, t1 = trace.window
        ties = [k for k in program_spans.kernel_spans(trace.prof) if t0 <= k[1] < t1]
        assert [k[:3] for k in ties] == [k[:3] for k in a.kernels]
        share = defaultdict(int)
        for _, s, e, span, _ in ties:
            share[span] += e - s
        print(f"{cell.name} device time by program span, % of busy: "
              f"{ {k: 100.0 * v / a.busy_ns for k, v in share.items()} }")
        if kind == "serve":  # between the first and the last group the profile holds whole
            groups = [(s, e) for n, s, e in ranges if n == "engine.dispatch"]
            first, last = min(s for s, _ in groups), max(e for _, e in groups)
            in_lm = [t[3] for t, k in zip(ties, a.kernels)
                     if k[3] in ("lm.coarse", "lm.c2f") and first <= t[4] <= last]
            assert in_lm and set(in_lm) == {"engine.dispatch"}
        else:
            for pick, span in ((lambda n: "attention_fwd_kernel" in n, "train.forward"),
                               (lambda n: "attention_bwd_kernel" in n, "train.backward"),
                               (lambda n: "adam" in n.lower(), "train.optimizer")):
                got = [t[3] for t in ties if pick(t[0])]
                assert got and set(got) == {span}, (span, sorted(set(got), key=str))
    finally:
        sut.release()
        profiling.clear()
