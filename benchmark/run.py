"""Run one cell of the port's benchmark once, on the card, and print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run builds the port's kernel library if `vampnet_tpu_torch/_build/` does
not hold it yet, makes every weight and input from `--seed`, warms the
cell's shapes, measures for `--seconds` (with the profiler on only under
`--trace 1`), checks what the timed path produced against the plain
reference in `benchmark/reference/`, and prints as its last line on
standard output:

    {"correct": ..., "attempted": ..., "failed": ..., "metrics": {...},
     "device": {...}, "breakdown": {...} (traced runs), "checks": {...}}

`metrics` holds the cell's end-to-end metrics (`--trace 0`) or its
per-layer metrics (`--trace 1`); `checks` every number compared beside its
limit, which also end standard error. It exits non-zero with no result
when no card is visible, when fewer cards than the cell asks for are, when
the port cannot be imported, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vampnet_tpu")
CACHE_DIR = ROOT / ".portbench_cache"


class Context:
    """What a driver and a comparison get: the cell, the seed, the window,
    the trace, the device."""

    def __init__(self, cell, seed: int, seconds: float, trace, device):
        self.cell, self.seed, self.seconds, self.trace, self.device = (
            cell, int(seed), float(seconds), trace, device)

    @staticmethod
    def log(msg: str) -> None:
        print(f"benchmark: {time.perf_counter() - T_START:8.2f} s {msg}", file=sys.stderr,
              flush=True)


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no JAX through a library;
    one thread per host operator (the clients' and the engine's threads
    share the host's cores, and thread pools beside them only contend)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE_DIR / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(args, device, fault=None):
    """Set-up, window, readings and comparison of one run; returns the
    result object and the numbers compared."""
    import torch

    from benchmark.harness.cells import Cell
    from benchmark.harness.trace import Trace

    cell = Cell(args.workload)
    trace = Trace(bool(args.trace))
    ctx = Context(cell, args.seed, args.seconds, trace, device)
    if device.type == "cuda":
        from vampnet_tpu_torch.ops import build

        build.library()
        torch.cuda.set_device(device)
        torch.empty(1, device=device)  # the context, before the peak's reset
        torch.cuda.reset_peak_memory_stats(device)
    ctx.log("kernel library loaded")
    driver = cell.driver()
    sut = driver.setup(ctx) if fault is None else fault(driver, ctx)
    ctx.log("set up")
    t_open = sut.run_window(ctx.seconds, trace)
    ctx.log("window closed")
    setup_s = t_open - T_START
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    attempted, failed = sut.attempted_failed()
    metrics = {}
    if not args.trace:
        e2e = sut.end_to_end()
        e2e["setup_s"] = setup_s
        for name, m in cell.metrics("end_to_end").items():
            if name in e2e:
                metrics[name] = {"value": e2e[name], "unit": m["unit"]}
    breakdown = None
    if args.trace:
        summary = trace.summary
        view = Reading(cell, sut, summary)
        for name, m in cell.metrics("per_layer").items():
            value = cell.reader(name).read(view)
            if value is not None:
                metrics[name] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": summary.device_ops(), "idle_gaps": summary.idle_gaps()}
    notes = sut.notes()
    if args.trace:
        notes["trace_kernels"] = len(summary.kernels)
        notes["trace_kernels_in_spans"] = sum(1 for k in summary.kernels if k[3] is not None)
        notes["trace_read_s"] = summary.read_s
    numbers = cell.compare().check(sut, ctx)
    ctx.log("compared")
    numbers["failed"] = failed
    limits = cell.limits
    checks = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["power"] = power_limit()
    if args.trace:
        dev["busy_s"] = trace.summary.busy_s
        dev["window_s"] = trace.summary.window_s
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    result["readings"] = {k: v for k, v in numbers.items() if k not in limits}
    return result, notes


class Reading:
    """What a per-layer metric's reader gets: the cell, the driver's records
    (`sut`), the trace's summary, and the yardstick (`roofline`)."""

    def __init__(self, cell, sut, trace):
        from benchmark import roofline

        self.cell, self.sut, self.trace, self.roofline = cell, sut, trace, roofline
        self.config, self.traffic = cell.config, cell.traffic


def main(argv=None, allow_cpu: bool = False, fault=None) -> int:
    args = parse(argv)
    _environment()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    try:
        import torch

        import vampnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: cannot import the port: {e}", file=sys.stderr)
        return 2
    if torch.cuda.is_available():
        from benchmark.harness.cells import Cell

        chips = Cell(args.workload).chips
        if torch.cuda.device_count() < chips:
            print(f"benchmark: the cell asks for {chips} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        device = torch.device("cuda:0")
    elif allow_cpu:
        device = torch.device("cpu")
    else:
        print("benchmark: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        result, notes = run_cell(args, device, fault)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    print(f"benchmark: notes {json.dumps(notes)}", file=sys.stderr)
    print(f"benchmark: readings not compared {json.dumps(result.pop('readings'))}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
