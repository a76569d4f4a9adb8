"""The readings that set the text-to-music cell's limits: the port's numbers
and its controls', at the cell's own size on the card, one JSON line per
seed.

    python3 benchmark/control_t2m.py --workload magnet-medium.t2m-closed16 --seeds 11,12 \
        [--seconds 20]

Each seed runs a short window at the cell's own load, then reads the
numbers three ways (`compare/t2m.py`): as the port served them; with T5's
and the LM's outputs and span choices from the reference with every
product's operands in fp8, one precision below the configuration's bf16;
and with the codec's audio from the reference in TF32. Each of the three is
judged by the cell's limits file as `benchmark/run.py` judges a run: its
`correct` and the numbers over their limits. The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as bench  # noqa: E402


def judged(numbers: dict, limits: dict) -> dict:
    """The readings with `correct` (every limited number present and within
    its limit) and `over` (the names that are not)."""
    over = sorted(k for k, lim in limits.items()
                  if numbers.get(k) is None or numbers[k] > lim)
    return dict(numbers, correct=not over, over=over)


def main(argv=None, allow_cpu: bool = False) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    bench._environment()
    import torch

    from benchmark.compare import t2m as cmp
    from benchmark.drivers import t2m as drv
    from benchmark.harness.cells import Cell
    from benchmark.harness.trace import Trace

    if torch.cuda.is_available():
        from vampnet_tpu_torch.ops import build

        build.library()
        device = torch.device("cuda:0")
    elif allow_cpu:
        device = torch.device("cpu")
    else:
        print("control_t2m: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = bench.Context(cell, seed, args.seconds, Trace(False), device)
        sv = drv.setup(ctx)
        sv.run_window(ctx.seconds, ctx.trace)
        g = cmp.gather(sv, ctx)
        notes = sv.notes()
        sv.release()
        out = {"workload": cell.name, "seed": seed, "notes": notes,
               "port": judged(cmp.readings(g, ctx), cell.limits)}
        for control in ("fp8", "tf32"):
            out[f"control_{control}"] = judged(cmp.readings(g, ctx, control), cell.limits)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
