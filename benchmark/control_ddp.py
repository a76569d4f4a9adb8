"""The control reading that sets a data-parallel training cell's limits, on
one card: the reference over the global batch with every product's
operands in fp8, one precision below the configuration's bf16 compute, in
the port's place, against the fp32 reference (`compare/ddp.py`), judged by
the cell's limits file. One JSON line per seed.

    python3 benchmark/control_ddp.py --workload coarse-train.ddp4 --seeds 11,12

The ranks' own readings are the cell's runs; the benchmark's own runs
never run this.
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
from benchmark.control_t2m import judged  # noqa: E402


def main(argv=None, allow_cpu: bool = False) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    bench._environment()
    import torch

    from benchmark.compare import ddp as cmp
    from benchmark.compare import train as cmp_train
    from benchmark.harness.cells import Cell
    from benchmark.harness.trace import Trace

    if torch.cuda.is_available():
        device = torch.device("cuda:0")
    elif allow_cpu:
        device = torch.device("cpu")
    else:
        print("control_ddp: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    n = int(cell.traffic["check_steps"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = bench.Context(cell, seed, 0.0, Trace(False), device)
        ref = cmp.reference_steps(ctx, n)
        fp8 = cmp_train.readings(cmp.reference_steps(ctx, n, "fp8"), ref)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control_fp8": judged(fp8, cell.limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
