"""The readings that set a cell's limits: the port's numbers, its control's
and, for a training cell, its planted faults', at the cell's own size on
the card, one JSON line per seed.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--seconds 10]

Serving cells run a short window at the cell's own load, then read the
numbers three ways: as the port served them; with the reference's codec one
precision down (TF32) in the port's place; and with the LMs' steps from the
port's own int8 path (`Interface.quantize()`) on the same states, sampled
with the same replayed draws. Training cells read the
port's first steps and the reference's with every product's operands in
fp8, each against the fp32 reference, and the port with each fault of a
training step planted: half of the batch left out (the mean over the rest)
and an answer altered where it is produced (the first row's logits, rolled
by one token). A state left unchanged reads 1 on `change_gap` by the
measure's definition and needs no run. The benchmark's own runs never run this.
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


def half_batch(tr) -> None:
    step = tr.train_step

    def planted(state, codebooks, audio, gen):
        return step(state, codebooks, audio[: audio.shape[0] // 2], gen)

    tr.train_step = planted


def altered_answer(tr) -> None:
    forward = tr.lm.forward_codes

    def planted(*a, **kw):
        out = forward(*a, **kw).clone()
        out[0] = out[0].roll(1, dims=-1)  # the first row's logits, off by one token
        return out

    tr.lm.forward_codes = planted


FAULTS = {"half_batch": half_batch, "altered_answer": altered_answer}


def serve_readings(ctx) -> dict:
    from benchmark.compare import serve as cmp
    from benchmark.drivers import serve as drv

    sv = drv.setup(ctx)
    sv.run_window(ctx.seconds, ctx.trace)
    g = cmp.gather(sv, ctx)
    sides = cmp.int8_side(sv, g, ctx)
    sv.release()
    return {"port": cmp.readings(g, ctx), "control_tf32": cmp.readings(g, ctx, "tf32"),
            "control_int8": cmp.readings(g, ctx, "int8", sides)}


def train_readings(ctx) -> dict:
    from benchmark.compare import train as cmp
    from benchmark.drivers.train import Training

    n = int(ctx.cell.traffic["check_steps"])
    ref = cmp.reference_steps(ctx, n)
    out = {"control_fp8": cmp.readings(cmp.reference_steps(ctx, n, "fp8"), ref)}
    for name, fault in [("port", None), *FAULTS.items()]:
        tr = Training(ctx, fault=fault)
        out[name] = cmp.readings(cmp.port_readings(tr), ref)
        tr.release()
    return out


def main(argv=None, allow_cpu: bool = False) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    bench._environment()
    import torch

    from benchmark.harness.cells import Cell
    from benchmark.harness.trace import Trace

    if torch.cuda.is_available():
        from vampnet_tpu_torch.ops import build

        build.library()
        device = torch.device("cuda:0")
    elif allow_cpu:
        device = torch.device("cpu")
    else:
        print("control: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = bench.Context(cell, seed, args.seconds, Trace(False), device)
        kind = cell.traffic["kind"]
        readings = serve_readings(ctx) if kind == "serve" else train_readings(ctx)
        print(json.dumps({"workload": cell.name, "seed": seed, **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
