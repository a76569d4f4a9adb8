"""The controls, on the card: with the reference put in the port's place
one precision down (serving: the codec in TF32, the LMs through the port's
int8 path; training: fp8 operands), and with a training step's faults
planted, `correct` comes out false against the cell's own limits, at the
cell's own size (`benchmark/control.py`, one seed, a short window).

    python -m pytest benchmark/tests/test_portbench_control.py -q   # on the card
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def readings(workload: str, seed: int) -> dict:
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the card: the controls run at the cell's own size")
    proc = subprocess.run([sys.executable, str(REPO / "benchmark" / "control.py"), "--workload",
                           workload, "--seeds", str(seed), "--seconds", "15"],
                          capture_output=True, text=True, cwd=REPO, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def fails(numbers: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if k in numbers and numbers[k] > lim]


def limits(cell: str) -> dict:
    return json.loads((REPO / "benchmark" / "limits" / f"{cell}.json").read_text())


@pytest.mark.parametrize("cell", ["vampnet.loop-closed16"])
def test_serving_controls_are_not_correct(cell):
    r = readings(cell, 2147483801)
    lim = limits(cell)
    assert not fails(r["port"], lim), r["port"]
    assert fails(r["control_tf32"], lim) and fails(r["control_int8"], lim)


def test_training_control_and_faults_are_not_correct():
    r = readings("coarse-train.b8", 2147483802)
    lim = limits("coarse-train.b8")
    assert not fails(r["port"], lim), r["port"]
    for name in ("control_fp8", "half_batch", "altered_answer"):
        assert fails(r[name], lim), (name, r[name])
