"""The data-parallel training cell (`"kind": "ddp"`) at a size the CPU runs in
seconds: four gloo ranks of the tiny coarse LM, dp 4, ZeRO-1, through the
same driver, comparison and readers. A sound run is correct and its line
carries the cell's metrics; rank 0 feeding the wrong rows makes `correct`
false; a rank that dies ends the run with an error, not a hang; the
reference in fp8 (`control_ddp.py`) is not correct by the cell's limits.

    python -m pytest benchmark/tests/test_portbench_ddp.py -q
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import tiny  # noqa: E402

CELL = "tiny-train.ddp4"
# the entries the cell would take in BENCHMARK.json, which does not list it
# yet (PERF.md §7): the training cell's metrics and NCCL's share
CELL_METRICS = ("step_ms", "codec_share.train", "mfu.train", "k4_roofline.train",
                "k8_roofline.train", "idle_share.train")
TRAFFIC = {"kind": "ddp", "ranks": 4, "dp": 4, "tp": 1, "batch": 8, "audio_seconds": 0.5,
           "pool_batches": 2, "check_steps": 3, "max_steps": 1000}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    tmp = tiny.make_copy(tmp_path_factory.mktemp("bench"))
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": CELL, "config": "tiny-train", "traffic": "tiny-ddp4",
                              "chips": 4, "why": "t"})
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            if m["name"] in CELL_METRICS:
                m["workloads"].append(CELL)
    spec["per_layer"].append({"name": "nccl_share.ddp4", "unit": "%", "better": "lower",
                              "source": "device_trace", "layer": "collectives",
                              "moves": "step_ms", "workloads": [CELL]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    (tmp / "benchmark/traffic/tiny-ddp4.json").write_text(json.dumps(TRAFFIC))
    (tmp / f"benchmark/limits/{CELL}.json").write_text(json.dumps(tiny.TRAIN_LIMITS))
    return tmp


def run_with(copy: Path, fault: str, *args: str) -> subprocess.CompletedProcess:
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(1, %r); import faults_ddp; "
            "from benchmark import run; "
            "sys.exit(run.main(sys.argv[1:], allow_cpu=True, "
            "fault=getattr(faults_ddp, %r, None)))" % (str(copy), str(HERE), fault))
    env = {"PYTHONPATH": str(tiny.REPO), "PATH": "/usr/bin:/bin", "HOME": str(copy),
           "TMPDIR": str(copy), "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-c", code, "--workload", CELL, "--seed",
                           "2147483923", "--seconds", "2", *args], capture_output=True,
                          text=True, env=env, cwd=copy, timeout=600)


def test_the_sound_run_is_correct_and_reports_the_cells_metrics(copy):
    out = tiny.result(run_with(copy, "", "--trace", "0"))
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0, \
        json.dumps(out["checks"])
    assert set(out["metrics"]) == {"step_ms", "setup_s"}
    assert set(out["checks"]) == {"grad_norm_gap", "change_gap", "failed"}
    traced = tiny.result(run_with(copy, "", "--trace", "1"))
    assert traced["correct"] is True, json.dumps(traced["checks"])
    # on the CPU the host's FLOP rate and the idle share read; no NCCL
    assert "mfu.train" in traced["metrics"] and "nccl_share.ddp4" not in traced["metrics"]


def test_rank_0_feeding_another_ranks_rows_is_not_correct(copy):
    out = tiny.result(run_with(copy, "ddp_rank0_wrong_rows"))
    assert out["correct"] is False, json.dumps(out["checks"])


def test_a_rank_that_dies_ends_the_run(copy):
    t0 = time.perf_counter()
    proc = run_with(copy, "ddp_rank1_dies")
    assert proc.returncode != 0 and not proc.stdout.strip(), proc.stdout[-2000:]
    assert time.perf_counter() - t0 < 120


def test_the_fp8_control_is_not_correct(copy):
    """`control_ddp.py`: the reference over the global batch in fp8 operands,
    judged by the cell's limits, is not correct."""
    code = ("import sys; sys.path.insert(0, %r); from benchmark import control_ddp; "
            "sys.exit(control_ddp.main(sys.argv[1:], allow_cpu=True))" % str(copy))
    env = {"PYTHONPATH": str(tiny.REPO), "PATH": "/usr/bin:/bin", "HOME": str(copy),
           "TMPDIR": str(copy), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code, "--workload", CELL, "--seeds",
                           "2147483929"], capture_output=True, text=True, env=env, cwd=copy,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["control_fp8"]["correct"] is False, line["control_fp8"]
