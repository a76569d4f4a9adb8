"""The text-to-music cell (`"kind": "t2m"`) at a size the CPU runs in
seconds: a tiny MAGNeT served through the same driver, comparison and
readers. A sound run is correct and its line carries the cell's metrics;
the LM in fp8, stages 1-3 without their band and the LM without its
cross-attention each make `correct` false.

    python -m pytest benchmark/tests/test_portbench_t2m.py -q
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import tiny  # noqa: E402

CELL = "tiny-magnet.t2m"
CONFIG = {
    "t5": {"vocab_size": 64, "d_model": 32, "n_layers": 2, "n_heads": 2, "d_kv": 16,
           "d_ff": 64, "num_buckets": 32, "max_distance": 128, "eps": 1e-6, "out_dim": 48,
           "compute_dtype": "float32"},
    "lm": {"dim": 48, "n_layers": 2, "n_heads": 3, "ffn_dim": 96, "n_q": 4, "card": 32,
           "subcodes_context": 2, "norm_eps": 1e-5, "max_period": 10000.0,
           "compute_dtype": "float32"},
    "codec": {"sample_rate": 800, "dimension": 8, "n_filters": 4, "ratios": [2, 2], "n_q": 4,
              "bins": 32, "lstm_layers": 2, "kernel_size": 7, "last_kernel_size": 7,
              "residual_kernel_size": 3, "compress": 2},
    "text_bucket": 8,
    "engine": {"max_batch": 4, "max_wait_ms": 5.0, "pipeline_depth": 2},
}
TRAFFIC = {"kind": "t2m", "arrival": {"process": "closed", "clients": 3}, "seconds": 0.3,
           "samples": 1, "text_tokens": [2, 8],
           "request": {"decoding_steps": [4, 3, 3, 3], "top_p": 0.9, "temperature": 3.0,
                       "max_cfg_coef": 10.0, "min_cfg_coef": 1.0},
           "logit_steps": {"0": [0, 2], "1": [1], "2": [1], "3": [1]}, "drain_s": 120,
           "check_requests": 2, "warm_rows": [3, 1]}
# fp32 on both sides: the port meets the reference to rounding
LIMITS = {"t5_rel_err": 1e-5, "lm_mean_gap_full": 1e-5, "lm_mean_gap_banded": 1e-5,
          "keep_mean_gap": 1e-5, "decode_rel_err": 1e-5, "lm_flip_share": 0.06,
          "state_mismatch": 0, "kept_changed": 0,
          "schedule_mismatch": 0, "unfilled": 0, "missing": 0, "failed": 0}
METRICS = ["mfu.t2m", "codec_share.t2m", "k10_roofline.t2m", "attn_roofline.t2m",
           "stage0_share.t2m", "idle_share.t2m", "launches_per_request.t2m"]


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    shutil.copytree(tiny.REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny-magnet", "source": "test",
                        "file": "benchmark/configs/tiny-magnet.json", "reduced": [],
                        "why": "test"}]
    spec["workloads"] = [{"name": CELL, "config": "tiny-magnet", "traffic": "tiny-t2m",
                          "chips": 1, "why": "t"}]
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            if "workloads" in m:
                m["workloads"] = [CELL if w == "magnet-medium.t2m-closed16" else w
                                  for w in m["workloads"]]
    for rel, content in {"BENCHMARK.json": spec,
                         "benchmark/configs/tiny-magnet.json": CONFIG,
                         "benchmark/traffic/tiny-t2m.json": TRAFFIC,
                         f"benchmark/limits/{CELL}.json": LIMITS}.items():
        (tmp / rel).write_text(json.dumps(content, indent=1))
    return tmp


def run_with(copy: Path, fault: str, *args: str) -> dict:
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(1, %r); import faults_t2m; "
            "from benchmark import run; "
            "sys.exit(run.main(sys.argv[1:], allow_cpu=True, "
            "fault=getattr(faults_t2m, %r, None)))" % (str(copy), str(HERE), fault))
    env = {"PYTHONPATH": str(tiny.REPO), "PATH": "/usr/bin:/bin", "HOME": str(copy),
           "TMPDIR": str(copy), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code, "--workload", CELL, "--seed",
                           "2147483917", "--seconds", "3", *args], capture_output=True,
                          text=True, env=env, cwd=copy, timeout=900)
    return tiny.result(proc)


def test_the_sound_run_is_correct_and_reports_the_cells_metrics(copy):
    out = run_with(copy, "", "--trace", "0")
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0, \
        json.dumps(out["checks"])
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s"}
    traced = run_with(copy, "", "--trace", "1")
    assert traced["correct"] is True, json.dumps(traced["checks"])
    # the device readers read nothing on the CPU; the host's FLOP rate does
    assert set(traced["metrics"]) <= set(METRICS) and "mfu.t2m" in traced["metrics"]


@pytest.mark.parametrize("fault", ["t2m_lm_fp8", "t2m_no_band", "t2m_no_cross"])
def test_a_planted_fault_is_not_correct(copy, fault):
    out = run_with(copy, fault)
    assert out["correct"] is False, json.dumps(out["checks"])


def test_the_controls_are_judged_by_the_cells_limits(copy):
    """`control_t2m.py` judges each reading set by the cell's limits file:
    the port's is correct, the reference's in fp8 is not."""
    code = ("import sys; sys.path.insert(0, %r); from benchmark import control_t2m; "
            "sys.exit(control_t2m.main(sys.argv[1:], allow_cpu=True))" % str(copy))
    env = {"PYTHONPATH": str(tiny.REPO), "PATH": "/usr/bin:/bin", "HOME": str(copy),
           "TMPDIR": str(copy), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code, "--workload", CELL, "--seeds",
                           "2147483919", "--seconds", "2"], capture_output=True, text=True,
                          env=env, cwd=copy, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["port"]["correct"] is True and line["port"]["over"] == [], line["port"]
    assert line["control_fp8"]["correct"] is False, line["control_fp8"]
    assert "lm_mean_gap_full" in line["control_fp8"]["over"]
