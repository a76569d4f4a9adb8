"""Whole runs of the tiny cells with the timed path broken underneath
(`faults.py`): each fault a cell can have makes `correct` come out false,
and so does each fault of the sampler's draws.
One card holds every cell, so no exchange between cards can be left out."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import tiny  # noqa: E402


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


def run_with(copy: Path, workload: str, fault: str) -> dict:
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(1, %r); import faults; "
            "from benchmark import run; "
            "sys.exit(run.main(sys.argv[1:], allow_cpu=True, fault=getattr(faults, %r)))"
            % (str(copy), str(HERE), fault))
    env = {"PYTHONPATH": str(tiny.REPO), "PATH": "/usr/bin:/bin", "HOME": str(copy),
           "TMPDIR": str(copy), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code, "--workload", workload, "--seed", "17",
                           "--seconds", "3"], capture_output=True, text=True, env=env, cwd=copy,
                          timeout=900)
    return tiny.result(proc)


@pytest.mark.parametrize("fault", ["serve_state_unchanged", "serve_half_batch",
                                   "serve_token_altered", "serve_answer_altered",
                                   "serve_sampler_temperature", "serve_sampler_noise_dropped",
                                   "serve_remask_noise_shifted"])
def test_a_served_fault_is_not_correct(copy, fault):
    out = run_with(copy, "tiny.closed", fault)
    assert out["correct"] is False, json.dumps(out["checks"])


@pytest.mark.parametrize("fault", ["train_state_unchanged", "train_half_batch",
                                   "train_answer_altered"])
def test_a_training_fault_is_not_correct(copy, fault):
    out = run_with(copy, "tiny-train.b2", fault)
    assert out["correct"] is False, json.dumps(out["checks"])


def test_the_sound_runs_are_correct(copy):
    for workload in ("tiny.closed", "tiny-train.b2"):
        out = tiny.result(tiny.run(copy, "--workload", workload, "--seed", "17", "--seconds", "3"))
        assert out["correct"] is True, json.dumps(out["checks"])
