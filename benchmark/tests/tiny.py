"""A copy of the benchmark at a size the CPU runs in seconds: the same files,
with tiny configurations, traffic, limits and a BENCHMARK.json naming them.
The benchmark's CPU tests drive whole runs through it (`run.main(...,
allow_cpu=True)`); the card is never asked for."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CODEC = {"sample_rate": 8000, "encoder_dim": 8, "encoder_rates": [2, 4, 4], "decoder_dim": 64,
         "decoder_rates": [4, 4, 2], "n_codebooks": 4, "codebook_size": 32, "codebook_dim": 4,
         "compute_dtype": "float32"}
LM = {"n_heads": 2, "n_layers": 1, "latent_dim": 4, "embedding_dim": 32, "vocab_size": 32,
      "dropout": 0.1, "attention_num_buckets": 32, "attention_max_distance": 128}
SERVE_LIMITS = {"encode_code_mismatch": 0, "lm_mean_gap_coarse": 2e-3, "lm_mean_gap_c2f": 2e-3,
                "keep_mean_gap_coarse": 2e-3, "keep_mean_gap_c2f": 2e-3, "decode_rel_err": 1e-3, "mask_mismatch": 0, "start_mismatch": 0,
                "kept_changed": 0, "schedule_mismatch": 0, "unfilled": 0, "missing": 0,
                "failed": 0}
TRAIN_LIMITS = {"grad_norm_gap": 1e-2, "change_gap": 1e-2, "failed": 0}


def serve_traffic() -> dict:
    return {"kind": "serve", "arrival": {"process": "closed", "clients": 2},
            "clip_seconds": [0.5, 1.0], "clips_per_length": 2,
            "presets": ["medium variation", "timbre transfer"], "top_p": [None, 0.9],
            "variations": 2, "sampling_steps": 3, "temperature": 1.0, "drain_s": 120,
            "check_requests": 2, "warm_rows": [1, 2, 3, 4]}


def make_copy(tmp: Path) -> Path:
    """tmp/BENCHMARK.json and tmp/benchmark/ with the tiny cells
    `tiny.closed` and `tiny-train.b2`."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp / "benchmark"
    serve_cfg = {"serving_dtype": "float32", "coarse_chunk_size_s": 1.0, "c2f_chunk_size_s": 0.3,
                 "codec": CODEC,
                 "coarse": dict(LM, n_codebooks=2, n_conditioning_codebooks=0),
                 "c2f": dict(LM, n_codebooks=4, n_conditioning_codebooks=2),
                 "engine": {"max_batch": 4, "max_wait_ms": 5.0, "pipeline_depth": 2}}
    train_cfg = {"codec": CODEC,
                 "lm": dict(LM, n_codebooks=2, n_conditioning_codebooks=0,
                            compute_dtype="float32"),
                 "optimizer": {"label_smoothing": 0.1, "noam_factor": 2.0, "noam_warmup": 10,
                               "weight_decay": 0.01, "grad_clip": 5.0}}
    files = {
        "benchmark/configs/tiny.json": serve_cfg,
        "benchmark/configs/tiny-train.json": train_cfg,
        "benchmark/traffic/tiny-closed.json": serve_traffic(),
        "benchmark/traffic/tiny-b2.json": {"kind": "train", "batch": 2, "audio_seconds": 0.5,
                                           "pool_batches": 3, "check_steps": 3,
                                           "max_steps": 1000},
        "benchmark/limits/tiny.closed.json": SERVE_LIMITS,
        "benchmark/limits/tiny-train.b2.json": TRAIN_LIMITS,
    }
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                        "reduced": [], "why": "test"},
                       {"name": "tiny-train", "source": "test",
                        "file": "benchmark/configs/tiny-train.json", "reduced": [],
                        "why": "test"}]
    spec["workloads"] = [
        {"name": "tiny.closed", "config": "tiny", "traffic": "tiny-closed", "chips": 1, "why": "t"},
        {"name": "tiny-train.b2", "config": "tiny-train", "traffic": "tiny-b2", "chips": 1,
         "why": "t"}]
    rename = {"vampnet.loop-closed16": "tiny.closed", "coarse-train.b8": "tiny-train.b2"}
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            if "workloads" in m:
                m["workloads"] = [rename.get(w, w) for w in m["workloads"]]
    files["BENCHMARK.json"] = spec
    for rel, content in files.items():
        path = tmp / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(content if isinstance(content, str) else json.dumps(content, indent=1))
    return tmp


def run(copy: Path, *args: str, timeout: float = 600) -> subprocess.CompletedProcess:
    """One CPU run of the copy's harness, in a process of its own (the port
    from this repository)."""
    code = ("import sys; sys.path.insert(0, %r); from benchmark import run; "
            "sys.exit(run.main(sys.argv[1:], allow_cpu=True))" % str(copy))
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": str(copy),
           "TMPDIR": str(copy), "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=copy)


def result(proc: subprocess.CompletedProcess) -> dict:
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0 and lines, (proc.returncode, proc.stderr[-4000:])
    return json.loads(lines[-1])
