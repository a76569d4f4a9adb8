"""Metrics tracker (counterpart of `vampnet_tpu/train/tracker.py`; upstream
uses audiotools.ml.Tracker).

Keeps running histories, prints a live console line, appends scalars to a
JSONL log (always), and mirrors to TensorBoard when the package is available.
`is_best` drives the "best" checkpoint tag (reference train.py:395-397);
state_dict/load_state_dict survive checkpoint resume.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict, Optional


class Tracker:
    def __init__(
        self,
        log_dir: Optional[str] = None,
        log_file: Optional[str] = None,
        rank: int = 0,
        history_len: int = 100,
    ):
        self.rank = rank
        self.step = 0
        self.history: Dict[str, deque] = defaultdict(lambda: deque(maxlen=history_len))
        self.bests: Dict[str, float] = {}
        self._jsonl = None
        self._tb = None
        if rank == 0 and log_file:
            Path(log_file).parent.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(log_file, "a")
        if rank == 0 and log_dir:
            try:  # TensorBoard writer where the package is installed
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=log_dir)
        self._t0 = time.time()

    def log(self, label: str, metrics: Dict[str, float], step: Optional[int] = None):
        step = self.step if step is None else step
        clean = {k: float(v) for k, v in metrics.items()}
        for k, v in clean.items():
            self.history[f"{label}/{k}"].append(v)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, "label": label, **clean}) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(f"{label}/{k}", v, step)

    def log_audio(self, tag: str, samples, sample_rate: int, step: Optional[int] = None):
        if self._tb is not None:
            import torch

            self._tb.add_audio(
                tag, torch.tensor(samples).reshape(1, -1), step or self.step, sample_rate
            )

    def mean(self, key: str) -> float:
        h = self.history.get(key)
        return sum(h) / len(h) if h else float("nan")

    def is_best(self, label: str, key: str = "loss") -> bool:
        cur = self.mean(f"{label}/{key}")
        best = self.bests.get(f"{label}/{key}")
        if best is None or cur < best:
            self.bests[f"{label}/{key}"] = cur
            return True
        return False

    def print_status(self, label: str, extra: str = ""):
        if self.rank != 0:
            return
        loss = self.mean(f"{label}/loss")
        elapsed = time.time() - self._t0
        rate = self.step / max(elapsed, 1e-9)
        print(
            f"[{label}] step {self.step} loss {loss:.4f} "
            f"({rate:.2f} it/s) {extra}",
            flush=True,
        )

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "bests": dict(self.bests),
            "history": {k: list(v) for k, v in self.history.items()},
        }

    def load_state_dict(self, sd: dict):
        self.step = sd.get("step", 0)
        self.bests = dict(sd.get("bests", {}))
        for k, v in sd.get("history", {}).items():
            self.history[k].extend(v)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
