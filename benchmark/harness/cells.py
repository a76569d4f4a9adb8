"""Finding a cell's files by name.

A cell of `BENCHMARK.json` names its configuration and its traffic mix;
`configs/<config>.json`, `traffic/<mix>.json`, `limits/<cell>.json` and
`metrics/<metric>.py` are read from the benchmark's own directory, and the
traffic file's `kind` names the driver, `drivers/<kind>.py`. A later cell,
mix or metric is a new file here, and no existing file changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

BENCH_DIR = Path(__file__).resolve().parent.parent


class Cell:
    def __init__(self, name: str, bench_dir: Path = BENCH_DIR):
        self.dir = bench_dir
        spec_path = bench_dir.parent / "BENCHMARK.json"
        spec = json.loads(spec_path.read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {spec_path} (have {sorted(cells)})")
        self.spec = spec
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = read_json(bench_dir / "configs" / f"{self.workload['config']}.json")
        self.traffic = read_json(bench_dir / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = read_json(bench_dir / "limits" / f"{name}.json")

    def metrics(self, kind: str) -> Dict[str, dict]:
        """The cell's `end_to_end` or `per_layer` metrics by name: those with
        no `workloads` key and those that list this cell."""
        return {m["name"]: m for m in self.spec[kind]
                if name_listed(m, self.name)}

    def driver(self) -> ModuleType:
        return load_module(self.dir / "drivers" / f"{self.traffic['kind']}.py")

    def compare(self) -> ModuleType:
        return load_module(self.dir / "compare" / f"{self.traffic['kind']}.py")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.dir / "metrics" / f"{metric}.py")


def name_listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module from a file of the benchmark, by path (metric files carry
    dots in their names)."""
    if not path.exists():
        raise FileNotFoundError(f"the benchmark has no file {path}")
    if path.parent.parent == BENCH_DIR and path.stem.isidentifier():
        return importlib.import_module(f"benchmark.{path.parent.name}.{path.stem}")
    name = "portbench_" + path.parent.name + "_" + path.stem.replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
