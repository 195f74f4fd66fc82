"""Where a cell's pieces live, found by the names in `BENCHMARK.json`:

  configs/<config>.json      a configuration, as it is run, and the name of
                             its plain reference (`reference/<name>.py`)
  traffic/<traffic>.json     a traffic mix: parameters of the general loops
  cells/<workload>.json      the limits of the cell's correctness check
  metrics/<metric>.py        a per-layer metric's reader: `read(ctx)`

A later cell, configuration, traffic mix or metric is new files plus new
entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]


def root_of(bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir.parent


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    return json.loads(path.read_text())


class Cell:
    """One entry of `workloads` with the files its names lead to."""

    def __init__(self, manifest: dict, workload: str,
                 bench_dir: Path = BENCH_DIR):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"have {sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        self.bench_dir = bench_dir
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        root = root_of(bench_dir)
        self.config = _json(root / self.config_entry["file"])
        self.traffic = _json(bench_dir / "traffic"
                             / f"{self.entry['traffic']}.json")
        self.limits = _json(bench_dir / "cells" / f"{workload}.json")
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if workload in m.get("workloads", [workload])]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           f"avbench_metric_{metric}")

    def reference(self) -> ModuleType:
        name = self.config["reference"]
        return load_module(self.bench_dir / "reference" / f"{name}.py",
                           f"avbench_reference_{name}")


def load_module(path: Path, as_name: str) -> ModuleType:
    """A module from its file, under a name of its own (metric names hold
    dots, so they are not importable as they are)."""
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    spec = importlib.util.spec_from_file_location(as_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_names(manifest: dict) -> List[str]:
    return [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
