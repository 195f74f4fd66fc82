"""The manifest meets the benchmark's contract, and every cell's pieces
are found by name."""

from __future__ import annotations

import json
import re

import pytest
from conftest import BENCH, ROOT, build_bench, tiny_config

from avbench.manifest import Cell, load_manifest, metric_names

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = load_manifest(ROOT)
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    for p in MANIFEST["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p


@pytest.mark.parametrize("name", metric_names(MANIFEST) + WORKLOADS
                         + [c["name"] for c in MANIFEST["configs"]])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"]
                         + MANIFEST["per_layer"], ids=metric_names(MANIFEST))
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    if metric in MANIFEST["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        return
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    moved = e2e[metric["moves"]]
    for w in metric["workloads"]:
        assert w in moved.get("workloads", WORKLOADS), (metric["name"], w)
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    if "roofline" in metric["name"]:
        assert metric["name"].endswith("_roofline") and metric["unit"] == "%"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_and_metrics(workload):
    cell = Cell(MANIFEST, workload)
    assert cell.chips == 1
    assert cell.config["name"] == cell.entry["config"]
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    assert callable(cell.reference().make_weights)
    assert len(cell.entry["why"]) <= 200


def test_a_fixture_cell_is_found_without_editing_a_file(tmp_path):
    before = {p: p.read_bytes() for p in BENCH.rglob("*.json")}
    bench = build_bench(tmp_path, {"tiny.train_b128": (
        {"kind": "train", "batch_size": 2, "check_steps": 1,
         "trace_steps": 1}, {"loss_gap": 1.0})}, tiny_config())
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell = Cell(manifest, "tiny.train_b128", bench)
    assert cell.config["model"]["d_model"] == 64
    assert cell.traffic["batch_size"] == 2
    assert cell.limits == {"loss_gap": 1.0}
    assert {m["name"] for m in cell.per_layer} >= {"device.mfu.train"}
    assert {p: p.read_bytes() for p in BENCH.rglob("*.json")} == before


@pytest.mark.parametrize("limits", sorted((BENCH / "cells").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_calibrated_cell_names_its_files(limits):
    config, traffic = limits.stem.split(".", 1)
    assert (BENCH / "configs" / f"{config}.json").is_file()
    t = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    assert t["kind"] in ("train", "serve")
    assert all(v > 0 for v in json.loads(limits.read_text()).values())
