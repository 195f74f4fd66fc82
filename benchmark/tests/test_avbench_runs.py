"""Whole runs of tiny fixture cells on the CPU (the look for a card
skipped): clean runs come out correct, and each fault the cell can have,
planted in the timed path, comes out not correct.  The card test runs a
real cell."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import time

import pytest
import torch
from cells import CELLS, SERVE_METRICS
from conftest import BENCH, ROOT, build_bench, tiny_config

from avbench import harness, serve_cell, train_cell
from avbench.manifest import Cell


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    b = build_bench(root, CELLS, tiny_config(), SERVE_METRICS)
    return json.loads((root / "BENCHMARK.json").read_text()), b


def _run(bench, workload, trace=False):
    manifest, b = bench
    return harness.run(Cell(manifest, workload, b), 2**31 + 11, 0.5, trace,
                       torch.device("cpu"), time.perf_counter())


def _unchanged(make_step):
    """A step that returns its state unchanged."""
    def make(exp):
        real = make_step(exp)

        def step(state, batch):
            saved = {k: v.detach().clone()
                     for k, v in state.model.state_dict().items()}
            state, metrics = real(state, batch)
            state.model.load_state_dict(saved)
            for st in state.optimizer.adam.state.values():
                st["exp_avg"].zero_()
            return state, metrics
        return step
    return make


def _half_batch(make_step):
    """Half of the batch left out, the mean taken over the rest."""
    def make(exp):
        real = make_step(exp)
        return lambda state, batch: real(
            state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return make


def _loss_altered(make_step):
    """The step's answer, its loss, altered where it is produced."""
    def make(exp):
        real = make_step(exp)

        def step(state, batch):
            state, metrics = real(state, batch)
            return state, dict(metrics, loss=metrics["loss"] + 0.5)
        return step
    return make


def _separator(fault):
    """The port's Separator with an answer altered where it is produced,
    or half of each batch left out and answered by the rest's mean."""
    class Faulty(serve_cell.Separator):
        def separate_waveform(self, mixed, lips):
            out = super().separate_waveform(mixed, lips)
            if fault == "answer_altered":
                out["waveforms"] = -out["waveforms"]
                out["masks"] = out["masks"][::-1].copy()
            else:
                half = max(1, len(mixed) // 2)
                for k in ("waveforms", "masks"):
                    out[k][half:] = out[k][:half].mean(axis=0, keepdims=True)
            return out
    return Faulty


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_clean_run_is_correct(bench, workload, trace):
    out = _run(bench, workload, trace)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    if trace:
        assert "breakdown" in out and "window_s" in out["device"]
    else:
        assert "setup_s" in out["metrics"]
        assert len(out["metrics"]) == 2


@pytest.mark.parametrize("workload,fault", [
    ("tiny.train_b128", "unchanged"), ("tiny.train_b128", "half_batch"),
    ("tiny.train_b128", "loss_altered"),
    ("tiny.serve_closed64", "answer_altered"),
    ("tiny.serve_closed64", "half_batch"),
    ("tiny.serve_open", "answer_altered")])
def test_planted_fault_is_not_correct(bench, workload, fault, monkeypatch):
    if workload.startswith("tiny.train"):
        plant = {"unchanged": _unchanged, "half_batch": _half_batch,
                 "loss_altered": _loss_altered}[fault]
        monkeypatch.setattr(train_cell, "make_train_step",
                            plant(train_cell.make_train_step))
    else:
        monkeypatch.setattr(serve_cell, "Separator", _separator(fault))
    assert not _run(bench, workload)["correct"]


def test_no_jax_is_loaded_by_a_run(tmp_path):
    code = (
        "import sys, time, json, torch\n"
        f"sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, "
        f"{str(ROOT)!r}]\n"
        "import pathlib\n"
        "from cells import CELLS, SERVE_METRICS\n"
        "from conftest import build_bench, tiny_config\n"
        "from avbench import harness\n"
        "from avbench.manifest import Cell\n"
        f"root = pathlib.Path({str(tmp_path)!r})\n"
        "b = build_bench(root, CELLS, tiny_config(), SERVE_METRICS)\n"
        "m = json.loads((root / 'BENCHMARK.json').read_text())\n"
        "for w in sorted(CELLS):\n"
        "    harness.run(Cell(m, w, b), 5, 0.3, True, torch.device('cpu'),\n"
        "                time.perf_counter())\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "av_separation_tpu_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert harness.forbidden_modules() == ["flax.linen"]


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_neither_the_port_nor_jax(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"av_separation_torch", "jax", "jaxlib", "flax",
                        "av_separation_tpu", "avbench"}


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "scaled_bf16.train_b128", "--seed", "2147483659", "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, timeout=1200,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
