"""Tests of the benchmark harness on the CPU, at tiny sizes.  Tests marked
`card` need a CUDA card and skip without one (decided in the fixture)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODEL = {"freq_bins": 65, "d_model": 64, "nhead": 2,
              "num_encoder_layers": 1, "num_fusion_layers": 1,
              "num_speakers": 2, "dropout": 0.1,
              "compute_dtype": "bfloat16", "remat": False}
TINY_DATA = {"sample_rate": 4000, "duration": 0.5, "n_fft": 128,
             "hop_length": 32, "num_frames": 10, "frame_h": 16,
             "frame_w": 16, "speaker_freqs": [220.0, 440.0]}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda", 0)


def tiny_config(**model) -> dict:
    cfg = json.loads((BENCH / "configs" / "scaled_bf16.json").read_text())
    cfg["name"] = "tiny"
    cfg["model"] = dict(TINY_MODEL, **model)
    cfg["data"] = dict(TINY_DATA)
    return cfg


def build_bench(root: Path, cells: dict, config: dict,
                extra: dict = None) -> Path:
    """A benchmark tree under `root` holding one configuration and the
    given cells {workload: (traffic dict, limits dict)}, with the
    repository's reference and metric readers, the manifest's metrics
    and the `extra` ones ({"end_to_end": [...], "per_layer": [...]});
    returns its bench dir."""
    bench = root / "benchmark"
    for sub in ("configs", "traffic", "cells"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "reference", bench / "reference")
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    (bench / "configs" / f"{config['name']}.json").write_text(
        json.dumps(config))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest = {
        "command": real["command"], "paths": real["paths"],
        "run_seconds": real["run_seconds"],
        "configs": [{"name": config["name"], "source": "https://example.org",
                     "file": f"benchmark/configs/{config['name']}.json",
                     "reduced": [], "why": "a tiny fixture"}],
        "workloads": [], "end_to_end": [], "per_layer": []}
    for workload, (traffic, limits) in cells.items():
        tname = workload.split(".", 1)[1]
        (bench / "traffic" / f"{tname}.json").write_text(json.dumps(traffic))
        (bench / "cells" / f"{workload}.json").write_text(json.dumps(limits))
        manifest["workloads"].append(
            {"name": workload, "config": config["name"], "traffic": tname,
             "chips": 1, "why": "a tiny fixture"})
    names = set(cells)
    for key in ("end_to_end", "per_layer"):
        for m in real[key] + (extra or {}).get(key, []):
            ws = [w.replace(w.split(".", 1)[0], config["name"], 1)
                  for w in m.get("workloads", [])]
            m = dict(m)
            if "workloads" in m:
                m["workloads"] = [w for w in ws if w in names]
            manifest[key].append(m)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return bench
