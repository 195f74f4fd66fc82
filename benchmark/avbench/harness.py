"""One run of one cell: set-up, the measured window, with `--trace 1` a
traced sub-window, then the correctness check, and the result line.

    setup_s      process start to the window's first timed operation
    window       `seconds` of the cell's work, every end-to-end metric
                 taken over all of it on the host's clock
    trace        (--trace 1) a short steady sub-window under the profiler,
                 after the window; the per-layer metrics' readers take
                 their numbers from it and from the window
    check        the program's state freed, the reference run, every
                 compared number printed beside its limit
"""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from avbench import compare, roofline
from avbench.load import percentile
from avbench.manifest import Cell
from avbench.trace import port_kernel_names

FORBIDDEN = ("jax", "jaxlib", "flax", "av_separation_tpu")


def cell_seeds(seed: int) -> Dict[str, int]:
    """The streams of one run, all from `--seed`."""
    words = np.random.SeedSequence(seed % (1 << 64)).generate_state(
        7, np.uint64)
    names = ("weights", "attn", "bits", "data", "pool", "load", "spare")
    return {n: int(w) & 0x7FFF_FFFF_FFFF_FFFF for n, w in zip(names, words)}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def make_cell(cell: Cell, seeds, device):
    kind = cell.traffic["kind"]
    if kind == "train":
        from avbench.train_cell import TrainCell
        return TrainCell(cell, seeds, device)
    if kind == "serve":
        from avbench.serve_cell import ServeCell
        return ServeCell(cell, seeds, device)
    raise ValueError(f"traffic kind {kind!r}")


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_process: float) -> dict:
    """The result of one run (the dict printed as the last line)."""
    stages = Stages(t_process)
    stages.mark("start")
    seeds = cell_seeds(seed)
    runner = make_cell(cell, seeds, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    stages.mark("cuda init")
    runner.setup()
    stages.mark("setup")
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    win = runner.window(seconds)
    stages.mark("window")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    traced = runner.traced() if trace else None
    stages.mark("trace")
    runner.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = runner.reference_run(cell.config["model"]["compute_dtype"])
    numbers = runner.numbers(ref)
    stages.mark("reference")
    stages.report(getattr(runner, "marks", []))
    kind = cell.traffic["kind"]
    verdict = compare.judge(numbers, cell.limits)
    if kind == "serve" and not runner.sample:
        verdict["correct"] = False

    e2e, attempted, failed = end_to_end(cell, kind, win, setup_s)
    out = {"correct": verdict["correct"], "attempted": attempted,
           "failed": failed}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        timeline, busy = traced["timeline"], traced["busy_timeline"]
        ctx = reader_context(cell, runner, win, traced, dev["kind"])
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = busy.busy_s
        dev["window_s"] = busy.window_s
        out["metrics"] = metrics
    else:
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end if m["name"] in e2e}
    out["device"] = dev
    if trace:
        out["breakdown"] = {"device_ops": busy.top_ops(10),
                            "idle_gaps": timeline.idle_gaps(10)}
    out["checks"] = verdict["checks"]
    return out


class Stages:
    """Host seconds of each stage of a run, printed to standard error."""

    def __init__(self, t0: float):
        self.last, self.done = t0, []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.done.append((name, now - self.last))
        self.last = now

    def report(self, inner) -> None:
        parts = [f"{n} {s:.2f} s" for n, s in self.done]
        inner = [f"{n} {s:.2f} s" for n, s in inner]
        print("stages: " + ", ".join(parts)
              + (f" (set-up: {', '.join(inner)})" if inner else ""),
              file=sys.stderr)


def end_to_end(cell: Cell, kind: str, win, setup_s: float):
    """Every end-to-end number this loop gives, and attempted / failed.
    A served request that failed counts in the tail as the longest wait
    (the window and the minute a late answer is waited for)."""
    e2e = {"setup_s": setup_s}
    if kind == "train":
        e2e["train_audio_s_per_s"] = win["audio_s"] / win["wall_s"]
        failed = 0 if math.isfinite(win["last_loss"]) else win["steps"]
        return e2e, win["steps"], failed
    e2e["serve_audio_s_per_s"] = (win.completed * cell.config["data"][
        "duration"] / win.wall_s)
    p95 = percentile(win.latency_s, 95.0)
    e2e["serve_latency_p95_ms"] = (p95 * 1e3 if math.isfinite(p95)
                                   else 1e3 * (win.wall_s + 60.0))
    return e2e, win.due, win.failed


def reader_context(cell: Cell, runner, win, traced, kind: str):
    """What a per-layer metric's reader may read."""
    root = Path(__file__).resolve().parents[2]
    return SimpleNamespace(
        cell=cell, config=cell.config, traffic=cell.traffic,
        timeline=traced["timeline"], traced=traced, window=win,
        device_kind=kind, runner=runner, roofline=roofline,
        port_kernels=port_kernel_names(root / "av_separation_torch" / "csrc"),
        percentile=percentile)
