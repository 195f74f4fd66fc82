#!/usr/bin/env python3
"""The phases of the port's training step on one NVIDIA GPU, read from its
own spans (`avsep.data.generate`, `train.forward`, `.loss`, `.backward`,
`.optimizer`; `av_separation_torch/utils/profiling.py:span`).

    python3 tools/torch_phase_split.py --workload W [--seed N]
        [--steps K] [--turns T] [--root DIR] [--device cuda|cpu]

Builds the benchmark cell W's train state as `benchmark/run.py` does
(`avbench.train_cell.TrainCell`, set-up and check steps included), then
prints JSON lines:

- `span_cost`: host µs of one enter and exit of `span()` with no profiler
  (the shared null context), of a bare `record_function` with none, and
  of `span()` inside a profiler session of the CPU and the device; and
  whether a profiler is seen as enabled under `emit_nvtx`.
- `traced_step_ms`: host ms a step of K steps under that profiler (the
  benchmark's host trace), the spans switched off and on in turns (off,
  on, on, off, T times), and the untraced step beside them.
- `phases`: T more traced sessions of K steps with the spans on, each read
  by `avbench.program_spans.PhaseTimeline`: device ms and launches a
  step of each phase, and outside every phase; the benchmark's spans'
  (`bench.step`, `bench.data`) for the coverage; the device's idle ms a
  step in each phase (each gap cut by the phases it overlaps) and the
  longest gaps named by span, phase and host operation.  Idle in a trace
  of host events is stretched by them: the benchmark reads its idle share
  from a trace of the device alone.

--root takes the manifest and benchmark files from another tree (a tiny
fixture to rehearse on the CPU, whose phases have no device operations).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

PHASES = ("data.generate", "train.forward", "train.loss", "train.backward",
          "train.optimizer")


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _activities(device):
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def span_cost(device, n: int = 20000) -> dict:
    """Host µs of one enter and exit."""
    import torch
    from torch.profiler import profile

    from av_separation_torch.utils.profiling import span

    def per(ctx_of, count):
        t0 = time.perf_counter()
        for _ in range(count):
            with ctx_of("train.forward"):
                pass
        return (time.perf_counter() - t0) / count * 1e6

    out = {"off_us": per(span, n),
           "bare_record_function_off_us": per(
               lambda name: torch.profiler.record_function("avsep." + name),
               n)}
    with profile(activities=_activities(device)):
        out["on_us"] = per(span, n // 10)
    if device.type == "cuda":
        try:
            with torch.autograd.profiler.emit_nvtx():
                out["nvtx_enabled"] = torch.autograd._profiler_enabled()
                out["nvtx_span"] = type(span("train.forward")).__name__
        except RuntimeError as e:  # a build without NVTX
            out["nvtx_error"] = str(e)[:200]
    return out


@contextlib.contextmanager
def spans_off():
    """The step's spans replaced by a null context where they are used."""
    from av_separation_torch import train
    from av_separation_torch.data import device_synthetic

    saved = (train.span, device_synthetic.span)
    train.span = device_synthetic.span = \
        lambda name: contextlib.nullcontext()
    try:
        yield
    finally:
        train.span, device_synthetic.span = saved


def steps_ms(runner, k: int, traced: bool, path: str = None) -> float:
    """Host ms a step of k steps, under a profiler when `traced` (its
    Chrome trace written to `path` when given)."""
    from torch.profiler import profile

    from avbench.trace import span

    _sync(runner.device)
    prof = profile(activities=_activities(runner.device)) if traced \
        else contextlib.nullcontext()
    with prof:
        t0 = time.perf_counter()
        with span("window"):
            for _ in range(k):
                _, loss = runner.one_step()
            float(loss)
        ms = (time.perf_counter() - t0) / k * 1e3
    if path:
        prof.export_chrome_trace(path)
    return ms


def phase_split(events, k: int) -> dict:
    from avbench.program_spans import PhaseTimeline

    t = PhaseTimeline(events)
    per_phase = {}
    for p in PHASES + (None,):
        ops = t.ops_of_phase(p)
        row = {"device_ms": sum(o.seconds for o in ops) * 1e3 / k,
               "launches": len(ops) / k}
        if p is None:
            row["names"] = sorted({o.name[:80] for o in ops})[:10]
        per_phase[p or "outside phases"] = row
    bench = {}
    for s in ("step", "data"):
        ops = t.ops_of(s)
        bench[s] = {"device_ms": sum(o.seconds for o in ops) * 1e3 / k,
                    "launches": len(ops) / k}
    step_phases = ("train.forward", "train.loss", "train.backward",
                   "train.optimizer")
    cover = {
        "device_ms": sum(per_phase[p]["device_ms"] for p in step_phases)
        / bench["step"]["device_ms"] if bench["step"]["device_ms"] else None,
        "launches": sum(per_phase[p]["launches"] for p in step_phases)
        / bench["step"]["launches"] if bench["step"]["launches"] else None,
        "data": per_phase["data.generate"]["device_ms"]
        / bench["data"]["device_ms"] if bench["data"]["device_ms"] else None}
    # Idle: each gap of the device's busy union cut by the phases.
    lo, hi = t.window
    edges = [lo] + [x for iv in t.busy_intervals() for x in iv] + [hi]
    idle = {}
    spans = [(s, e, n) for s, e, n, _ in t.program_spans]
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b <= a:
            continue
        covered = 0.0
        for s, e, n in spans:
            cut = min(b, e) - max(a, s)
            if cut > 0:
                idle[n] = idle.get(n, 0.0) + cut
                covered += cut
        idle["outside phases"] = idle.get("outside phases", 0.0) \
            + (b - a) - covered
    return {"window_ms": (hi - lo) / 1e3 / k, "busy_ms": t.busy_s * 1e3 / k,
            "phases": per_phase, "bench": bench, "cover": cover,
            "idle_ms": {n: v / 1e3 / k for n, v in sorted(idle.items())},
            "idle_gaps": t.idle_gaps(12)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--steps", type=int, default=None,
                    help="traced steps a session (the traffic's "
                    "trace_steps by default)")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    import torch

    from avbench import harness
    from avbench.manifest import Cell, load_manifest
    from avbench.train_cell import TrainCell

    root = Path(args.root)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        print(json.dumps({"device": torch.cuda.get_device_name(device)}),
              flush=True)
    print(json.dumps({"span_cost": span_cost(device)}), flush=True)

    cell = Cell(load_manifest(root), args.workload, root / "benchmark")
    runner = TrainCell(cell, harness.cell_seeds(args.seed), device)
    runner.setup()
    k = args.steps or int(cell.traffic["trace_steps"])
    steps_ms(runner, k, False)  # the first profiler session is not read
    steps_ms(runner, 1, True)
    times = {"untraced": [], "off": [], "on": []}
    for _ in range(args.turns):
        for name in ("off", "on", "on", "off"):
            if name == "off":
                with spans_off():
                    times[name].append(steps_ms(runner, k, True))
            else:
                times[name].append(steps_ms(runner, k, True))
        times["untraced"].append(steps_ms(runner, k, False))
    print(json.dumps({"traced_step_ms": times, "steps": k}), flush=True)

    for _ in range(args.turns):
        fd, path = tempfile.mkstemp(prefix="phase_split_", suffix=".json")
        os.close(fd)
        try:
            ms = steps_ms(runner, k, True, path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        out = phase_split(events, k)
        out["traced_step_ms"] = ms
        print(json.dumps({"workload": args.workload, "seed": args.seed,
                          "steps": k, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
