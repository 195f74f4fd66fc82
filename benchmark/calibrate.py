"""Readings that a cell's correctness limits are set from, on the card:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 2] [--out file.jsonl]

For each seed of --seeds, the program's compared numbers against the
reference (set-up, a short window, the check, as a run makes them: the
lower readings).  For each seed of --control-seeds, the same numbers of
the control (the reference computed in float8 e4m3 in the program's
place) and, for a training cell, of a planted fault (the reference's loss
over half of the batch): the upper readings.  One JSON line each.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    from avbench import harness
    from avbench.manifest import Cell, load_manifest

    cell = Cell(load_manifest(ROOT), args.workload)
    device = torch.device("cuda", 0)
    numerics = cell.config["model"]["compute_dtype"]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program_reading(seed):
        runner = harness.make_cell(cell, harness.cell_seeds(seed), device)
        runner.setup()
        runner.window(args.seconds)
        runner.free()
        torch.cuda.empty_cache()
        ref = runner.reference_run(numerics)
        return runner, ref, runner.numbers(ref)

    for s in filter(None, args.seeds.split(",")):
        t0 = time.perf_counter()
        _, _, nums = program_reading(int(s))
        emit({"workload": cell.name, "seed": int(s), "side": "program",
              "numbers": nums, "seconds": time.perf_counter() - t0})
    for s in filter(None, args.control_seeds.split(",")):
        t0 = time.perf_counter()
        runner, ref, nums = program_reading(int(s))
        emit({"workload": cell.name, "seed": int(s), "side": "program",
              "numbers": nums, "seconds": time.perf_counter() - t0})
        ctrl = runner.reference_run("fp8")
        emit({"workload": cell.name, "seed": int(s), "side": "control_fp8",
              "numbers": runner.numbers(ref, ctrl)})
        if cell.traffic["kind"] == "train":
            half = runner.reference_run(numerics, half_batch=True)
            emit({"workload": cell.name, "seed": int(s),
                  "side": "fault_half_batch",
                  "numbers": runner.numbers(ref, half)})
        del runner, ref
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "peak_bytes": torch.cuda.max_memory_allocated()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
