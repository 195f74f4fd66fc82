"""The benchmark of the PyTorch port (`av_separation_torch`) on one card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

runs one cell of `BENCHMARK.json` and prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), device, with
--trace 1 breakdown, and last the compared numbers beside their limits
(`checks`), which also end standard error.  Without a CUDA card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded,
it prints no result and exits 2 or 3.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """When this process started, on the perf_counter clock (from its
    start tick; the time of this line where /proc is not there)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Every build and kernel cache at a fixed path inside the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
sys.path[:0] = [str(BENCH), str(ROOT)]


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from avbench.manifest import Cell, load_manifest
    cell = Cell(load_manifest(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2

    from avbench import harness
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']} limit {c['limit']} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
