"""The open loop's sweep, on the card: one server of a serving cell's
configuration, Poisson arrivals at each rate in turn, each rate's latency
tail and whether its backlog grows.

    python3 benchmark/sweep_open.py --workload <serving cell> \
        --rates 150,180,210 [--seconds 10] [--seed 1]

A rate is sustained when the window's last quarter of requests waits no
longer than its first quarter (by the median, within 20%) and none fails.
The cell's rate is set at 4/5 of the highest sustained rate.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch
    from avbench import harness
    from avbench.load import Load, percentile
    from avbench.manifest import Cell, load_manifest

    cell = Cell(load_manifest(ROOT), args.workload)
    seeds = harness.cell_seeds(args.seed)
    runner = harness.make_cell(cell, seeds, torch.device("cuda", 0))
    runner.setup()
    runner.load.drain()
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = dict(cell.traffic, loop="open", rate_per_s=rate)
        load = Load(runner.server, runner.pool, traffic, seeds["load"],
                    cell.config["data"]["duration"])
        load.run_phase("settle", float(traffic["settle_s"]))
        w = load.run_phase("window", args.seconds)
        load.drain()
        lat = [x * 1e3 for x in w.latency_s]
        q = max(1, len(lat) // 4)
        first, last = statistics.median(lat[:q]), statistics.median(lat[-q:])
        print(json.dumps({
            "rate_per_s": rate, "due": w.due, "failed": w.failed,
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "max_ms": max(lat), "first_quarter_ms": first,
            "last_quarter_ms": last,
            "mean_batch": w.batched / max(1, w.batches),
            "lateness_p95_ms": 1e3 * percentile(w.lateness_s, 95),
            "sustained": w.failed == 0 and last <= 1.2 * first}),
            flush=True)
    runner.server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
