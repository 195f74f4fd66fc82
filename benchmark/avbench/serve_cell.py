"""A serving cell: the port's `BatchingSeparatorServer` over an
`inference.Separator`, fed waveform requests through `submit_waveform` by
one load thread, in a closed or an open loop (`load.py`).

Set-up builds the separator from weights the benchmark made, warms every
batch bucket the cell can form through the server, makes the pool of
distinct requests and runs the load for `settle_s` before the window
opens.  After the window the answers of a sample of the requests it
finished, drawn from the seed, are held against the reference's.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from av_separation_torch.inference import Separator
from av_separation_torch.serving import BatchingSeparatorServer

from avbench import compare, program
from avbench.load import Load
from avbench.trace import profiled
from avbench.train_cell import exact_float32


class ServeCell:
    def __init__(self, cell, seeds: Dict[str, int], device):
        self.cell, self.seeds, self.device = cell, seeds, device
        self.cfg, self.traffic = cell.config, cell.traffic
        self.ref = cell.reference()
        self.exp = program.experiment(self.cfg)

    def setup(self) -> None:
        t = self.traffic
        t0 = time.perf_counter()
        self.marks = []

        def mark(name):
            nonlocal t0
            now = time.perf_counter()
            self.marks.append((name, now - t0))
            t0 = now

        weights = self.ref.make_weights(self.cfg, self.seeds["weights"],
                                        self.device)
        sd = program.state_dict(weights, self.ref.bn_buffers(self.cfg))
        separator = Separator(self.exp.model, sd, self.exp.data,
                              device=self.device)
        del weights, sd
        mark("separator")
        self.server = BatchingSeparatorServer(
            separator, max_batch=t["max_batch"],
            max_delay_ms=t["max_delay_ms"], max_pending=t["max_pending"])
        self.server.warmup(tuple(t["warm_buckets"]), wave=True)
        mark("warmup")
        gen = torch.Generator(device=self.device).manual_seed(
            self.seeds["pool"])
        mixed, lips = self.ref.requests(gen, self.cfg["data"], t["pool"])
        self.pool = (mixed.cpu().numpy(), lips.cpu().numpy())
        self.load = Load(self.server, self.pool, t, self.seeds["load"],
                         self.cfg["data"]["duration"])
        mark("pool")
        self.load.run_phase("settle", float(t["settle_s"]))
        mark("settle")

    def window(self, seconds: float) -> dict:
        return self.load.run_phase("window", seconds)

    def traced(self) -> dict:
        """`trace_s` of load traced on the device alone (busy, idle and
        copies), then as long with the host's operations."""
        out = {}
        for key, host in (("busy_timeline", False), ("timeline", True)):
            with profiled(self.device.type, host) as holder:
                phase = self.load.run_phase(key, float(
                    self.traffic["trace_s"]), annotate=True)
            out[key] = holder[0]
            out.setdefault("phase", phase)
        return out

    def free(self) -> None:
        self.load.drain()
        self.server.close()
        self.sample = self.load.sample
        self.phases = self.load.phases
        del self.server, self.load

    def reference_run(self, numerics: str) -> dict:
        """The reference's answers to the sampled requests, by pool index."""
        idx = sorted({i for i, _ in self.sample})
        mixed = torch.as_tensor(self.pool[0][idx], device=self.device)
        lips = torch.as_tensor(self.pool[1][idx], device=self.device)
        weights = self.ref.make_weights(self.cfg, self.seeds["weights"],
                                        self.device)
        out = {}
        with exact_float32():
            for j in range(0, len(idx), 8):
                waves, masks = self.ref.separate_waveform(
                    self.cfg, weights, mixed[j:j + 8], lips[j:j + 8],
                    self.ref.Numerics(numerics))
                for k, i in enumerate(idx[j:j + 8]):
                    out[i] = (waves[k].cpu(), masks[k].cpu())
        return out

    def numbers(self, ref: dict, prog=None) -> dict:
        """Over the sampled answers: the worst answer's largest waveform
        error against the reference's peak over its speakers, and the
        worst mask error."""
        prog = self.sample if prog is None else prog
        if isinstance(prog, dict):
            prog = list(prog.items())
        waves = masks = 0.0
        for i, (w, m) in prog:
            rw, rm = ref[i]
            waves = max(waves, compare.rel_max(torch.as_tensor(w), rw))
            masks = max(masks, compare.abs_max(torch.as_tensor(m), rm))
        return {"wave_rel": waves, "mask_abs": masks,
                "sampled": float(len(prog))}

