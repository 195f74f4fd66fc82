"""The general load generator of the serving cells: one thread that sends
waveform requests from a pool through `submit_waveform` and waits for
their answers in the order they were sent (a server of one request shape
answers in that order).

  closed  `clients` requests in flight: each answer sends the next request
          at once, as that many clients that each wait for a reply
  open    requests due on a schedule whatever the answers: the gaps
          between arrivals are `gap_count` quantiles of an exponential at
          `rate_per_s` (Poisson arrivals) in one fixed order drawn from
          `schedule_seed`, repeated as a cycle; the seed draws where in
          the cycle a run starts.  With a cycle as long as the window,
          every seed's window holds the same arrivals.  A request is
          timed from when it was due; how late it was sent is recorded

Which pool request is sent next is drawn from the seed too.  The load runs
in phases (settle, window, trace) and keeps running across them; each
phase counts what was due in it and what completed in it.
"""

from __future__ import annotations

import math
import queue
import random
import time
from collections import deque
from contextlib import nullcontext
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from av_separation_torch.serving import ServerOverloaded

from avbench.trace import span


def open_gaps(rate: float, count: int, schedule_seed: int,
              seed: int) -> np.ndarray:
    """Seconds between arrivals: `count` quantiles of Exp(rate) in the
    order `schedule_seed` draws, rotated to a start that `seed` draws."""
    q = (np.arange(count, dtype=np.float64) + 0.5) / count
    gaps = np.random.default_rng(schedule_seed).permutation(
        -np.log1p(-q) / rate)
    start = int(np.random.default_rng(seed).integers(count))
    return np.roll(gaps, -start)


def percentile(values: List[float], p: float) -> float:
    """The nearest-rank p-th percentile (inf counts as a value)."""
    if not values:
        return math.nan
    ordered = sorted(values)
    return ordered[max(0, math.ceil(p / 100.0 * len(ordered)) - 1)]


class Phase:
    def __init__(self, name: str, stats):
        self.name = name
        self.t0 = time.perf_counter()
        self.t_end = math.inf
        self.wall_s = 0.0
        self.due = 0           # requests due (sent, or shed at send)
        self.failed = 0        # shed, errored, or never answered
        self.completed = 0     # answers that arrived in the phase
        self.latency_s: List[float] = []   # of requests due in the phase
        self.lateness_s: List[float] = []
        self._stats0 = (stats.batches, stats.total_batched)
        self.batches = self.batched = 0

    def close(self, stats) -> None:
        self.batches = stats.batches - self._stats0[0]
        self.batched = stats.total_batched - self._stats0[1]


class Load:
    def __init__(self, server, pool: Tuple[np.ndarray, np.ndarray],
                 traffic: dict, seed: int, audio_s: float):
        self.server, self.pool, self.traffic = server, pool, traffic
        self.audio_s = audio_s
        self.loop = traffic["loop"]
        if self.loop not in ("closed", "open"):
            raise ValueError(f"loop {self.loop!r}: closed or open")
        seeds = np.random.SeedSequence(seed).generate_state(3, np.uint64)
        self._picks = np.random.default_rng(int(seeds[0]))
        self._sampler = random.Random(int(seeds[1]))
        if self.loop == "open":
            self._gaps = open_gaps(float(traffic["rate_per_s"]),
                                   int(traffic["gap_count"]),
                                   int(traffic["schedule_seed"]),
                                   int(seeds[2]))
            self._gap_i = 0
            self._next_due: Optional[float] = None
        self._order: List[int] = []
        self.inflight: Deque[tuple] = deque()
        self.k = int(traffic["check_requests"])
        self.sample: List[tuple] = []
        self._seen = 0
        self.phases: Dict[str, Phase] = {}
        self._started = False

    # -- sending
    def _pick(self) -> int:
        if not self._order:
            self._order = list(self._picks.permutation(len(self.pool[0])))
        return int(self._order.pop())

    def _send(self, phase: Phase, t_due: float) -> None:
        i = self._pick()
        phase.due += 1
        t_sent = time.perf_counter()
        phase.lateness_s.append(t_sent - t_due)
        try:
            handle = self.server.submit_waveform(self.pool[0][i],
                                                 self.pool[1][i])
        except ServerOverloaded:
            phase.failed += 1
            phase.latency_s.append(math.inf)
            return
        self.inflight.append((handle, i, t_due, phase))

    # -- answers
    def _wait_oldest(self, timeout: float, phase: Optional[Phase]) -> bool:
        """Wait up to `timeout` for the oldest request in flight; True
        when an answer (or an error) came."""
        if not self.inflight:
            if timeout > 0:
                time.sleep(timeout)
            return False
        handle, i, t_due, due_phase = self.inflight[0]
        try:
            payload = handle.result(timeout=max(timeout, 0.0))
        except queue.Empty:
            return False
        except Exception:  # noqa: BLE001 — an errored request fails
            self.inflight.popleft()
            due_phase.failed += 1
            due_phase.latency_s.append(math.inf)
            return True
        t_done = time.perf_counter()
        self.inflight.popleft()
        due_phase.latency_s.append(t_done - t_due)
        if phase is not None and t_done < phase.t_end:
            phase.completed += 1
        if due_phase.name == "window":
            self._keep(i, payload)
        return True

    def _keep(self, i: int, payload) -> None:
        """Reservoir sampling, from the seed, of the window's answers."""
        self._seen += 1
        if len(self.sample) < self.k:
            slot = len(self.sample)
            self.sample.append(None)
        else:
            slot = self._sampler.randrange(self._seen)
            if slot >= self.k:
                return
        waves, masks = payload
        self.sample[slot] = (i, (np.array(waves), np.array(masks)))

    # -- phases
    def run_phase(self, name: str, seconds: float,
                  annotate: bool = False) -> Phase:
        phase = Phase(name, self.server.stats)
        phase.t_end = phase.t0 + seconds
        self.phases[name] = phase
        with span("window") if annotate else nullcontext():
            if self.loop == "closed":
                self._closed(phase)
            else:
                self._open(phase)
        phase.wall_s = time.perf_counter() - phase.t0
        phase.close(self.server.stats)
        return phase

    def _closed(self, phase: Phase) -> None:
        if not self._started:
            self._started = True
            for _ in range(int(self.traffic["clients"])):
                self._send(phase, time.perf_counter())
        while True:
            now = time.perf_counter()
            if now >= phase.t_end:
                return
            if self._wait_oldest(phase.t_end - now, phase):
                self._send(phase, time.perf_counter())

    def _open(self, phase: Phase) -> None:
        if self._next_due is None:
            self._next_due = phase.t0
        while True:
            now = time.perf_counter()
            if self._next_due < phase.t_end and self._next_due <= now:
                self._send(phase, self._next_due)
                self._next_due += float(self._gaps[self._gap_i])
                self._gap_i = (self._gap_i + 1) % len(self._gaps)
                continue
            if now >= phase.t_end:
                return
            self._wait_oldest(min(self._next_due, phase.t_end) - now, phase)

    def drain(self, limit_s: float = 60.0) -> None:
        """Send nothing more; wait for every request in flight, at most
        `limit_s`; the rest fail."""
        deadline = time.perf_counter() + limit_s
        while self.inflight:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            self._wait_oldest(left, None)
        while self.inflight:
            _, _, _, due_phase = self.inflight.popleft()
            due_phase.failed += 1
            due_phase.latency_s.append(math.inf)

