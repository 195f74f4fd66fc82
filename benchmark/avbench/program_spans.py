"""The program's own phase spans on the profiler's timeline.

The port marks the phases of its training step with `record_function`
ranges named `avsep.<phase>` (`av_separation_torch/utils/profiling.py`,
`span`): `data.generate`, `train.forward`, `train.loss`, `train.backward`
and `train.optimizer`.  They do not nest.  A device operation belongs to
the phase whose [start, end] holds the host time of its launch call, on
any thread: the backward's launches come from the autograd engine's
thread while `train.backward` is open on the main one.  An operation
launched outside every phase has none.

`PhaseTimeline` is `trace.Timeline` read from the same events with the
phases (`program_spans`) and each operation's launch time kept.  Every
span, operation, sum and window of the Timeline is left as it is; its
idle gaps add the phase open at a gap's middle to the gap's name
(`step/train.optimizer: host between operations`).  `profiled` builds a
plain Timeline, so no cell reads the phases yet.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, Iterable, List, Optional

from avbench.readers import _per
from avbench.trace import DEVICE_CATS, LAUNCH_CATS, DeviceOp, Timeline

PREFIX = "avsep."


class PhaseTimeline(Timeline):
    """A Timeline with the program's phases: `program_spans` (start, end,
    name without the prefix, tid), sorted by start, and `launch`, each
    device operation's launch time (host µs) or None."""

    def __init__(self, events: Iterable[dict]):
        events = list(events)
        super().__init__(events)
        program, launches, corr_of = [], {}, {}
        for e in events:
            cat = e.get("cat", "")
            if e.get("ph") != "X":
                continue
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat == "user_annotation" and e["name"].startswith(PREFIX):
                program.append((ts, ts + dur, e["name"][len(PREFIX):],
                                e.get("tid")))
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = ts
            elif cat in DEVICE_CATS:
                # Keyed as the Timeline keeps an operation (without its
                # correlation id).
                corr_of[(e["name"], cat, ts, ts + dur)] = \
                    e.get("args", {}).get("correlation")
        self.program_spans = sorted(program)
        self._starts = [s[0] for s in self.program_spans]
        self.launch: Dict[DeviceOp, Optional[float]] = {
            o: launches.get(corr_of.get((o.name, o.cat, o.start, o.end)))
            for o in self.ops}

    def phase_at(self, t: float) -> Optional[str]:
        """The phase open at host time `t`, or None."""
        i = bisect_right(self._starts, t) - 1
        if i >= 0 and t <= self.program_spans[i][1]:
            return self.program_spans[i][2]
        return None

    def phase_of(self, op: DeviceOp) -> Optional[str]:
        launch = self.launch.get(op)
        return None if launch is None else self.phase_at(launch)

    def ops_of_phase(self, phase: Optional[str]) -> List[DeviceOp]:
        """The window's device operations launched in `phase` (None: in
        no phase)."""
        return [o for o in self.in_window() if self.phase_of(o) == phase]

    def _host_at(self, t: float, starts: List[float]) -> str:
        where, host = super()._host_at(t, starts).split(": ", 1)
        phase = self.phase_at(t)
        return f"{where}/{phase}: {host}" if phase else f"{where}: {host}"


def _phase_ops(ctx, phase: str) -> List[DeviceOp]:
    timeline = ctx.timeline
    if not getattr(timeline, "program_spans", None):
        return []
    return timeline.ops_of_phase(phase)


def device_ms_per_step(ctx, phase: str) -> Optional[float]:
    """Device ms of the operations launched in a phase, a traced step;
    None where the trace holds no such operation (a program without the
    phase's span)."""
    ops = _phase_ops(ctx, phase)
    if not ops:
        return None
    return _per(sum(o.seconds for o in ops) * 1e3, ctx.traced["steps"])


def launches_per_step(ctx, phase: str) -> Optional[float]:
    """Device operations launched in a phase, a traced step."""
    ops = _phase_ops(ctx, phase)
    return _per(len(ops), ctx.traced["steps"]) if ops else None
