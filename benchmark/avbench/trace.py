"""The profiler's timeline, read from its Chrome trace: device operations,
the host spans that launched them, the busy union and the idle gaps.

Spans are the benchmark's own `record_function` ranges named `bench.*`
around its calls into each layer of the port (`bench.data`, `bench.step`,
`bench.window`).  A device operation belongs to the innermost span open when the host call
that launched it was made (matched by the profiler's correlation id), on
any thread.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from bisect import bisect_right
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def span(name: str):
    """A host span of the benchmark's own, visible on the timeline."""
    import torch
    return torch.profiler.record_function(f"bench.{name}")


def port_kernel_names(csrc: Path) -> List[str]:
    """The names of the port's own kernels: every `__global__` function of
    its CUDA sources."""
    names = set()
    for src in sorted(csrc.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r"__global__", text):
            head = text[m.end():text.find("{", m.end())]
            found = [n for n in re.findall(r"\b(\w+)\s*\(", head)
                     if "kernel" in n]
            if found:
                names.add(found[-1])
    return sorted(names)


class DeviceOp:
    __slots__ = ("name", "cat", "start", "end", "span")

    def __init__(self, name, cat, start, end, span):
        self.name, self.cat, self.start, self.end = name, cat, start, end
        self.span = span

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-6


class Timeline:
    """Device operations (µs on the host's time base) with their spans,
    and the traced window."""

    def __init__(self, events: Iterable[dict]):
        spans, launches, device, host = [], {}, [], []
        for e in events:
            cat = e.get("cat", "")
            if e.get("ph") != "X":
                continue
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat == "user_annotation" and e["name"].startswith("bench."):
                spans.append((ts, ts + dur, e["name"][6:], e.get("tid")))
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = (ts, e.get("tid"))
            elif cat in DEVICE_CATS:
                device.append((e["name"], cat, ts, ts + dur,
                               e.get("args", {}).get("correlation")))
            elif cat == "cpu_op":
                host.append((ts, ts + dur, e["name"]))
        windows = [s for s in spans if s[2] == "window"]
        self.spans = [s for s in spans if s[2] != "window"]
        calls = sorted(launches.values())
        self.host = sorted(host)
        self.ops: List[DeviceOp] = []
        for name, cat, start, end, corr in device:
            launch = launches.get(corr)
            self.ops.append(DeviceOp(name, cat, start, end,
                                     self._span_at(launch)))
        self.ops.sort(key=lambda o: o.start)
        if windows:
            self.window = (windows[0][0], windows[0][1])
        elif self.ops:
            # No span (a trace of the device alone): from the first launch
            # to the end of the last device operation.
            first = min([self.ops[0].start] + [c[0] for c in calls[:1]])
            self.window = (first, max(o.end for o in self.ops))
        else:
            self.window = (0.0, 0.0)

    def _span_at(self, launch) -> Optional[str]:
        if launch is None:
            return None
        ts = launch[0]
        best = None
        # By time on any thread: the backward's launches come from the
        # autograd engine's thread while the step span is open.
        for start, end, name, _ in self.spans:
            if start <= ts <= end and (best is None or start >= best[0]):
                best = (start, name)
        return None if best is None else best[1]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def in_window(self) -> List[DeviceOp]:
        lo, hi = self.window
        return [o for o in self.ops if o.end > lo and o.start < hi]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device activity (kernels, copies, sets) clipped to
        the window."""
        lo, hi = self.window
        merged: List[List[float]] = []
        for o in self.in_window():
            a, b = max(o.start, lo), min(o.end, hi)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def ops_of(self, span: Optional[str] = None,
               cats: Tuple[str, ...] = DEVICE_CATS) -> List[DeviceOp]:
        return [o for o in self.in_window() if o.cat in cats
                and (span is None or o.span == span)]

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, float] = {}
        for o in self.in_window():
            total[o.name] = total.get(o.name, 0.0) + o.seconds
        return [[k[:120], v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest idle gaps of the device in the window, each named by
        the benchmark span and the host operation running at its middle."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [h[0] for h in self.host]
        out = []
        for a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            name = self._host_at(mid, starts)
            out.append([name[:120], (b - a) * 1e-6])
        return out

    def _host_at(self, t: float, starts: List[float]) -> str:
        spans = [s for s in self.spans if s[0] <= t <= s[1]]
        where = spans[-1][2] if spans else "outside spans"
        i = bisect_right(starts, t)
        best = None
        for j in range(i - 1, max(-1, i - 4000), -1):
            start, end, name = self.host[j]
            if end >= t:
                best = name
                break
        return f"{where}: {best or 'host between operations'}"


@contextmanager
def profiled(device_type: str, host: bool = True):
    """A torch.profiler session whose Chrome trace is read into a Timeline
    on exit (`holder[0]`); the trace file lives in TMPDIR and is removed.
    `host` False traces the device alone (its launches and operations, no
    host operations or spans), which costs the host far less: the busy
    and idle shares are read from such a trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host or device_type != "cuda" else []
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    holder: List[Timeline] = []
    prof = profile(activities=acts)
    prof.start()
    try:
        yield holder
    finally:
        prof.stop()
        fd, path = tempfile.mkstemp(prefix="avbench_trace_", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        holder.append(Timeline(events))
