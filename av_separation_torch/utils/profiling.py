"""Timing and tracing helpers (port of `av_separation_tpu/utils/profiling.py`).

- ``trace(logdir)``: a `torch.profiler` window over the block that writes a
  Chrome trace (`trace.json`, viewable in Perfetto) into `logdir`.
- ``span(name)``: the program's own range `avsep.<name>` around one phase
  of its work, on the timeline of whatever profiler runs (that trace, the
  benchmark's, NVTX under `torch.autograd.profiler.emit_nvtx`); with none
  running, a shared null context that costs next to nothing.
- ``Timer``: a wall clock that synchronises the CUDA device before it reads
  the clock, so the time covers the work queued before the call.
- ``step_metrics_line``: one JSON line of metrics per step.
- ``live_memory_bytes``: the bytes the caching allocator holds in tensors
  on a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Trace the CPU and, where there is one, the CUDA device; the trace
    goes to `logdir/trace.json` when the block exits."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> contextlib.AbstractContextManager:
    """`record_function("avsep." + name)` while a profiler is enabled, else
    the one shared null context.  The training step's phases are
    `data.generate`, `train.forward`, `train.loss`, `train.backward` and
    `train.optimizer`; they do not nest."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("avsep." + name)
    return _NO_SPAN


def _synchronize() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Seconds since construction, read after the device has finished the
    work queued so far."""

    def __init__(self):
        _synchronize()
        self.start = time.perf_counter()

    def elapsed(self) -> float:
        _synchronize()
        return time.perf_counter() - self.start


def step_metrics_line(step: int, metrics: Dict[str, Any],
                      extra: Optional[Dict[str, Any]] = None) -> str:
    """One JSON metrics record: the step, every metric as a float where it
    converts (a device tensor is read back here), then `extra`."""
    rec = {"step": step}
    for k, v in metrics.items():
        try:
            rec[k] = float(v)
        except (TypeError, ValueError):
            rec[k] = v
    if extra:
        rec.update(extra)
    return json.dumps(rec)


def live_memory_bytes(device: torch.device | str | None = None
                      ) -> Optional[int]:
    """`torch.cuda.memory_allocated` of `device` (a model's card; the
    current CUDA device when None), or None on the CPU or without an
    initialised CUDA device, as the JAX helper gives None where the
    backend keeps no statistics."""
    if device is None:
        if not torch.cuda.is_initialized():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.memory_allocated(device))
