"""Shared arithmetic of the per-layer metrics' readers (`metrics/*.py`).
A reader takes the run's context and returns a number, or None where it
finds nothing to read; a share of a roofline or a peak is never made 0."""

from __future__ import annotations

from typing import Optional


def _per(total: float, count: float) -> Optional[float]:
    return total / count if count else None


def launches_per_step(ctx, span: str = "step") -> Optional[float]:
    """Device operations (kernels, copies, sets) launched under a span,
    a traced step."""
    ops = ctx.timeline.ops_of(span)
    return _per(len(ops), ctx.traced["steps"]) if ops else None


def device_ms_per_step(ctx, span: str) -> Optional[float]:
    """Device ms of the operations launched under a span, a traced step."""
    ops = ctx.timeline.ops_of(span)
    if not ops:
        return None
    return _per(sum(o.seconds for o in ops) * 1e3, ctx.traced["steps"])


def is_port_kernel(name: str, port_kernels) -> bool:
    return any(k in name for k in port_kernels)


def library_ms_per_step(ctx) -> Optional[float]:
    """Device ms a traced step of the kernels under the step span that are
    not the port's own (cuBLAS, cuDNN, PyTorch's)."""
    ops = [o for o in ctx.timeline.ops_of("step", ("kernel",))
           if not is_port_kernel(o.name, ctx.port_kernels)]
    if not ops:
        return None
    return _per(sum(o.seconds for o in ops) * 1e3, ctx.traced["steps"])


def flash_roofline(ctx, which: str) -> Optional[float]:
    """The flash-attention calls' share of their roofline in the traced
    steps: the least time their work needs (`avbench.roofline`) over the
    device time of the kernels they launched.  Calls are counted by their
    kernels (forward: `flash_fwd*`; backward: one `flash_bwd_dkv*` a call)
    and must be as many as the configuration's layers make, each forward
    call once more under remat; otherwise nothing is read."""
    rf = ctx.roofline
    steps = ctx.traced["steps"]
    batch = int(ctx.traffic["batch_size"])
    calls = rf.attention_calls(ctx.config, batch)
    kernels = [o for o in ctx.timeline.ops_of("step", ("kernel",))
               if f"flash_{which}" in o.name]
    if not kernels:
        return None
    if which == "fwd":
        per_call = rf.flash_fwd_work
        repeat = 2 if ctx.config["model"].get("remat") else 1
        launched = len(kernels)
    else:
        per_call = rf.flash_bwd_work
        repeat = 1
        launched = sum("flash_bwd_dkv" in o.name for o in kernels)
    if launched != len(calls) * repeat * steps:
        return None
    least = sum(rf.least_seconds(*per_call(c), ctx.device_kind)
                for c in calls) * repeat * steps
    device = sum(o.seconds for o in kernels)
    return 100.0 * least / device


def mfu(ctx, samples: float, factor: float) -> Optional[float]:
    """Model FLOPs (`factor` forwards a sample) over the window's wall
    time, as a share of the bf16 peak."""
    wall = ctx.window["wall_s"] if isinstance(ctx.window, dict) \
        else ctx.window.wall_s
    if not samples or not wall:
        return None
    flops = factor * ctx.roofline.model_forward_flops(ctx.config) * samples
    peak = ctx.roofline.peaks(ctx.device_kind)["bf16_flops"]
    return 100.0 * flops / wall / peak


def idle_pct(ctx) -> Optional[float]:
    """One minus the union of device activity over the window traced on
    the device alone."""
    t = ctx.traced["busy_timeline"]
    if t.window_s <= 0 or not t.in_window():
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mean_batch(ctx) -> Optional[float]:
    w = ctx.window
    return _per(w.batched, w.batches)


def copy_ms_per_batch(ctx) -> Optional[float]:
    """Device ms of host<->device copies a batch in the window traced on
    the device alone."""
    ops = [o for o in ctx.traced["busy_timeline"].ops_of(None, ("gpu_memcpy",))
           if "HtoD" in o.name or "DtoH" in o.name]
    batches = ctx.traced["phase"].batches
    if not ops or not batches:
        return None
    return sum(o.seconds for o in ops) * 1e3 / batches
