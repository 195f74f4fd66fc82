"""The program's phase spans on a synthetic trace: the accepted training
readers read the same numbers with and without `avsep.*` ranges in the
trace (plain Timeline or PhaseTimeline); a launch on another thread
inside `train.backward` is the backward's; a launch outside every phase
has none; idle gaps name the phase."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from conftest import BENCH, ROOT, tiny_config

from avbench import program_spans, roofline
from avbench.manifest import load_manifest, load_module
from avbench.program_spans import PhaseTimeline
from avbench.trace import Timeline

MANIFEST = load_manifest(ROOT)
TRAIN_READERS = [m["name"] for m in MANIFEST["per_layer"]
                 if "scaled_bf16.train_b128" in m.get("workloads", [])]
PORT_KERNELS = ["flash_fwd_kernel_wgmma", "flash_bwd_dkv_kernel_wgmma",
                "flash_bwd_dq_kernel_wgmma", "stft_mag_kernel"]
STEPS, BATCH = 2, 4
MAIN, AUTOGRAD = 1, 2
# One step, µs from its start: (phase, start, end) of the program's spans.
PHASES = [("data.generate", 5, 95), ("train.forward", 110, 400),
          ("train.loss", 400, 450), ("train.backward", 460, 850),
          ("train.optimizer", 860, 990)]


class Events:
    """A Chrome trace's events, as `torch.profiler` writes them."""

    def __init__(self):
        self.list, self.corr = [], 0

    def span(self, name, start, end, tid=MAIN):
        self.list.append({"ph": "X", "cat": "user_annotation", "name": name,
                          "ts": start, "dur": end - start, "tid": tid})

    def host(self, name, start, end, tid=MAIN):
        self.list.append({"ph": "X", "cat": "cpu_op", "name": name,
                          "ts": start, "dur": end - start, "tid": tid})

    def launch(self, at, kernel, start, dur, tid=MAIN, cat="kernel"):
        self.corr += 1
        self.list.append({"ph": "X", "cat": "cuda_runtime",
                          "name": "cudaLaunchKernel", "ts": at, "dur": 2,
                          "tid": tid, "args": {"correlation": self.corr}})
        self.list.append({"ph": "X", "cat": cat, "name": kernel,
                          "ts": start, "dur": dur, "tid": 7,
                          "args": {"correlation": self.corr}})


def trace(program: bool = True) -> list:
    """Two steps of a tiny training cell, launches on the main and the
    autograd threads; with `program`, the port's phase spans too."""
    calls = len(roofline.attention_calls(tiny_config(), BATCH))
    ev = Events()
    ev.span("bench.window", 0, STEPS * 1000 + 50)
    for i in range(STEPS):
        s = i * 1000
        ev.span("bench.data", s, s + 100)
        ev.span("bench.step", s + 100, s + 1000)
        if program:
            for name, a, b in PHASES:
                ev.span("avsep." + name, s + a, s + b)
        ev.launch(s + 20, "stft_mag_kernel", s + 30, 40)
        for c in range(calls):
            ev.launch(s + 120 + 10 * c, "flash_fwd_kernel_wgmma", s + 130
                      + 20 * c, 15)
        ev.launch(s + 200, "nvjet_gemm", s + 210, 60)
        ev.host("aten::addmm", s + 280, s + 400)
        ev.launch(s + 410, "at::native::reduce_kernel", s + 420, 20)
        # Between the loss and the backward: in the step, in no phase.
        ev.launch(s + 455, "at::native::fill_kernel", s + 456, 3,
                  cat="gpu_memset")
        for c in range(calls):
            ev.launch(s + 470 + 20 * c, "flash_bwd_dkv_kernel_wgmma",
                      s + 480 + 40 * c, 30, tid=AUTOGRAD)
            ev.launch(s + 475 + 20 * c, "flash_bwd_dq_kernel_wgmma",
                      s + 500 + 40 * c, 15, tid=AUTOGRAD)
        ev.launch(s + 700, "at::native::where_kernel", s + 705, 100,
                  tid=AUTOGRAD)
        ev.launch(s + 870, "multi_tensor_apply_kernel", s + 880, 50)
        ev.launch(s + 880, "at::native::square_kernel", s + 992, 5)
    return ev.list


def context(timeline) -> SimpleNamespace:
    return SimpleNamespace(
        config=tiny_config(), traffic={"batch_size": BATCH},
        timeline=timeline, window={"steps": 40, "wall_s": 1.0},
        traced={"steps": STEPS, "timeline": timeline,
                "busy_timeline": timeline},
        device_kind="NVIDIA H100 80GB HBM3", roofline=roofline,
        port_kernels=PORT_KERNELS)


def read(metric: str, timeline):
    reader = load_module(BENCH / "metrics" / f"{metric}.py",
                         f"avbench_metric_{metric}")
    return reader.read(context(timeline))


def test_the_training_cells_have_seven_readers():
    assert len(TRAIN_READERS) == 7


@pytest.mark.parametrize("metric", TRAIN_READERS)
def test_a_reader_reads_the_same_with_and_without_program_spans(metric):
    plain = read(metric, Timeline(trace(program=False)))
    assert plain is not None
    assert read(metric, Timeline(trace())) == plain
    assert read(metric, PhaseTimeline(trace())) == plain
    assert read(metric, PhaseTimeline(trace(program=False))) == plain


def test_program_spans_change_no_span_op_or_window():
    plain, phased = Timeline(trace(program=False)), PhaseTimeline(trace())
    assert phased.spans == plain.spans and phased.window == plain.window
    assert [(o.name, o.start, o.end, o.span) for o in phased.ops] == \
        [(o.name, o.start, o.end, o.span) for o in plain.ops]
    assert [n for _, _, n, _ in phased.program_spans] == \
        [n for n, _, _ in PHASES] * STEPS


def test_a_launch_on_another_thread_inside_the_backward_is_the_backward():
    t = PhaseTimeline(trace())
    dkv = [o for o in t.ops if o.name == "flash_bwd_dkv_kernel_wgmma"]
    assert dkv and all(t.phase_of(o) == "train.backward" for o in dkv)
    where = [o for o in t.ops if o.name == "at::native::where_kernel"]
    assert [t.phase_of(o) for o in where] == ["train.backward"] * STEPS
    # Run on the device after its span has closed: the launch decides.
    late = [o for o in t.ops if o.name == "at::native::square_kernel"]
    assert [t.phase_of(o) for o in late] == ["train.optimizer"] * STEPS


def test_a_launch_outside_every_phase_has_none():
    t = PhaseTimeline(trace())
    fills = [o for o in t.ops if o.name == "at::native::fill_kernel"]
    assert fills and all(t.phase_of(o) is None for o in fills)
    assert all(o.span == "step" for o in fills)
    assert all(t.phase_of(o) is None for o in PhaseTimeline(
        trace(program=False)).ops)


def test_phase_readers():
    t = PhaseTimeline(trace())
    ctx = context(t)
    calls = len(roofline.attention_calls(tiny_config(), BATCH))
    assert program_spans.launches_per_step(ctx, "train.backward") \
        == 2 * calls + 1
    assert program_spans.device_ms_per_step(ctx, "train.optimizer") \
        == pytest.approx((50 + 5) * 1e-3)
    assert program_spans.device_ms_per_step(ctx, "data.generate") \
        == pytest.approx(40 * 1e-3)
    step = {p: program_spans.launches_per_step(ctx, p) for p, _, _ in PHASES
            if p != "data.generate"}
    # The phases hold every launch of the step but the one between them.
    assert sum(step.values()) + 1 == len(t.ops_of("step")) / STEPS
    for timeline in (Timeline(trace()), PhaseTimeline(trace(program=False))):
        assert program_spans.device_ms_per_step(
            context(timeline), "train.forward") is None
        assert program_spans.launches_per_step(
            context(timeline), "train.forward") is None


def test_idle_gaps_name_the_phase():
    plain = Timeline(trace(program=False)).idle_gaps(40)
    phased = PhaseTimeline(trace()).idle_gaps(40)
    assert [g[1] for g in phased] == [g[1] for g in plain]
    names = [g[0] for g in phased]
    assert "step/train.backward: host between operations" in names
    assert "step/train.forward: aten::addmm" in names
    assert "data/data.generate: host between operations" in names
    assert all(n.split(": ", 1)[0] in ("step", "data", "outside spans")
               for n in (g[0] for g in plain))
