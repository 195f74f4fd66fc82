"""The port's own phase spans (`utils/profiling.py:span`): one training
step under a CPU profiler holds `avsep.data.generate`, `train.forward`,
`train.loss`, `train.backward` and `train.optimizer` once each, in that
order and without overlap; remat's recompute runs inside the backward's
span; with no profiler the spans are one shared null context; and the
command line's `--profile-dir` trace holds them.
"""

import contextlib
import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from av_separation_torch import cli
from av_separation_torch.config import get_config
from av_separation_torch.data.device_synthetic import (generate_batch,
                                                       step_generator)
from av_separation_torch.train import create_train_state, make_train_step
from av_separation_torch.utils import profiling

PHASES = ["data.generate", "train.forward", "train.loss", "train.backward",
          "train.optimizer"]


def demo(remat: bool = False):
    cfg = get_config("demo")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, remat=remat),
        train=dataclasses.replace(cfg.train, batch_size=2))


def traced_step(cfg):
    """The profiler's events of one generated batch and one step."""
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batch = generate_batch(step_generator(0, 0, "cpu"), cfg.data,
                               cfg.train.batch_size)
        step(state, batch)
    return prof.events()


def phases(events):
    """(start, end, phase) of the program's spans, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name[6:])
                  for e in events if e.name.startswith("avsep."))


def test_a_step_holds_the_five_phases_in_order():
    spans = phases(traced_step(demo()))
    assert [name for _, _, name in spans] == PHASES
    for (s0, e0, _), (s1, e1, _) in zip(spans, spans[1:]):
        assert s0 <= e0 <= s1 <= e1


def test_remat_recompute_falls_inside_the_backward():
    counts = {}
    for remat in (False, True):
        events = traced_step(demo(remat))
        where = {name: (s, e) for s, e, name in phases(events)}
        for op in ("FlashAttention", "aten::native_layer_norm"):
            for phase in ("train.forward", "train.backward"):
                s, e = where[phase]
                counts[remat, op, phase] = sum(
                    1 for ev in events if ev.name == op
                    and s <= ev.time_range.start <= e)
    for op in ("FlashAttention", "aten::native_layer_norm"):
        fwd = counts[False, op, "train.forward"]
        assert fwd > 0 and counts[True, op, "train.forward"] == fwd
        assert counts[False, op, "train.backward"] == 0
        assert counts[True, op, "train.backward"] > 0
    # Every attention call is in an encoder or fusion layer: all recomputed.
    assert counts[True, "FlashAttention", "train.backward"] \
        == counts[True, "FlashAttention", "train.forward"]


def test_without_a_profiler_a_span_is_the_shared_null_context(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("train.forward")
    assert isinstance(first, contextlib.nullcontext)
    assert profiling.span("train.optimizer") is first
    with first, first:
        pass


def test_under_a_profiler_a_span_is_a_named_record_function():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = profiling.span("train.loss")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            torch.ones(2).sum()
    assert [e.name for e in prof.events()
            if e.name.startswith("avsep.")] == ["avsep.train.loss"]


@pytest.mark.parametrize("pipeline,per_step", [
    (["--data", "host"], PHASES[1:]),
    (["--data", "device"], PHASES),
    (["--data", "device", "--fused"], PHASES)])
def test_cli_profile_dir_trace_holds_the_phases(tmp_path, capsys, pipeline,
                                                per_step):
    argv = ["train", "--config", "demo", "--cpu", "--batch", "2", "--steps",
            "2", *pipeline, "--profile-dir", str(tmp_path)]
    assert cli.main(argv) == 0
    capsys.readouterr()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = sorted((e["ts"], e["name"][6:]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("avsep."))
    assert [name for _, name in spans] == per_step * 2
