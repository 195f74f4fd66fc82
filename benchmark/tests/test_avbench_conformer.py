"""The conformer cell's pieces on the CPU at a tiny size: its reference
against the port's plain path through the harness (clean runs correct,
planted faults not), its frozen FLOP count against PyTorch's counter, its
readers on a trace that holds the kernels' calls or lacks them."""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest
import torch
from cells import TRAIN, TRAIN_LIMITS
from conftest import build_bench, tiny_config
from test_avbench_runs import _half_batch, _unchanged
from torch.utils.flop_counter import FlopCounterMode

from avbench import conformer_work, harness, program, train_cell
from avbench.manifest import Cell, load_module

CELL = "tiny.train_b64"


def conformer_config(**model) -> dict:
    cfg = tiny_config(encoder_block="conformer", conv_kernel=7, **model)
    cfg["reference"] = "avsep_conformer"
    return cfg


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("conformer_bench")
    b = build_bench(root, {CELL: (TRAIN, TRAIN_LIMITS)}, conformer_config())
    return json.loads((root / "BENCHMARK.json").read_text()), b


def _run(bench, trace=False):
    manifest, b = bench
    return harness.run(Cell(manifest, CELL, b), 2**31 + 23, 0.5, trace,
                       torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_clean_run_is_correct(bench, trace):
    out = _run(bench, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_planted_fault_is_not_correct(bench, fault, monkeypatch):
    plant = {"unchanged": _unchanged, "half_batch": _half_batch}[fault]
    monkeypatch.setattr(train_cell, "make_train_step",
                        plant(train_cell.make_train_step))
    assert not _run(bench)["correct"]


def test_model_forward_flops_match_the_counter(bench):
    _, b = bench
    ref = load_module(b / "reference" / "avsep_conformer.py", "ref_conf")
    cfg = conformer_config(compute_dtype="float32", dropout=0.0)
    exp = program.experiment(cfg)
    w = ref.make_weights(cfg, 3, "cpu")
    net = program.model(exp, w, ref.bn_buffers(cfg), "cpu").eval()
    batch = ref.synthetic_batch(3, 0, cfg["data"], 2, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(batch["mixed_spec"], batch["lip_frames"])
    assert counter.get_total_flops() \
        == 2 * conformer_work.model_forward_flops(cfg)


class _Op:
    def __init__(self, name, seconds):
        self.name, self.seconds = name, seconds


def _ctx(names, steps=2, remat=False):
    cfg = conformer_config(remat=remat)
    ops = [_Op(n, 1e-5) for n in names]
    timeline = SimpleNamespace(ops_of=lambda span, cats=None: ops)
    return SimpleNamespace(config=cfg, traffic={"batch_size": 4},
                           traced={"steps": steps}, timeline=timeline,
                           device_kind="NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("remat", [False, True])
def test_roofline_reads_only_whole_calls(remat):
    layers = 2 * TINY_LAYERS
    fwd = ["void (anonymous namespace)::glu_dwconv_fwd_kernel<float, 7>()"]
    bwd = ["void (anonymous namespace)::glu_dwconv_bwd_kernel<float, 7>()",
           "void (anonymous namespace)::glu_dwconv_bwd_reduce_kernel<float,"
           " 7>()"]
    calls = layers * 2 * (2 if remat else 1)
    ctx = _ctx(fwd * calls + bwd * layers * 2, remat=remat)
    assert conformer_work.dwconv_roofline(ctx, "fwd") > 0
    assert conformer_work.dwconv_roofline(ctx, "bwd") > 0
    short = _ctx(fwd * (calls - 1) + bwd * (layers * 2 - 1), remat=remat)
    assert conformer_work.dwconv_roofline(short, "fwd") is None
    assert conformer_work.dwconv_roofline(short, "bwd") is None


def test_readers_find_nothing_without_the_kernels():
    ctx = _ctx(["flash_fwd_kernel_wgmma"])
    assert conformer_work.dwconv_roofline(ctx, "fwd") is None
    assert conformer_work.dwconv_roofline(ctx, "bwd") is None


def test_mfu_prices_three_forwards():
    ctx = _ctx([])
    ctx.window = {"steps": 10, "wall_s": 2.0}
    want = 3 * conformer_work.model_forward_flops(ctx.config) * 40 / 2.0
    assert conformer_work.mfu(ctx) == pytest.approx(100 * want / 989e12)
    ctx.config = tiny_config()
    assert conformer_work.mfu(ctx) is None


TINY_LAYERS = conformer_config()["model"]["num_encoder_layers"]
