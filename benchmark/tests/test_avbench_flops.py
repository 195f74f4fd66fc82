"""The frozen FLOP count against PyTorch's own count of the port's plain
CPU forward, at a tiny size."""

from __future__ import annotations

import torch
from conftest import tiny_config
from torch.utils.flop_counter import FlopCounterMode

from avbench import program, roofline
from reference import avsep


def test_model_forward_flops_match_the_counter():
    cfg = tiny_config(compute_dtype="float32", dropout=0.0)
    exp = program.experiment(cfg)
    w = avsep.make_weights(cfg, 3, "cpu")
    net = program.model(exp, w, avsep.bn_buffers(cfg), "cpu").eval()
    batch = avsep.synthetic_batch(3, 0, cfg["data"], 2, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(batch["mixed_spec"], batch["lip_frames"])
    assert counter.get_total_flops() == 2 * roofline.model_forward_flops(cfg)


def test_flash_work_counts_the_products():
    c = roofline.AttentionCall(2, 4, 501, 501, 128)
    flops, nbytes = roofline.flash_fwd_work(c)
    assert flops == 4 * 2 * 4 * 501 * 501 * 128
    assert roofline.flash_bwd_work(c)[0] == 2 * flops
    assert nbytes == 2 * 2 * 4 * 128 * 4 * 501 + 4 * 2 * 4 * 501
