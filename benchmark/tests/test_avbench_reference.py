"""The plain reference against the port's plain CPU path at a tiny size,
and the control (the reference in float8) against both.  Only this test
imports both sides; the reference imports neither the port nor JAX."""

from __future__ import annotations

import pytest
import torch
from conftest import tiny_config

from av_separation_torch.data.device_synthetic import (generate_batch,
                                                       step_generator)
from av_separation_torch.models.layers import Generators
from av_separation_torch.train import (TrainState, make_optimizer,
                                       make_train_step)
from avbench import compare, program
from reference import avsep

SEED = 123


def _model(cfg):
    exp = program.experiment(cfg, 4)
    w = avsep.make_weights(cfg, SEED, "cpu")
    return exp, program.model(exp, w, avsep.bn_buffers(cfg), "cpu")


@pytest.mark.parametrize("dtype,limit", [("float32", 1e-6),
                                         ("bfloat16", 5e-3)])
def test_eval_forward_matches(dtype, limit):
    cfg = tiny_config(compute_dtype=dtype)
    _, net = _model(cfg)
    batch = avsep.synthetic_batch(7, 0, cfg["data"], 4, "cpu")
    stats = {k: (torch.zeros(s) if k.endswith("mean") else torch.ones(s))
             for k, s in avsep.bn_buffers(cfg).items()}
    with torch.no_grad():
        _, masks = net.eval()(batch["mixed_spec"], batch["lip_frames"])
        w = avsep.make_weights(cfg, SEED, "cpu")
        _, ref = avsep.Model(cfg, avsep.Numerics(dtype)).forward(
            w, batch["mixed_spec"], batch["lip_frames"], None, stats)
        _, ctrl = avsep.Model(cfg, avsep.Numerics("fp8")).forward(
            w, batch["mixed_spec"], batch["lip_frames"], None, stats)
    gap = compare.abs_max(masks, ref)
    assert gap < limit
    assert compare.abs_max(ctrl, ref) > 3 * max(gap, 1e-3)


def test_generated_batch_matches():
    cfg = tiny_config()
    exp = program.experiment(cfg, 4)
    prog = generate_batch(step_generator(7, 0, "cpu"), exp.data, 4)
    ref = avsep.synthetic_batch(7, 0, cfg["data"], 4, "cpu")
    for k in ref:
        assert compare.rel_max(prog[k], ref[k]) < 1e-4, k


@pytest.mark.parametrize("dtype,remat", [("float32", False),
                                         ("bfloat16", False),
                                         ("bfloat16", True)])
def test_training_steps_match(dtype, remat):
    cfg = tiny_config(compute_dtype=dtype, remat=remat)
    exp, net = _model(cfg)
    state = TrainState(0, net.train(), make_optimizer(exp, net.parameters()),
                       Generators(torch.Generator().manual_seed(11),
                                  torch.Generator().manual_seed(12)))
    step = make_train_step(exp)
    start = {k: v.detach().clone() for k, v in net.named_parameters()}
    losses, grads = [], None
    for i in range(3):
        batch = generate_batch(step_generator(7, i, "cpu"), exp.data, 4)
        _, met = step(state, batch)
        losses.append(float(met["loss"]))
        if i == 0:
            adam = state.optimizer.adam
            grads = {k: float(adam.state[p]["exp_avg"].norm() / 0.1)
                     for k, p in net.named_parameters()}
    change = {k: float((v.detach() - start[k]).norm())
              for k, v in net.named_parameters()}
    batches = [avsep.synthetic_batch(7, i, cfg["data"], 4, "cpu")
               for i in range(3)]

    def ref(kind):
        return avsep.train_steps(
            cfg, avsep.make_weights(cfg, SEED, "cpu"), batches,
            avsep.Draws(torch.Generator().manual_seed(11),
                        torch.Generator().manual_seed(12)),
            avsep.Numerics(kind))

    r = ref(dtype)
    loss_gap = max(abs(a - b) for a, b in zip(losses, r["losses"]))
    grad_gap = compare.leaf_gap(grads, r["grad_norms"])
    assert loss_gap < (1e-5 if dtype == "float32" else 1e-3)
    assert grad_gap < (1e-5 if dtype == "float32" else 2e-3)
    assert compare.leaf_gap(change, r["change_norms"],
                            compare.moving_leaves(r["grad_norms"])) < 0.5
    if dtype == "bfloat16" and not remat:
        c = ref("fp8")
        assert compare.leaf_gap(c["grad_norms"], r["grad_norms"]) \
            > 3 * grad_gap
