"""`--debug-nans` (`av_separation_torch/utils/debug.py`) on the CPU, beside
the JAX step under `jax_debug_nans` (tests/test_debug.py's tiny config).

A NaN in a step raises FloatingPointError naming what produced it (the
first module whose output holds it; the backward function, the flash
kernels' autograd.Function among them), where the JAX step raises too; a
clean step under the checks equals one without them bit for bit; with the
flag off nothing is registered.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av_separation_tpu import config as jc
from av_separation_tpu.train import create_train_state as jax_create
from av_separation_tpu.train import make_train_step as jax_make_step
from av_separation_torch import cli
from av_separation_torch import config as tc
from av_separation_torch.ops.kernels import attention as kattn
from av_separation_torch.train import (create_train_state, make_eval_step,
                                       make_train_step)
from av_separation_torch.utils.debug import debug_nans

MODEL = dict(freq_bins=65, d_model=32, nhead=2, num_encoder_layers=1,
             num_fusion_layers=1, num_speakers=2, dropout=0.0)
DATA = dict(num_samples=8, sample_rate=2048, duration=1.0, n_fft=128,
            hop_length=64, num_frames=5, frame_h=16, frame_w=16)
CFG = tc.ExperimentConfig(name="tiny", model=tc.ModelConfig(**MODEL),
                          data=tc.DataConfig(**DATA),
                          train=tc.TrainConfig(batch_size=2, steps=1))
JCFG = jc.ExperimentConfig(name="tiny", model=jc.ModelConfig(**MODEL),
                           data=jc.DataConfig(**DATA),
                           train=jc.TrainConfig(batch_size=2, steps=1))


def batch(poison=None, value=np.nan):
    """tests/test_debug.py's batch, with one value of `poison` set."""
    d = CFG.data
    rng = np.random.default_rng(0)
    out = {
        "mixed_spec": np.abs(rng.normal(
            size=(2, d.freq_bins, d.num_stft_frames))).astype(np.float32),
        "lip_frames": rng.uniform(size=(2, d.total_lip_frames, d.frame_h,
                                        d.frame_w)).astype(np.float32),
        "clean_specs": np.abs(rng.normal(
            size=(2, 2, d.freq_bins, d.num_stft_frames))).astype(np.float32)}
    if poison:
        out[poison][0].flat[0] = value
    return out


def no_hooks(model):
    return all(not m._forward_hooks for m in model.modules())


@pytest.fixture()
def jax_debug_nans():
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", False)


@pytest.mark.parametrize("poison,where", [
    ("mixed_spec", "module audio_encoder.projection (Projection)"),
    ("lip_frames", "module visual_encoder.conv.0 (Conv2d)"),
    ("clean_specs", "NaN in the backward")])
def test_a_poisoned_step_raises_in_both(jax_debug_nans, poison, where):
    state = create_train_state(CFG, device="cpu")
    with pytest.raises(FloatingPointError, match=where.replace(
            "(", r"\(").replace(")", r"\)")):
        with debug_nans(state.model):
            make_train_step(CFG)(state, batch(poison))
    assert no_hooks(state.model) and not torch.is_anomaly_enabled()
    model, jstate = jax_create(JCFG)
    with pytest.raises(FloatingPointError):
        _, m = jax_make_step(model, JCFG)(
            jstate, {k: jnp.asarray(v) for k, v in batch(poison).items()})
        jax.block_until_ready(m["loss"])


def test_the_backward_names_the_flash_function(monkeypatch):
    """A NaN that first appears in the flash backward is reported at the
    flash kernels' autograd.Function."""
    def nan_bwd(q, k, v, o, do, lse, rate, seed):
        return tuple(torch.full_like(t, float("nan")) for t in (q, k, v))

    monkeypatch.setattr(kattn, "flash_attn_bwd", nan_bwd)
    state = create_train_state(CFG, device="cpu")
    with pytest.raises(FloatingPointError, match="FlashAttentionBackward"):
        with debug_nans(state.model):
            make_train_step(CFG)(state, batch())


def test_the_eval_step_raises_too():
    state = create_train_state(CFG, device="cpu")
    with pytest.raises(FloatingPointError, match="audio_encoder.projection"):
        with debug_nans(state.model):
            make_eval_step()(state.model, batch("mixed_spec"))


def test_an_infinity_passes_as_in_jax():
    """NaN only: jax_debug_nans lets an inf through (jax_debug_infs is
    another flag).  A module's output is named by its qualified name."""
    model = torch.nn.Sequential(torch.nn.Identity(), torch.nn.ReLU())
    with debug_nans(model):
        out = model(torch.tensor([float("inf"), -1.0, 2.0]))
        assert out.tolist() == [float("inf"), 0.0, 2.0]
        with pytest.raises(FloatingPointError, match=r"module 0 \(Identity"):
            model(torch.tensor([float("nan"), 1.0]))
    x = jnp.asarray([np.inf, -1.0])
    jax.config.update("jax_debug_nans", True)
    try:
        assert float(jax.jit(jax.nn.relu)(x)[0]) == np.inf
    finally:
        jax.config.update("jax_debug_nans", False)


def test_a_clean_step_is_bit_equal_with_and_without():
    """Dropout 0.1, so the generators are drawn from: the checks only
    read."""
    cfg = dataclasses.replace(CFG, model=dataclasses.replace(
        CFG.model, dropout=0.1))
    step = make_train_step(cfg)
    runs = []
    for checked in (False, True):
        state = create_train_state(cfg, device="cpu")
        with debug_nans(state.model) if checked else \
                torch.autograd.set_grad_enabled(True):
            for _ in range(2):
                state, m = step(state, batch())
        runs.append((m, state.model.state_dict(),
                     state.generators.seeds.get_state()))
    (m0, w0, g0), (m1, w1, g1) = runs
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert all(torch.equal(w0[k], w1[k]) for k in w0)
    assert torch.equal(g0, g1)


def test_nothing_is_registered_with_the_flag_off():
    state = create_train_state(CFG, device="cpu")
    for flag, hooked in ((False, False), (True, True)):
        args = argparse.Namespace(debug_nans=flag)
        with cli._nan_checks(args, state.model):
            assert no_hooks(state.model) is not hooked
            assert torch.is_anomaly_enabled() is hooked
        assert no_hooks(state.model) and not torch.is_anomaly_enabled()
