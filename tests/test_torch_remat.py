"""Remat (`ModelConfig.remat`): each encoder and fusion layer is recomputed
in the backward instead of keeping its activations, with the layer's own
dropout draws replayed from the explicit generators.  So a remat step is
the no-remat step, bit for bit on the CPU, at dropout 0 and at dropout 0.1
(the JAX package checks remat at dropout 0 only, tests/test_train.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from av_separation_tpu import config as jc
from av_separation_torch import config as tc
from av_separation_torch.models.layers import Generators, remat_layer
from av_separation_torch.train import create_train_state, make_train_step

MODEL = dict(freq_bins=65, d_model=64, nhead=2, num_encoder_layers=1,
             num_fusion_layers=1, num_speakers=2)
DATA = dict(num_samples=4, sample_rate=2048, duration=1.0, n_fft=128,
            hop_length=64, num_frames=5, frame_h=16, frame_w=16)


def batch(seed=0, b=2):
    d = tc.DataConfig(**DATA)
    rng = np.random.default_rng(seed)
    return {"mixed_spec": np.abs(rng.normal(
                size=(b, d.freq_bins, d.num_stft_frames))).astype(np.float32),
            "lip_frames": rng.uniform(
                size=(b, d.total_lip_frames, d.frame_h, d.frame_w)
            ).astype(np.float32),
            "clean_specs": np.abs(rng.normal(
                size=(b, 2, d.freq_bins, d.num_stft_frames))
            ).astype(np.float32)}


def run(remat: bool, dropout: float, dtype: str = "float32", steps=1):
    """Loss, grad norm and every gradient of each of `steps` steps."""
    cfg = tc.ExperimentConfig(
        name="remat", model=tc.ModelConfig(**MODEL, dropout=dropout,
                                           compute_dtype=dtype, remat=remat),
        data=tc.DataConfig(**DATA), train=tc.TrainConfig(batch_size=2))
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg)
    out = []
    for i in range(steps):
        state, m = step(state, batch(i))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {n: p.grad.clone() for n, p in
                     state.model.named_parameters() if p.grad is not None}))
    return out


class TestRemat:
    @pytest.mark.parametrize("dropout,dtype", [
        (0.0, "float32"), (0.1, "float32"), (0.1, "bfloat16")])
    def test_remat_step_is_the_plain_step(self, dropout, dtype):
        plain, remat = run(False, dropout, dtype), run(True, dropout, dtype)
        for (l0, n0, g0), (l1, n1, g1) in zip(plain, remat):
            assert l0 == l1 and n0 == n1
            assert g0.keys() == g1.keys()
            for name in g0:
                assert torch.equal(g0[name], g1[name]), name

    def test_generators_advance_once(self):
        """A rematerialised layer draws its seeds and bits once: after a
        step the generators stand where the plain step leaves them."""
        states = {}
        for remat in (False, True):
            cfg = tc.ExperimentConfig(
                name="remat", model=tc.ModelConfig(**MODEL, dropout=0.1,
                                                   remat=remat),
                data=tc.DataConfig(**DATA),
                train=tc.TrainConfig(batch_size=2))
            state = create_train_state(cfg, device="cpu")
            state, _ = make_train_step(cfg)(state, batch())
            states[remat] = (state.generators.seeds.get_state(),
                             state.generators.bits.get_state())
        assert all(torch.equal(a, b) for a, b in zip(states[False],
                                                     states[True]))

    def test_remat_layer_replays_the_draws(self):
        """A layer that draws from both generators: the recompute in the
        backward sees the first run's draws."""
        calls = []

        class Draws(torch.nn.Module):
            def forward(self, x, gens):
                s = torch.rand(1, generator=gens.seeds)
                b = torch.rand(x.shape, generator=gens.bits)
                calls.append((float(s), b.clone()))
                return x * b * s

        gens = Generators(torch.Generator().manual_seed(3),
                          torch.Generator().manual_seed(4))
        x = torch.ones(5, requires_grad=True)
        y = remat_layer(Draws(), gens, x)
        y.sum().backward()
        assert len(calls) == 2
        assert calls[0][0] == calls[1][0]
        assert torch.equal(calls[0][1], calls[1][1])
        assert torch.equal(x.grad, calls[0][1] * calls[0][0])

    def test_multihost_sets_remat_as_in_jax(self):
        assert tc.get_config("multihost").model.remat is True
        assert jc.get_config("multihost").model.remat is True
        for name in ("demo", "scaled", "three_speaker", "lrs2"):
            assert tc.get_config(name).model.remat is False
        assert not tc.ModelConfig().remat

    def test_eval_ignores_remat(self):
        cfg = dataclasses.replace(tc.ModelConfig(**MODEL), remat=True)
        from av_separation_torch.models.model import build_model
        a = build_model(cfg, device="cpu", seed=1)
        b = build_model(dataclasses.replace(cfg, remat=False), device="cpu",
                        seed=1)
        x = batch()
        args = [torch.from_numpy(x[k]) for k in ("mixed_spec", "lip_frames")]
        with torch.inference_mode():
            assert all(torch.equal(p, q) for p, q in zip(a(*args), b(*args)))
