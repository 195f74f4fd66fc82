"""The port's on-device data generator and fused train steps, on the CPU.

`synthesize` is held against JAX `generate_batch` on the same variates: the
test draws them with the `jax.random` calls of
`av_separation_tpu/data/device_synthetic.py:71-77,126-127` and hands them
to both, with JAX's STFT through XLA and through the Pallas kernel in
interpret mode.  The random draws themselves only have to match in
distribution (a torch generator is not JAX's stream), which the energy test
checks against the host dataset.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from av_separation_tpu.config import DataConfig as JaxDataConfig
from av_separation_tpu.data.device_synthetic import (
    _sine_factor_split as jax_split)
from av_separation_tpu.data.device_synthetic import generate_batch as jax_gen
from av_separation_torch import config as tc
from av_separation_torch.data.device_synthetic import (_sine_factor_split,
                                                       device_batch_iterator,
                                                       draw_variates,
                                                       generate_batch,
                                                       step_generator,
                                                       synthesize)
from av_separation_torch.data.synthetic import SyntheticAVDataset
from av_separation_torch.ops import kernels
from av_separation_torch.train import (create_train_state,
                                       make_fused_train_steps,
                                       make_train_step)

SMALL = dict(num_samples=8, sample_rate=2000, duration=1.0, n_fft=128,
             hop_length=64, num_frames=5, frame_h=16, frame_w=16)
GEOMETRIES = {
    "split 40x50": SMALL,
    "prime 1999, no split": dict(SMALL, sample_rate=1999),
    "demo 8 kHz, n_fft 512": dict(num_samples=8, sample_rate=8000,
                                  duration=1.0, n_fft=512, hop_length=128,
                                  num_frames=25),
    # A 44.1 kHz front end: 20 ms window, 10 ms hop (an odd hop, n_fft
    # 2 mod 4), the shape chip_smoke.py's device_data phase runs on the card.
    "44.1 kHz, n_fft 882, hop 441": dict(num_samples=8, sample_rate=44100,
                                         duration=0.25, n_fft=882,
                                         hop_length=441, num_frames=25),
}


def jax_variates(key, cfg, b):
    """The draws of JAX `generate_batch`, in its order and with its keys."""
    s, nf = cfg.num_speakers, cfg.num_frames
    k_amp, k_jit, k_phase, k_noise = jax.random.split(key, 4)
    h0, h1 = cfg.frame_h // 4, 3 * cfg.frame_h // 4
    w0, w1 = cfg.frame_w // 4, 3 * cfg.frame_w // 4
    return {
        "amps": jax.random.uniform(k_amp, (b, s), minval=0.3, maxval=1.0),
        "jitter": jax.random.uniform(k_jit, (b, s), minval=0.95,
                                     maxval=1.05),
        "phase": jax.random.uniform(k_phase, (b, s), minval=0.0,
                                    maxval=2.0 * np.pi),
        "noise": 0.05 * jax.random.normal(k_noise,
                                          (b, s, nf, h1 - h0, w1 - w0)),
    }


@pytest.mark.parametrize("n", [64000, 1999, 8000])
def test_sine_factor_split_matches_jax_at_config_lengths(n):
    assert _sine_factor_split(n) == jax_split(n)


def test_sine_factor_split_matches_jax_up_to_5000():
    assert [_sine_factor_split(n) for n in range(1, 5001)] == \
        [jax_split(n) for n in range(1, 5001)]
    assert _sine_factor_split(1999) == 0 and _sine_factor_split(64000) == 256


@pytest.mark.parametrize("stft_impl", ["xla", "pallas"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_synthesize_matches_jax_generate_batch(geometry, stft_impl):
    # JAX's angles come from a fused multiply-add; the port rounds them once
    # as well, so the tones agree to float32 rounding and the spectra (peak
    # ~66) to float32 DFT sums in another order.
    kw = GEOMETRIES[geometry]
    jcfg, cfg = JaxDataConfig(**kw), tc.DataConfig(**kw)
    key = jax.random.PRNGKey(3)
    variates = jax_variates(key, jcfg, 3)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_gen(key, jcfg, 3, stft_impl=stft_impl)
    ours = synthesize({k: torch.from_numpy(np.array(v))
                       for k, v in variates.items()}, cfg)
    for name in ("mixed_spec", "clean_specs"):
        assert ours[name].shape == ref[name].shape
        np.testing.assert_allclose(ours[name].numpy(), np.asarray(ref[name]),
                                   atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(ours["lip_frames"].numpy(),
                               np.asarray(ref["lip_frames"]), atol=1e-5)


def test_shapes_ranges_and_device():
    cfg = tc.DataConfig(**SMALL)
    kernels.reset_launch_counts()
    batch = generate_batch(torch.Generator().manual_seed(0), cfg, 4)
    assert batch["mixed_spec"].shape == (4, 65, 32)
    assert batch["lip_frames"].shape == (4, 10, 16, 16)
    assert batch["clean_specs"].shape == (4, 2, 65, 32)
    assert all(v.device.type == "cpu" and v.dtype == torch.float32
               for v in batch.values())
    lips = batch["lip_frames"]
    assert float(lips.min()) >= 0.0 and float(lips.max()) <= 1.0
    assert kernels.LAUNCHES["stft_mag_fwd"] == 0  # the plain version ran


def test_variates_have_the_jax_distributions():
    cfg = tc.DataConfig(**SMALL)
    v = draw_variates(torch.Generator().manual_seed(1), cfg, 4000)
    for name, lo, hi in (("amps", 0.3, 1.0), ("jitter", 0.95, 1.05),
                         ("phase", 0.0, 2 * np.pi)):
        x = v[name].numpy()
        assert x.min() >= lo and x.max() <= hi
        assert abs(x.mean() - (lo + hi) / 2) < 0.02 * (hi - lo)
    assert v["noise"].shape == (4000, 2, 5, 8, 8)
    assert abs(float(v["noise"].std()) - 0.05) < 1e-3


def test_energy_matches_the_host_generator():
    """Spectral energy within 15% of the host dataset's, as
    tests/test_dataset.py holds the JAX generator."""
    cfg = tc.DataConfig(**dict(SMALL, num_samples=64))
    host = SyntheticAVDataset(cfg)
    host_energy = np.mean([np.square(host[i]["mixed_spec"]).mean()
                           for i in range(64)])
    dev = generate_batch(torch.Generator().manual_seed(0), cfg, 64)
    dev_energy = float(dev["mixed_spec"].square().mean())
    assert abs(dev_energy - host_energy) / host_energy < 0.15


def test_each_clean_spectrum_has_one_dominant_band():
    cfg = tc.DataConfig(**SMALL)
    clean = generate_batch(torch.Generator().manual_seed(1), cfg,
                           2)["clean_specs"].numpy()
    for s in range(2):
        prof = clean[0, s].sum(axis=1)
        assert prof[prof.argmax()] > 5 * np.median(prof + 1e-6)


def test_iterator_resumes_statelessly():
    cfg = tc.DataConfig(**SMALL)
    full = device_batch_iterator(cfg, 2, seed=7, device="cpu")
    stream = [next(full) for _ in range(4)]
    resumed = device_batch_iterator(cfg, 2, seed=7, start_step=2,
                                    device="cpu")
    for want in stream[2:]:
        got = next(resumed)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert not torch.equal(stream[0]["mixed_spec"], stream[1]["mixed_spec"])
    other = next(device_batch_iterator(cfg, 2, seed=8, device="cpu"))
    assert not torch.equal(other["mixed_spec"], stream[0]["mixed_spec"])


def test_iterator_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_batch_iterator(tc.DataConfig(**SMALL), 2))


def _tiny_cfg(dropout):
    return tc.ExperimentConfig(
        name="tiny",
        model=tc.ModelConfig(freq_bins=65, d_model=64, nhead=2,
                             num_encoder_layers=1, num_fusion_layers=1,
                             dropout=dropout),
        data=tc.DataConfig(**SMALL),
        train=tc.TrainConfig(batch_size=2, seed=4))


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_fused_steps_equal_single_steps_on_the_same_batches(dropout):
    cfg = _tiny_cfg(dropout)
    fused_state, loss = make_fused_train_steps(cfg, 3)(
        create_train_state(cfg, device="cpu"))
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg)
    for _ in range(3):
        batch = generate_batch(step_generator(cfg.train.seed + 17,
                                              state.step, "cpu"),
                               cfg.data, cfg.train.batch_size)
        state, metrics = step(state, batch)
    assert fused_state.step == state.step == 3
    assert torch.equal(loss, metrics["loss"])
    want = state.model.state_dict()
    for name, got in fused_state.model.state_dict().items():
        assert torch.equal(got, want[name]), name


def test_fused_steps_continue_the_stream_by_step():
    # Two calls of K = 2 and one of K = 4 see the same four batches.
    cfg = _tiny_cfg(0.0)
    two = make_fused_train_steps(cfg, 2)
    state, _ = two(create_train_state(cfg, device="cpu"))
    state, loss = two(state)
    ref, ref_loss = make_fused_train_steps(cfg, 4)(
        create_train_state(cfg, device="cpu"))
    assert torch.equal(loss, ref_loss)
