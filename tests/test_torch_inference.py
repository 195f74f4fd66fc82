"""The port's serving path against the JAX package: STFT, interpolation,
masked iSTFT, SI-SNR, Separator (spectrogram and waveform APIs, with batch
buckets), the batching server, and the synthetic data.

Inputs are made with numpy from a seed; the JAX side runs its XLA paths on
the CPU.  Tolerances: float32 on both sides with sums in another order.  The
iSTFT divides by the summed squared window, which is ~1e-9 next to the first
sample, so edge samples carry amplified rounding: waveforms are compared
tightly on the interior and relative to their peak over the whole.
"""

import threading

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from av_separation_tpu.config import DataConfig as JaxDataConfig
from av_separation_tpu.config import ModelConfig as JaxModelConfig
from av_separation_tpu.inference import Separator as JaxSeparator
from av_separation_tpu.models.model import AVSeparationTransformer as JaxModel
from av_separation_torch.config import DataConfig, ModelConfig
from av_separation_torch.data.synthetic import SyntheticAVDataset
from av_separation_torch.inference import Separator, bucket_batch
from av_separation_torch.ops.interpolate import interpolate_time_linear
from av_separation_torch.ops.istft import masked_istft, si_snr_waveform
from av_separation_torch.ops.stft import stft_magnitude
from av_separation_torch.serving import BatchingSeparatorServer
from av_separation_torch.utils.transplant import from_jax_variables

SMALL = dict(freq_bins=65, d_model=64, nhead=2, num_encoder_layers=1,
             num_fusion_layers=1, num_speakers=2, dropout=0.1)
DATA = dict(sample_rate=2000, duration=1.0, n_fft=128, hop_length=64,
            num_frames=5, frame_h=16, frame_w=16)
N_AUDIO, T = 2000, 32
EDGE = 128 - 64  # n_fft - hop samples at each end are least-squares edges


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def separators():
    """(JAX Separator, port Separator on the CPU) on the same weights."""
    jcfg = JaxModelConfig(**SMALL, attn_impl="xla", decoder_impl="xla",
                          proj_impl="xla", stem_impl="xla")
    variables = JaxModel(jcfg).init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 65, T)),
                                    jnp.zeros((1, 10, 16, 16)))
    variables = jtu.tree_map(np.asarray, variables)
    ours = Separator(ModelConfig(**SMALL), from_jax_variables(variables),
                     DataConfig(**DATA), device="cpu")
    return JaxSeparator(jcfg, variables, JaxDataConfig(**DATA)), ours


def requests(b, seed=0):
    rng = np.random.default_rng(seed)
    audio = rng.normal(size=(b, N_AUDIO)).astype(np.float32)
    lips = rng.uniform(size=(b, 10, 16, 16)).astype(np.float32)
    return audio, lips


def assert_waves_close(got, ref):
    np.testing.assert_allclose(got[..., EDGE:-EDGE], ref[..., EDGE:-EDGE],
                               atol=1e-4, rtol=1e-4)
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


class TestOps:
    def test_stft_magnitude(self):
        from av_separation_tpu.data.synthetic import stft_magnitude_np
        from av_separation_tpu.ops.stft import stft_magnitude as jax_stft
        audio = rand((3, N_AUDIO), 0)
        ours = stft_magnitude(torch.from_numpy(audio), 128, 64).numpy()
        assert ours.shape == (3, 65, T)
        np.testing.assert_allclose(
            ours, np.asarray(jax_stft(jnp.asarray(audio), 128, 64)),
            atol=1e-4, rtol=1e-5)
        host = np.stack([stft_magnitude_np(a, 128, 64, T) for a in audio])
        np.testing.assert_allclose(ours, host, atol=5e-4, rtol=1e-4)

    @pytest.mark.parametrize("n_in,n_out", [(10, 32), (50, 63), (63, 25)])
    def test_interpolate(self, n_in, n_out):
        from av_separation_tpu.ops.interpolate import (
            interpolate_time_linear as jax_interp)
        x = rand((2, n_in, 8), 1)
        ours = interpolate_time_linear(torch.from_numpy(x), n_out)
        np.testing.assert_allclose(
            ours.numpy(), np.asarray(jax_interp(jnp.asarray(x), n_out)),
            atol=1e-6)
        torch_ref = F.interpolate(torch.from_numpy(x).transpose(1, 2),
                                  size=n_out, mode="linear",
                                  align_corners=False).transpose(1, 2)
        # F.interpolate computes source coordinates in float32, the JAX
        # package and the port in float64: blend weights differ by ~1e-6.
        np.testing.assert_allclose(ours.numpy(), torch_ref.numpy(),
                                   atol=2e-5)

    def test_masked_istft(self):
        from av_separation_tpu.ops.istft import masked_istft as jax_istft
        audio = rand((2, N_AUDIO), 2)
        masks = np.random.default_rng(3).uniform(
            size=(2, 2, 65, T)).astype(np.float32)
        ours = masked_istft(torch.from_numpy(masks), torch.from_numpy(audio),
                            128, 64).numpy()
        ref = np.asarray(jax_istft(jnp.asarray(masks), jnp.asarray(audio),
                                   128, 64))
        assert ours.shape == (2, 2, N_AUDIO)
        assert_waves_close(ours, ref)

    def test_unit_masks_reconstruct_the_mixture(self):
        audio = rand((1, N_AUDIO), 4)
        waves = masked_istft(torch.ones(1, 1, 65, T),
                             torch.from_numpy(audio), 128, 64).numpy()
        np.testing.assert_allclose(waves[0, 0, EDGE:-EDGE],
                                   audio[0, EDGE:-EDGE], atol=1e-4)

    def test_si_snr(self):
        from av_separation_tpu.ops.istft import si_snr_waveform as jax_snr
        est, tgt = rand((3, 2, 500), 5), rand((3, 2, 500), 6)
        np.testing.assert_allclose(
            si_snr_waveform(torch.from_numpy(est), torch.from_numpy(tgt)),
            np.asarray(jax_snr(jnp.asarray(est), jnp.asarray(tgt))),
            atol=1e-4)


class TestSeparator:
    def test_buckets(self):
        assert [bucket_batch(b) for b in (1, 2, 3, 5, 8, 300)] == \
            [1, 2, 4, 8, 8, 300]

    def test_separate_batch_of_3(self, separators):
        jsep, sep = separators
        rng = np.random.default_rng(7)
        mixed = np.abs(rng.normal(size=(3, 65, T))).astype(np.float32)
        lips = rng.uniform(size=(3, 10, 16, 16)).astype(np.float32)
        sep_ref, masks_ref = jsep.separate(mixed, lips)
        separated, masks = sep.separate(mixed, lips)
        assert masks.shape == (3, 2, 65, T)
        np.testing.assert_allclose(masks, masks_ref, atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(separated, sep_ref, atol=1e-4, rtol=1e-4)

    def test_separate_waveform_batch_of_3(self, separators):
        jsep, sep = separators
        audio, lips = requests(3)
        ref = jsep.separate_waveform(audio, lips)
        out = sep.separate_waveform(audio, lips)
        assert out["waveforms"].shape == (3, 2, N_AUDIO)
        np.testing.assert_allclose(out["mixed_spec"], ref["mixed_spec"],
                                   atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(out["masks"], ref["masks"], atol=2e-5,
                                   rtol=1e-4)
        assert_waves_close(out["waveforms"], ref["waveforms"])

    def test_padding_rows_do_not_leak(self, separators):
        _, sep = separators
        audio, lips = requests(4, seed=8)
        alone = sep.separate_waveform(audio[:3], lips[:3])  # bucket 4, pad 1
        full = sep.separate_waveform(audio, lips)
        np.testing.assert_allclose(alone["masks"], full["masks"][:3],
                                   atol=1e-6)


class TestBatchingServer:
    def test_concurrent_requests_coalesce(self, separators):
        _, sep = separators
        audio, lips = requests(8, seed=9)
        server = BatchingSeparatorServer(sep, max_batch=16,
                                         max_delay_ms=200.0)
        results = [None] * 8
        try:
            def client(i):
                results[i] = server.separate_waveform(audio[i], lips[i])

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
        finally:
            server.close()
        assert server.stats.max_batch_seen > 1
        assert server.stats.requests == 8
        direct = sep.separate_waveform(audio, lips)
        for i, (waves, masks) in enumerate(results):
            np.testing.assert_allclose(masks, direct["masks"][i], atol=1e-6)
            assert_waves_close(waves, direct["waveforms"][i])

    def test_warmup_runs_buckets_and_clears_stats(self, separators):
        _, sep = separators
        server = BatchingSeparatorServer(sep, max_batch=4,
                                         max_delay_ms=50.0)
        try:
            assert server.warmup((1, 3), wave=True) == 4
            assert server.stats.requests == server.stats.batches == 0
        finally:
            server.close()

    def test_rejects_wrong_rank(self, separators):
        _, sep = separators
        server = BatchingSeparatorServer(sep)
        try:
            with pytest.raises(ValueError, match="mixed_audio"):
                server.submit_waveform(np.zeros((2, N_AUDIO)),
                                       np.zeros((10, 16, 16)))
        finally:
            server.close()


class TestSyntheticData:
    def test_samples_bitmatch_golden(self, golden_dataset):
        ds = SyntheticAVDataset(DataConfig(num_samples=500))
        for i in (0, 1, 7, 123):
            s = ds[i]
            for key in ("mixed_spec", "lip_frames", "clean_specs"):
                assert np.array_equal(s[key], golden_dataset[f"{key}_{i}"]), \
                    f"sample {i} field {key} not bit-identical"

    def test_clean_audios_sum_to_the_mixture(self):
        from av_separation_torch.data.synthetic import stft_magnitude_np
        ds = SyntheticAVDataset(DataConfig(num_samples=4))
        audios, _ = ds.clean_audios(2)
        mixed = stft_magnitude_np(audios.sum(0).astype(np.float32), 512, 128,
                                  ds.cfg.num_stft_frames)
        assert np.array_equal(mixed, ds[2]["mixed_spec"])
