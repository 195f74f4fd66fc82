"""The port's streaming separation against the JAX package's
`Separator.separate_waveform_streaming`, on the same weights.

The small model and data geometry of tests/test_torch_inference.py: 2 kHz
audio, 1 s chunks (5 video frames of 400 samples), n_fft 128, hop 64.
Waveforms are held as there: tightly on the interior (the least-squares
iSTFT amplifies rounding next to the first and last sample) and relative to
their peak over the whole.
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

from av_separation_tpu.config import DataConfig as JaxDataConfig
from av_separation_tpu.config import ModelConfig as JaxModelConfig
from av_separation_tpu.inference import Separator as JaxSeparator
from av_separation_tpu.models.model import AVSeparationTransformer as JaxModel
from av_separation_torch.config import DataConfig, ModelConfig
from av_separation_torch.inference import Separator
from av_separation_torch.utils.transplant import from_jax_variables

SMALL = dict(freq_bins=65, d_model=64, nhead=2, num_encoder_layers=1,
             num_fusion_layers=1, num_speakers=2, dropout=0.1)
DATA = dict(sample_rate=2000, duration=1.0, n_fft=128, hop_length=64,
            num_frames=5, frame_h=16, frame_w=16)
SPF = 400          # audio samples per video frame
CHUNK = 2000       # the default chunk: the training utterance
OVERLAP = 400      # the default overlap: CHUNK / 4 rounded down to frames
EDGE = 128 - 64    # least-squares edge samples at each end


@pytest.fixture(scope="module")
def separators():
    """(JAX Separator, port Separator on the CPU) on the same weights."""
    jcfg = JaxModelConfig(**SMALL, attn_impl="xla", decoder_impl="xla",
                          proj_impl="xla", stem_impl="xla")
    variables = JaxModel(jcfg).init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 65, 32)),
                                    jnp.zeros((1, 10, 16, 16)))
    variables = jtu.tree_map(np.asarray, variables)
    ours = Separator(ModelConfig(**SMALL), from_jax_variables(variables),
                     DataConfig(**DATA), device="cpu")
    return JaxSeparator(jcfg, variables, JaxDataConfig(**DATA)), ours


def long_request(b, n, seed=0):
    """(B, N) mixture and its (B, 2 * N / 400, 16, 16) lip streams."""
    rng = np.random.default_rng(seed)
    audio = rng.normal(size=(b, n)).astype(np.float32)
    lips = rng.uniform(size=(b, 2 * (n // SPF), 16, 16)).astype(np.float32)
    return audio, lips


def assert_waves_close(got, ref):
    np.testing.assert_allclose(got[..., EDGE:-EDGE], ref[..., EDGE:-EDGE],
                               atol=1e-4, rtol=1e-4)
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def chunk_request(audio, lips, a0):
    """The chunk starting at sample a0, as the streaming loop cuts it: the
    audio zero-padded past its end, each speaker's lip slice."""
    b, n = audio.shape
    audio = np.pad(audio, ((0, 0), (0, max(0, a0 + CHUNK - n))))
    per = lips.reshape(b, 2, -1, 16, 16)
    f0, fpc = a0 // SPF, CHUNK // SPF
    per = np.pad(per, ((0, 0), (0, 0),
                       (0, max(0, f0 + fpc - per.shape[2])), (0, 0), (0, 0)))
    return (audio[:, a0:a0 + CHUNK],
            per[:, :, f0:f0 + fpc].reshape(b, 2 * fpc, 16, 16))


class TestStreaming:
    def test_matches_jax_on_a_3_2x_mixture(self, separators):
        jsep, sep = separators
        audio, lips = long_request(2, 6400)
        ref = jsep.separate_waveform_streaming(audio, lips)
        out = sep.separate_waveform_streaming(audio, lips)
        assert out["num_chunks"] == ref["num_chunks"] == 4
        assert isinstance(out["num_chunks"], np.int32)
        assert out["waveforms"].shape == (2, 2, 6400)
        assert out["waveforms"].dtype == np.float32
        assert_waves_close(out["waveforms"], ref["waveforms"])

    def test_single_chunk_regions_equal_the_isolated_chunk(self, separators):
        # The JAX docstring's claim (tests/test_audio.py checks it there):
        # where one chunk has weight 1, the stitched output is that chunk
        # through separate_waveform.  Each chunk's window ramps over the
        # overlap at both ends (the outer ends renormalized), so weight 1
        # is [overlap, chunk - overlap) of every chunk.
        _, sep = separators
        audio, lips = long_request(2, 6400, seed=1)
        out = sep.separate_waveform_streaming(audio, lips)["waveforms"]
        stride = CHUNK - OVERLAP
        for k in range(4):
            a0 = k * stride
            alone = sep.separate_waveform(
                *chunk_request(audio, lips, a0))["waveforms"]
            hi = min(CHUNK - OVERLAP, 6400 - a0)
            np.testing.assert_allclose(out[..., a0 + OVERLAP:a0 + hi],
                                       alone[..., OVERLAP:hi], atol=1e-6,
                                       rtol=0)

    def test_shorter_than_one_chunk(self, separators):
        jsep, sep = separators
        audio, lips = long_request(1, 1200, seed=2)
        ref = jsep.separate_waveform_streaming(audio, lips)
        out = sep.separate_waveform_streaming(audio, lips)
        assert out["num_chunks"] == ref["num_chunks"] == 1
        assert out["waveforms"].shape == (1, 2, 1200)
        assert_waves_close(out["waveforms"], ref["waveforms"])

    def test_no_overlap_concatenates_the_chunks(self, separators):
        jsep, sep = separators
        audio, lips = long_request(2, 6400, seed=3)
        ref = jsep.separate_waveform_streaming(audio, lips, overlap_s=0)
        out = sep.separate_waveform_streaming(audio, lips, overlap_s=0)
        assert out["num_chunks"] == ref["num_chunks"] == 4
        assert_waves_close(out["waveforms"], ref["waveforms"])
        parts = [sep.separate_waveform(*chunk_request(audio, lips, a0))
                 ["waveforms"] for a0 in range(0, 6400, CHUNK)]
        np.testing.assert_allclose(
            out["waveforms"], np.concatenate(parts, -1)[..., :6400],
            atol=1e-6, rtol=0)

    def test_chunk_and_overlap_round_to_video_frames(self, separators):
        # chunk 1.3 s -> 2,600 samples -> 2,400 (6 frames); overlap 0.5 s
        # -> 1,000 -> 800; over 6,400 samples: 4 chunks.  An overlap of a
        # whole chunk is cut to the chunk less one frame.
        jsep, sep = separators
        audio, lips = long_request(1, 6400, seed=4)
        for chunk_s, overlap_s in ((1.3, 0.5), (1.0, 1.0)):
            ref = jsep.separate_waveform_streaming(audio, lips, chunk_s,
                                                   overlap_s)
            out = sep.separate_waveform_streaming(audio, lips, chunk_s,
                                                  overlap_s)
            assert out["num_chunks"] == ref["num_chunks"]
            assert_waves_close(out["waveforms"], ref["waveforms"])
        assert out["num_chunks"] == 12  # stride 400: (6400 - 1600) / 400

    def test_errors_are_the_jax_errors(self, separators):
        jsep, sep = separators
        audio, lips = long_request(1, 6400, seed=5)
        for s in (jsep, sep):
            with pytest.raises(ValueError, match="chunk_s too small"):
                s.separate_waveform_streaming(audio, lips, chunk_s=0.1)
        bare = Separator(ModelConfig(**SMALL), sep.model.state_dict(),
                         device="cpu")
        jbare = JaxSeparator(jsep.cfg, jsep.variables)
        for s in (jbare, bare):
            with pytest.raises(ValueError, match="streaming requires "
                                                 "data_cfg"):
                s.separate_waveform_streaming(audio, lips)
