"""The three utilities the port took over last from the JAX package, on
the CPU and against their JAX counterparts: `metrics.evaluate_separation`,
`profiling.live_memory_bytes` and `roofline.pct_of_peak`."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av_separation_tpu import config as jc
from av_separation_tpu.models.model import AVSeparationTransformer as JaxModel
from av_separation_tpu.utils import metrics as jm
from av_separation_tpu.utils import profiling as jp
from av_separation_tpu.utils import roofline as jr
from av_separation_torch import config as tc
from av_separation_torch.models.model import AVSeparationTransformer
from av_separation_torch.utils import metrics, profiling, roofline
from av_separation_torch.utils.transplant import from_jax_variables

MODEL = dict(freq_bins=65, d_model=64, nhead=2, num_encoder_layers=1,
             num_fusion_layers=1, num_speakers=2, dropout=0.1)


@pytest.mark.parametrize("training", [False, True])
def test_evaluate_separation_matches_jax(training):
    """The same weights and batch: (input SNR, best-permutation output
    SNR) in dB, the model in eval mode whatever its mode, which is kept."""
    jmodel = JaxModel(jc.ModelConfig(**MODEL, attn_impl="xla",
                                     decoder_impl="xla", proj_impl="xla",
                                     stem_impl="xla"))
    rng = np.random.default_rng(5)
    mixed = np.abs(rng.normal(size=(3, 65, 33))).astype(np.float32)
    frames = rng.uniform(size=(3, 10, 16, 16)).astype(np.float32)
    targets = np.abs(rng.normal(size=(3, 2, 65, 33))).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(mixed),
                            jnp.asarray(frames))
    want = jm.evaluate_separation(jmodel.apply, variables,
                                  jnp.asarray(mixed), jnp.asarray(frames),
                                  jnp.asarray(targets))
    model = AVSeparationTransformer(tc.ModelConfig(**MODEL))
    model.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, dict(variables))))
    model.train(training)
    got = metrics.evaluate_separation(model, mixed, frames,
                                      torch.from_numpy(targets))
    assert model.training is training
    assert all(isinstance(x, float) for x in got)
    # SNRs in dB of float32 sums in another order.
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert metrics.evaluate_separation(model, mixed, frames, targets) == got


def test_live_memory_bytes():
    """None on the CPU, as the JAX helper gives on a backend without
    statistics; the card's allocated bytes on a CUDA device."""
    assert jp.live_memory_bytes() is None
    assert profiling.live_memory_bytes("cpu") is None
    if not torch.cuda.is_available():
        assert profiling.live_memory_bytes() is None
        return
    x = torch.empty(1 << 20, device="cuda")
    assert profiling.live_memory_bytes(x.device) \
        == torch.cuda.memory_allocated(x.device) >= x.nbytes


@pytest.mark.parametrize("dtype,column", [("bfloat16", 1), ("float32", 2)])
def test_pct_of_peak_against_jax(dtype, column):
    """The JAX formula, 100 * rate / peak, against the port's own peaks
    (the H100 as the default chip in place of the TPU v5e); 0.0 for a
    chip or dtype the table does not have, as in JAX."""
    rate = 123.4e12
    h100 = next(e for e in roofline.DEVICE_PEAKS.values()
                if e[0] == "h100_sxm")
    assert roofline.pct_of_peak(rate, dtype) == pytest.approx(
        100.0 * rate / h100[column], rel=1e-12)
    v5e = jr.PEAK_FLOPS[f"tpu_v5e_{dtype}"]
    assert jr.pct_of_peak(rate, dtype) * v5e == pytest.approx(
        roofline.pct_of_peak(rate, dtype) * h100[column], rel=1e-12)
    assert roofline.pct_of_peak(rate, dtype, chip="tpu_v5e") == 0.0
    assert jr.pct_of_peak(rate, dtype, chip="h100_sxm") == 0.0
    assert roofline.pct_of_peak(rate, "float16") == 0.0
    assert jr.pct_of_peak(rate, "float16") == 0.0
