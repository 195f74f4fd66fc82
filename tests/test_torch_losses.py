"""The port's losses and metrics against the JAX package and the reference
goldens.  Inputs are made with numpy from a seed and handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av_separation_tpu import losses as jl
from av_separation_tpu.utils import metrics as jm
from av_separation_torch import losses as tl
from av_separation_torch.utils import metrics as tm


def rand(shape, seed, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            + offset).astype(np.float32)


def pair(s, seed=0):
    """(separated, targets) (B, S, F, T): targets plus noise, so one
    permutation is clearly best and the losses are well conditioned."""
    tgt = np.abs(rand((3, s, 17, 12), seed))
    sep = tgt[:, ::-1] + rand((3, s, 17, 12), seed + 1, 0.3)
    return np.ascontiguousarray(sep), tgt


class TestGolden:
    """Tolerances of tests/test_parity.py: SI-SNR sums over ~32k
    near-orthogonal elements differ by O(1e-3) dB between valid float32
    summation orders."""

    def test_loss(self, golden_loss, golden_model):
        sep = torch.from_numpy(golden_model["separated"])
        tgt = torch.from_numpy(golden_model["targets"])
        np.testing.assert_allclose(float(tl.separation_loss(sep, tgt)),
                                   float(golden_loss["loss"]), atol=5e-3)
        np.testing.assert_allclose(
            float(tl.separation_loss(sep.flip(1), tgt)),
            float(golden_loss["loss_swapped"]), atol=5e-3)
        np.testing.assert_allclose(
            float(tl.separation_loss_direct(sep, tgt)),
            float(golden_loss["loss"]), atol=1e-3)

    def test_si_snr(self, golden_loss, golden_model):
        tgt = torch.from_numpy(golden_model["targets"])
        sep = torch.from_numpy(golden_model["separated"])
        np.testing.assert_allclose(float(tl.si_snr(sep, tgt)),
                                   float(golden_loss["snr_est"]), atol=1e-3)
        np.testing.assert_allclose(float(tl.si_snr(tgt, tgt)),
                                   float(golden_loss["snr_self"]), atol=1e-2)

    def test_random_pair(self, golden_loss):
        a = torch.from_numpy(golden_loss["rand_a"])
        b = torch.from_numpy(golden_loss["rand_b"])
        np.testing.assert_allclose(float(tl.si_snr(a, b)),
                                   float(golden_loss["rand_si_snr"]),
                                   atol=1e-4)
        np.testing.assert_allclose(float(tl.separation_loss(a, b)),
                                   float(golden_loss["rand_loss"]), atol=5e-3)


class TestAgainstJax:
    # Float32 on both sides, the same formulas, sums in another order.
    @pytest.mark.parametrize("mode", ["global", "per_sample"])
    @pytest.mark.parametrize("s", [2, 3])
    @pytest.mark.parametrize("fn", ["separation_loss",
                                    "separation_loss_direct"])
    def test_loss_value_and_gradient(self, fn, s, mode):
        sep, tgt = pair(s, seed=s)
        ref_fn = lambda x: getattr(jl, fn)(x, jnp.asarray(tgt), 0.5, mode)
        ref, ref_grad = jax.value_and_grad(ref_fn)(jnp.asarray(sep))
        x = torch.from_numpy(sep).requires_grad_()
        ours = getattr(tl, fn)(x, torch.from_numpy(tgt), 0.5, mode)
        ours.backward()
        np.testing.assert_allclose(float(ours.detach()), float(ref),
                                   atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad),
                                   atol=1e-5, rtol=1e-4)

    @pytest.mark.parametrize("s", [2, 3])
    def test_pairwise_equals_direct(self, s):
        sep, tgt = pair(s, seed=10 + s)
        sep, tgt = torch.from_numpy(sep), torch.from_numpy(tgt)
        for mode in ("global", "per_sample"):
            np.testing.assert_allclose(
                float(tl.separation_loss(sep, tgt, pit_mode=mode)),
                float(tl.separation_loss_direct(sep, tgt, pit_mode=mode)),
                atol=1e-4)

    def test_si_snr_per_item(self):
        a, b = rand((4, 2, 9, 7), 20), rand((4, 2, 9, 7), 21)
        np.testing.assert_allclose(
            tl.si_snr(torch.from_numpy(a), torch.from_numpy(b),
                      reduce_mean=False).numpy(),
            np.asarray(jl.si_snr(jnp.asarray(a), jnp.asarray(b),
                                 reduce_mean=False)), atol=1e-4)

    @pytest.mark.parametrize("s", [2, 3])
    def test_best_permutation(self, s):
        sep, tgt = pair(s, seed=30 + s)
        perm, snr = tl.best_permutation(torch.from_numpy(sep),
                                        torch.from_numpy(tgt))
        jperm, jsnr = jl.best_permutation(jnp.asarray(sep), jnp.asarray(tgt))
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
        np.testing.assert_allclose(snr.numpy(), np.asarray(jsnr), atol=1e-4)
        np.testing.assert_array_equal(tl.permutation_table(s),
                                      jl.permutation_table(s))

    def test_unknown_pit_mode_raises(self):
        sep, tgt = pair(2)
        with pytest.raises(ValueError, match="pit_mode"):
            tl.separation_loss(torch.from_numpy(sep), torch.from_numpy(tgt),
                               pit_mode="nope")


class TestMetrics:
    @pytest.mark.parametrize("s", [2, 3])
    def test_snr_metrics(self, s):
        sep, tgt = pair(s, seed=40 + s)
        mixed = tgt.sum(axis=1)
        np.testing.assert_allclose(
            tm.input_snr(torch.from_numpy(mixed), torch.from_numpy(tgt))
            .numpy(),
            np.asarray(jm.input_snr(jnp.asarray(mixed), jnp.asarray(tgt))),
            atol=1e-4)
        np.testing.assert_allclose(
            tm.permutation_snr(torch.from_numpy(sep), torch.from_numpy(tgt))
            .numpy(),
            np.asarray(jm.permutation_snr(jnp.asarray(sep),
                                          jnp.asarray(tgt))), atol=1e-4)
        np.testing.assert_allclose(
            tm.snr_db(torch.from_numpy(tgt), torch.from_numpy(sep)).numpy(),
            np.asarray(jm.snr_db(jnp.asarray(tgt), jnp.asarray(sep))),
            atol=1e-4)
