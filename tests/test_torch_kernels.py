"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version (the CUDA
kernels are held against those on the card by chip_smoke.py); the Pallas
kernels run in interpret mode, as tests/test_kernels.py runs them.  Inputs
are made with numpy from a seed and handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from av_separation_torch.ops import kernels
from av_separation_torch.ops.attention import (multi_head_attention,
                                               split_heads)
from av_separation_torch.ops.kernels.attention import flash_attn_fwd
from av_separation_torch.ops.kernels.audio_proj import audio_proj_fwd
from av_separation_torch.ops.kernels.decoder import mask_decoder_fwd


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


@pytest.fixture(autouse=True)
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


class TestFlashAttention:
    # Float32 on both sides; sums over <= 128 head dims and <= 50 keys in
    # another order: 2e-5 is the tolerance tests/test_kernels.py gives the
    # Pallas kernel against dense XLA attention.
    @pytest.mark.parametrize("b,tq,tk,nh", [(2, 37, 50, 2), (1, 20, 9, 1)])
    def test_packed_dh128_matches_pallas(self, b, tq, tk, nh):
        from av_separation_tpu.ops.pallas.attention import (
            flash_attention_packed_qkv)
        d = nh * 128
        q, k, v = rand((b, tq, d), 0), rand((b, tk, d), 1), rand((b, tk, d), 2)
        ref = flash_attention_packed_qkv(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), nh)
        ours = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), nh)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   atol=2e-5, rtol=1e-4)

    @pytest.mark.parametrize("b,h,tq,tk", [(2, 4, 63, 50), (1, 2, 17, 33)])
    def test_split_dh32_matches_pallas(self, b, h, tq, tk):
        from av_separation_tpu.ops.pallas.attention import flash_attention
        q = rand((b, h, tq, 32), 3)
        k, v = rand((b, h, tk, 32), 4), rand((b, h, tk, 32), 5)
        ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ours, lse = flash_attn_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   atol=2e-5, rtol=1e-4)
        # lse in float64 numpy: float32 rounding of a ~log(Tk) value.
        s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / np.sqrt(32)
        m = s.max(-1)
        want = m + np.log(np.exp(s - m[..., None]).sum(-1))
        np.testing.assert_allclose(lse.numpy(), want, atol=1e-5)

    def test_output_is_packed_memory(self):
        q = torch.from_numpy(rand((2, 9, 64), 6))
        out, _ = flash_attn_fwd(*(split_heads(q, 2),) * 3)
        assert out.transpose(1, 2).is_contiguous()


class TestAudioProjection:
    # Float32 sums over 3 * 65 and 3 * 64 products in another order.
    def test_unaligned_t_matches_pallas(self):
        from av_separation_tpu.ops.pallas.audio_proj import _fwd_impl
        b, t, f, d = 2, 37, 65, 64
        x = rand((b, t, f), 7)
        w1, b1 = rand((3, f, d), 8, 0.1), rand((d,), 9, 0.1)
        w2, b2 = rand((3, d, d), 10, 0.1), rand((d,), 11, 0.1)
        y_ref, h_ref = _fwd_impl(*(jnp.asarray(a) for a in (x, w1, b1, w2,
                                                             b2)))
        y, h = audio_proj_fwd(*(torch.from_numpy(a) for a in (x, w1, b1, w2,
                                                              b2)))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=2e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=2e-5,
                                   rtol=1e-4)

    def test_hidden_halo_is_zero_not_relu_bias(self):
        # With x = 0 and b1 > 0, h = relu(b1) inside [0, T); conv2's zero
        # padding must see 0 beyond the edges, so y at t=0 lacks tap 0.
        t, d = 5, 64
        x = torch.zeros(1, t, 8)
        w1 = torch.zeros(3, 8, d)
        b1 = torch.ones(d)
        w2 = torch.ones(3, d, d)
        y, h = audio_proj_fwd(x, w1, b1, w2, torch.zeros(d))
        assert torch.equal(h, torch.ones(1, t, d))
        assert float(y[0, 0, 0]) == 2 * d and float(y[0, 2, 0]) == 3 * d


class TestMaskDecoder:
    # The Pallas kernel's Abramowitz-Stegun erf is within 1.5e-7 of erf
    # (decoder.py:35-48); through GELU and the sigmoid that stays < 2e-6 on
    # the masks, and < 2e-5 on masks times |mixed| ~ 4.
    def test_f65_matches_pallas(self):
        from av_separation_tpu.ops.pallas.decoder import fused_mask_decoder
        b, t, d, s, f = 2, 37, 64, 2, 65
        x = rand((b, t, d), 12)
        w1, b1 = rand((d, 2 * d), 13, 0.05), rand((2 * d,), 14, 0.05)
        w2, b2 = rand((2 * d, s * f), 15, 0.05), rand((s * f,), 16, 0.05)
        mixed = rand((b, f, t), 17)
        sep_ref, masks_ref = fused_mask_decoder(
            *(jnp.asarray(a) for a in (x, w1, b1, w2, b2, mixed)), s, f)
        sep, masks = mask_decoder_fwd(
            *(torch.from_numpy(a) for a in (x, w1, b1, w2, b2, mixed)), s)
        assert masks.shape == (b, s, f, t)
        np.testing.assert_allclose(masks.numpy(), np.asarray(masks_ref),
                                   atol=2e-6, rtol=1e-5)
        np.testing.assert_allclose(sep.numpy(), np.asarray(sep_ref),
                                   atol=2e-5, rtol=1e-5)


class TestDispatch:
    def test_cpu_tensors_launch_no_kernel(self):
        kernels.reset_launch_counts()
        q = torch.from_numpy(rand((1, 2, 5, 32), 18))
        flash_attn_fwd(q, q, q)
        d = 64
        audio_proj_fwd(torch.zeros(1, 4, 8), torch.zeros(3, 8, d),
                       torch.zeros(d), torch.zeros(3, d, d), torch.zeros(d))
        mask_decoder_fwd(torch.zeros(1, 4, d), torch.zeros(d, 2 * d),
                         torch.zeros(2 * d), torch.zeros(2 * d, 2 * 3),
                         torch.zeros(2 * 3), torch.zeros(1, 3, 4), 2)
        assert kernels.LAUNCHES == {"flash_attn_fwd": 0,
                                    "audio_proj_fwd": 0,
                                    "mask_decoder_fwd": 0}

    def test_other_devices_raise(self):
        q = torch.empty(1, 2, 5, 32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            flash_attn_fwd(q, q, q)
        x = torch.empty(1, 4, 8, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            audio_proj_fwd(x, x, x, x, x)
        with pytest.raises(ValueError, match="unsupported device"):
            mask_decoder_fwd(x, x, x, x, x, x, 2)
