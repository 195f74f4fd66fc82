"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version (the CUDA
kernels are held against those on the card by chip_smoke.py); the Pallas
kernels run in interpret mode, as tests/test_kernels.py runs them.  Inputs
are made with numpy from a seed and handed to both.  Attention dropout
masks agree bit for bit (the same hash), so the dropout cases are held at
the float32 tolerances of the dropout-free ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from av_separation_torch.ops import kernels
from av_separation_torch.ops.attention import (draw_seed, merge_heads,
                                               multi_head_attention,
                                               split_heads)
from av_separation_torch.ops.kernels.attention import (flash_attention,
                                                       flash_attn_bwd,
                                                       flash_attn_bwd_torch,
                                                       flash_attn_fwd,
                                                       flash_attn_fwd_torch,
                                                       keep_mask, padded_bwd,
                                                       padded_fwd,
                                                       padded_head_dim)
from av_separation_torch.ops.kernels.audio_proj import (audio_proj_fwd,
                                                        audio_projection)
from av_separation_torch.ops.kernels.decoder import (mask_decoder,
                                                     mask_decoder_fwd)
from av_separation_torch.ops.kernels.dropout_fused import (EPILOGUES,
                                                           dropout_bwd,
                                                           dropout_fwd)
from av_separation_torch.ops.kernels.stft import stft_magnitude_fwd

SEED = -1234567  # an int32 dropout seed with the sign bit set


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
        # The port takes the torch Linear layout (out, in).
        sep, masks = mask_decoder_fwd(
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (x, w1.T, b1, w2.T, b2, mixed)), s)
        assert masks.shape == (b, s, f, t)
        np.testing.assert_allclose(masks.numpy(), np.asarray(masks_ref),
                                   atol=2e-6, rtol=1e-5)
        np.testing.assert_allclose(sep.numpy(), np.asarray(sep_ref),
                                   atol=2e-5, rtol=1e-5)


class TestStft:
    # Float32 DFT sums over 512 windowed samples in another order against
    # the Pallas kernel's (peaks ~50 on unit-normal audio).
    @pytest.mark.parametrize("shape,n_fft,hop,frames", [
        ((3, 8000), 512, 128, 63),
        ((2000,), 128, 64, 32),
        ((2, 3, 1500), 128, 64, 24),
    ])
    def test_matches_pallas(self, shape, n_fft, hop, frames):
        from av_separation_tpu.ops.pallas.stft import stft_magnitude_pallas
        audio = rand(shape, 20)
        ref = stft_magnitude_pallas(jnp.asarray(audio), n_fft, hop, frames)
        ours = stft_magnitude_fwd(torch.from_numpy(audio), n_fft, hop)
        assert ours.shape == shape[:-1] + (n_fft // 2 + 1, frames)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-5)

    @pytest.mark.parametrize("shape,n_fft,hop,frames", [
        ((3, 8000), 512, 128, 63), ((1, 2000), 128, 64, 32)])
    def test_matches_float64_numpy(self, shape, n_fft, hop, frames):
        # The tolerance tests/test_kernels.py gives the Pallas kernel.
        from av_separation_torch.data.synthetic import stft_magnitude_np
        audio = rand(shape, 21)
        want = np.stack([stft_magnitude_np(a, n_fft, hop, frames)
                         for a in audio])
        ours = stft_magnitude_fwd(torch.from_numpy(audio), n_fft, hop, frames)
        np.testing.assert_allclose(ours.numpy(), want, atol=5e-4, rtol=1e-4)

    def test_tail_frames_read_zeros(self):
        # The frame starting at N reads only zeros; one starting at N - 1
        # sees one windowed sample, and the Hann window is 0 there.
        audio = torch.ones(1, 256)
        mag = stft_magnitude_fwd(audio, 64, 32, 12)
        assert torch.equal(mag[..., 8:], torch.zeros(1, 33, 4))
        assert float(mag[0, 0, 0]) == pytest.approx(31.5, rel=1e-6)

    @pytest.mark.parametrize("audio,n_fft,hop,match", [
        (torch.zeros(2, 300, dtype=torch.float64), 64, 32, "float32"),
        (torch.zeros(300, 2).t(), 64, 32, "contiguous"),
        (torch.zeros(2, 300), 1, 32, "n_fft 1"),
        (torch.zeros(2, 0), 8192, 32, "audio must be"),
        # 2^31 signals of 41 frames at one frame a block: more blocks than
        # grid x holds (a meta tensor: no memory).
        (torch.empty(2 ** 31, 40, device="meta"), 8192, 1, "grid")])
    def test_kernel_inputs_are_checked(self, audio, n_fft, hop, match):
        from av_separation_torch.ops.kernels.stft import _check
        with pytest.raises(ValueError, match=match):
            _check(audio, n_fft, hop, 1 + audio.shape[-1] // hop)


class TestDispatch:
    def test_launches_are_counted_per_instance(self):
        kernels.reset_launch_counts()
        kernels.count_launch("flash_attn_fwd", torch.float32)
        kernels.count_launch("flash_attn_fwd", torch.bfloat16)
        kernels.count_launch("flash_attn_fwd", torch.bfloat16)
        kernels.count_launch("audio_proj_fwd", torch.bfloat16)
        assert {k: n for k, n in kernels.LAUNCHES.items() if n} == {
            "flash_attn_fwd": 1, "flash_attn_fwd[bf16]": 2,
            "audio_proj_fwd[bf16]": 1}
        kernels.reset_launch_counts()
        assert not any(kernels.LAUNCHES.values())

    def test_cpu_tensors_launch_no_kernel(self):
        kernels.reset_launch_counts()
        q = torch.from_numpy(rand((1, 2, 5, 32), 18))
        for q in (q, q.to(torch.bfloat16)):
            o, lse = flash_attn_fwd(q, q, q, 0.1, SEED)
            flash_attn_bwd(q, q, q, o, o, lse, 0.1, SEED)
        d = 64
        for dtype in (torch.float32, torch.bfloat16):
            audio_proj_fwd(torch.zeros(1, 4, 8, dtype=dtype),
                           torch.zeros(3, 8, d), torch.zeros(d),
                           torch.zeros(3, d, d), torch.zeros(d))
        mask_decoder_fwd(torch.zeros(1, 4, d), torch.zeros(2 * d, d),
                         torch.zeros(2 * d), torch.zeros(2 * 3, 2 * d),
                         torch.zeros(2 * 3), torch.zeros(1, 3, 4), 2)
        stft_magnitude_fwd(torch.zeros(2, 300), 64, 32)   # the FFT route's
        stft_magnitude_fwd(torch.zeros(2, 300), 56, 32)   # the FFT route's
        stft_magnitude_fwd(torch.zeros(2, 300), 4100, 32)  # one a frame
        stft_magnitude_fwd(torch.zeros(2, 300), 8194, 32)  # the four-step
        bits = torch.zeros(4, 32, dtype=torch.uint8)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.ones(4, 32, dtype=dtype)
            for kind in EPILOGUES:
                dropout_fwd(kind, x, bits, 26, 1.25, x)
                dropout_bwd(kind, x, x, bits, 26, 1.25)
        assert kernels.LAUNCHES == {"flash_attn_fwd": 0,
                                    "flash_attn_bwd": 0,
                                    "audio_proj_fwd": 0,
                                    "mask_decoder_fwd": 0,
                                    "stft_mag_fwd": 0,
                                    "stft_mag_4step_fwd": 0,
                                    "flash_attn_fwd[bf16]": 0,
                                    "flash_attn_bwd[bf16]": 0,
                                    "audio_proj_fwd[bf16]": 0,
                                    "audio_proj_split": 0,
                                    "audio_proj_split[bf16]": 0,
                                    "dropout_fwd": 0, "dropout_bwd": 0,
                                    "dropout_fwd[bf16]": 0,
                                    "dropout_bwd[bf16]": 0}

    # The flash kernels' head dims: demo (32), the reference's default
    # model ModelConfig() (d 256 / 4 heads = 64), every wider config (128).
    @pytest.mark.parametrize("dh", [32, 64, 128])
    def test_flash_checks_accept_the_configs_head_dims(self, dh):
        from av_separation_torch.ops.kernels.attention import _check
        q = torch.zeros(2, 4, 9, dh)
        _check(q, q, q)

    def test_flash_checks_refuse_other_head_dims(self):
        from av_separation_torch.ops.kernels.attention import _check
        q = torch.zeros(2, 4, 9, 96)
        with pytest.raises(ValueError, match="head dim 96"):
            _check(q, q, q)

    @pytest.mark.parametrize("dh,width", [(1, 32), (17, 32), (32, 32),
                                          (49, 64), (100, 128), (128, 128)])
    def test_head_dims_pad_to_the_next_built_one(self, dh, width):
        assert padded_head_dim(dh) == width

    @pytest.mark.parametrize("dh", [129, 200, 256])
    def test_head_dims_above_128_pad_to_256_at_their_own_scale(self, dh):
        # Above 128 the kernels run at dh 256; the wrapper pads q, k, v
        # (and o, dO) with zero columns and passes the true dh's softmax
        # scale.
        from av_separation_torch.ops.kernels.attention import _check
        assert padded_head_dim(dh) == 256
        q = torch.zeros(2, 2, 9, dh)
        seen = []

        def fwd(q, k, v, rate, seed, scale=None):
            seen.append((tuple(q.shape), scale))
            _check(q, k, v)
            return q, q[..., 0]

        o, _ = padded_fwd(fwd, q, q, q)
        assert seen == [((2, 2, 9, 256), None if dh == 256
                         else 1.0 / np.sqrt(dh))]
        assert o.shape == q.shape

    def test_head_dims_above_256_are_refused(self):
        # Above 256 only multiples of 128 are built: the launcher refuses
        # any other, and the padding wrapper pads to the next one.
        from av_separation_torch.ops.kernels.attention import _check
        q = torch.zeros(1, 2, 9, 257)
        with pytest.raises(ValueError, match="head dim 257 not in"):
            _check(q, q, q)
        assert padded_head_dim(257) == 384
        _check(*(torch.zeros(1, 2, 9, 384),) * 3)

    def test_other_devices_raise(self):
        q = torch.empty(1, 2, 5, 32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            flash_attn_fwd(q, q, q)
        with pytest.raises(ValueError, match="unsupported device"):
            flash_attn_bwd(q, q, q, q, q, q[..., 0])
        x = torch.empty(1, 4, 8, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            audio_proj_fwd(x, x, x, x, x)
        with pytest.raises(ValueError, match="unsupported device"):
            mask_decoder_fwd(x, x, x, x, x, x, 2)
        with pytest.raises(ValueError, match="unsupported device"):
            stft_magnitude_fwd(torch.empty(2, 300, device="meta"), 64, 32)


class TestHeadDimPadding:
    # Head dims the kernels are not built for run zero-padded to the next
    # built one at the true dh's scale (`padded_fwd`, `padded_bwd`).  Here
    # the padding goes around the plain versions; the results are held
    # against the unpadded plain version and the JAX packed Pallas kernel
    # (`_flash_packed_call`, and its backward rule through jax.vjp) in
    # interpret mode, with the same dropout bits: float32 sums in another
    # order, 2e-5 on o and gradients (5e-5 on the gradients against JAX, as
    # test_backward_matches_jax_vjp), 1e-4 on lse.
    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("dh", [1, 17, 49, 100])
    def test_padded_route_matches_unpadded_and_pallas(self, dh, rate):
        from av_separation_tpu.ops.pallas import attention as pa
        b, h, tq, tk = 2, 2, 37, 50
        q, k, v = rand((b, h, tq, dh), 40), rand((b, h, tk, dh), 41), \
            rand((b, h, tk, dh), 42)
        do = rand((b, h, tq, dh), 43)
        tq_, tk_, tv_, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
        o, lse = padded_fwd(flash_attn_fwd_torch, tq_, tk_, tv_, rate, SEED)
        o_u, lse_u = flash_attn_fwd_torch(tq_, tk_, tv_, rate, SEED)
        assert o.shape == (b, h, tq, dh)
        np.testing.assert_allclose(o.numpy(), o_u.numpy(), atol=2e-5)
        np.testing.assert_allclose(lse.numpy(), lse_u.numpy(), atol=1e-4)

        bq, bk = -(-tq // 16) * 16, -(-tk // 128) * 128
        qf = pa._pad_to(jnp.asarray(q.reshape(b * h, tq, dh)), 1, bq)
        kf, vf = (pa._pad_to(jnp.asarray(x.reshape(b * h, tk, dh)), 1, bk)
                  for x in (k, v))
        seed = jnp.asarray([SEED], jnp.int32)
        o_j, lse_j = pa._flash_packed_call(
            qf, kf, vf, seed, 1.0 / np.sqrt(dh), tk, rate, False,
            pa._pick_heads_per_block(b * h, bq, bk, dh, 4))
        np.testing.assert_allclose(
            o.numpy(), np.asarray(o_j)[:, :tq].reshape(b, h, tq, dh),
            atol=2e-5)
        np.testing.assert_allclose(
            lse.numpy(), np.asarray(lse_j)[:, 0, :tq].reshape(b, h, tq),
            atol=1e-4)

        grads = padded_bwd(flash_attn_bwd_torch, tq_, tk_, tv_, o, tdo, lse,
                           rate, SEED)
        want_u = flash_attn_bwd_torch(tq_, tk_, tv_, o_u, tdo, lse_u, rate,
                                      SEED)
        _, vjp = jax.vjp(lambda *a: pa.flash_attention(
            *a, dropout_rate=rate, dropout_seed=seed),
            *(jnp.asarray(x) for x in (q, k, v)))
        want_j = vjp(jnp.asarray(do))
        for name, g, u, j in zip("qkv", grads, want_u, want_j):
            assert g.shape == u.shape
            np.testing.assert_allclose(g.numpy(), u.numpy(), atol=2e-5,
                                       err_msg=name)
            np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=5e-5,
                                       err_msg=name)

    def test_padding_reaches_a_kernel_of_a_built_head_dim(self):
        # What the CUDA wrappers hand their kernels: dh 64 tensors and the
        # softmax scale of dh 49.
        seen = []

        def fwd(q, k, v, rate, seed, scale=None):
            seen.append((q.shape[-1], k.shape[-1], v.shape[-1], scale))
            return flash_attn_fwd_torch(q, k, v, rate, seed, scale)

        q = torch.from_numpy(rand((1, 2, 5, 49), 44))
        padded_fwd(fwd, q, q, q)
        assert seen == [(64, 64, 64, 1.0 / np.sqrt(49))]


# ---------------------------------------------------------------------------
# Attention dropout and the flash backward.
# ---------------------------------------------------------------------------

def _jax_attention(layout, nh, rate):
    """The Pallas entry point of one layout, as a function of (q, k, v)."""
    from av_separation_tpu.ops.pallas.attention import (
        flash_attention as jax_flash, flash_attention_packed_qkv)
    seed = jnp.asarray([SEED], jnp.int32) if rate > 0 else None
    if layout == "packed":
        return lambda q, k, v: flash_attention_packed_qkv(
            q, k, v, nh, dropout_rate=rate, dropout_seed=seed)
    return lambda q, k, v: jax_flash(q, k, v, dropout_rate=rate,
                                     dropout_seed=seed)


def _port_attention(layout, nh, rate):
    if layout == "packed":
        return lambda q, k, v: merge_heads(flash_attention(
            *(split_heads(x, nh) for x in (q, k, v)), rate, SEED))
    return lambda q, k, v: flash_attention(q, k, v, rate, SEED)


# (layout, shape of q, shape of k/v, heads): packed (B, T, H*dh) at dh 128
# (`_fwd_hpacked_kernel`), split (B, H, T, dh) at dh 32
# (`_fwd_packed_kernel`) and the multi-block grid (Tq, Tk > 512,
# `_fwd_kernel` and the three-stage backward).
LAYOUTS = {
    "packed": ((2, 37, 256), (2, 45, 256), 2),
    "split": ((2, 2, 37, 32), (2, 2, 50, 32), 2),
    "multiblock": ((1, 1, 600, 32), (1, 1, 530, 32), 1),
}


class TestAttentionDropout:
    def test_keep_rate_and_seed(self):
        keep = keep_mask(SEED, 2, 2, 300, 300, 0.3)
        # 360k Bernoulli(0.7) draws: 5 sigma is 0.004.
        assert abs(float(keep.float().mean()) - 0.7) < 0.004
        assert not torch.equal(keep, keep_mask(SEED + 1, 2, 2, 300, 300, 0.3))
        assert bool(keep_mask(SEED, 1, 1, 9, 9, 0.0).all())

    def test_draw_seed_is_int32(self):
        gen = torch.Generator().manual_seed(0)
        seeds = [draw_seed(gen) for _ in range(64)]
        assert all(-2 ** 31 <= s < 2 ** 31 for s in seeds)
        assert any(s < 0 for s in seeds) and len(set(seeds)) == 64

    # The same bits on both sides: float32 tolerances, as without dropout.
    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_forward_matches_pallas(self, layout):
        qs, ks, nh = LAYOUTS[layout]
        q, k, v = rand(qs, 20), rand(ks, 21), rand(ks, 22)
        ref = _jax_attention(layout, nh, 0.3)(
            *(jnp.asarray(x) for x in (q, k, v)))
        ours = _port_attention(layout, nh, 0.3)(
            *(torch.from_numpy(x) for x in (q, k, v)))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   atol=2e-5, rtol=1e-4)

    # Gradients sum up to 600 products per element in another order than
    # the Pallas kernels: 5e-5 absolute on O(1) values.
    @pytest.mark.parametrize("rate", [0.0, 0.3])
    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_backward_matches_jax_vjp(self, layout, rate):
        qs, ks, nh = LAYOUTS[layout]
        q, k, v = rand(qs, 23), rand(ks, 24), rand(ks, 25)
        g = rand(qs, 26)
        _, vjp = jax.vjp(_jax_attention(layout, nh, rate),
                         *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp(jnp.asarray(g))
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        _port_attention(layout, nh, rate)(*ts).backward(torch.from_numpy(g))
        for name, t, w in zip("qkv", ts, want):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                       atol=5e-5, rtol=1e-4, err_msg=name)

    def test_backward_wrapper_matches_autograd_of_dense(self):
        """flash_attn_bwd against autograd through dense softmax attention
        with the same keep mask (float64)."""
        b, h, tq, tk, dh = 1, 2, 7, 9, 8
        gen = np.random.default_rng(27)
        q, k, v, do = (torch.from_numpy(gen.normal(size=s))
                       for s in ((b, h, tq, dh), (b, h, tk, dh),
                                 (b, h, tk, dh), (b, h, tq, dh)))
        rate = 0.25
        o, lse = flash_attn_fwd(q, k, v, rate, SEED)
        dq, dk, dv = flash_attn_bwd(q, k, v, o, do, lse, rate, SEED)
        keep = keep_mask(SEED, b, h, tq, tk, rate)
        ts = [x.clone().requires_grad_() for x in (q, k, v)]
        p = torch.softmax(ts[0] @ ts[1].transpose(-1, -2) / dh ** 0.5, -1)
        dense = torch.where(keep, p / (1 - rate), 0.0) @ ts[2]
        np.testing.assert_allclose(o.numpy(), dense.detach().numpy(),
                                   atol=1e-12)
        dense.backward(do)
        for got, t in zip((dq, dk, dv), ts):
            np.testing.assert_allclose(got.numpy(), t.grad.numpy(),
                                       atol=1e-12)

    @pytest.mark.parametrize("rate", [0.0, 0.3])
    def test_gradcheck_plain_float64(self, rate):
        gen = np.random.default_rng(28)
        q, k, v = (torch.from_numpy(gen.normal(size=s)).requires_grad_()
                   for s in ((1, 2, 5, 8), (1, 2, 6, 8), (1, 2, 6, 8)))
        assert torch.autograd.gradcheck(
            lambda q, k, v: flash_attention(q, k, v, rate, SEED), (q, k, v),
            eps=1e-6, atol=1e-6)

    def test_multi_head_attention_draws_one_seed_per_call(self):
        q = torch.from_numpy(rand((1, 9, 64), 29))
        outs = [multi_head_attention(q, q, q, 2, 0.5,
                                     torch.Generator().manual_seed(s))
                for s in (0, 0, 1)]
        assert torch.equal(outs[0], outs[1])
        assert not torch.equal(outs[0], outs[2])
        # Without a generator there is no dropout.
        assert torch.equal(multi_head_attention(q, q, q, 2, 0.5),
                           multi_head_attention(q, q, q, 2))


# ---------------------------------------------------------------------------
# Residual dropout and the fused activations: distribution only.
# ---------------------------------------------------------------------------

class TestDropout:
    def test_quantized_rate_and_scale(self):
        from av_separation_torch.ops.dropout import (fast_dropout,
                                                     quantized_rate)
        assert quantized_rate(0.1) == 26 and quantized_rate(0.0001) == 1
        assert quantized_rate(0.9999) == 255
        x = torch.ones(1 << 20)
        out = fast_dropout(x, 0.1, torch.Generator().manual_seed(0))
        kept = out[out != 0]
        assert torch.all(kept == torch.tensor(1.0 / (1.0 - 26 / 256)))
        # 2^20 Bernoulli(26/256) draws: 5 sigma is 0.0015.
        assert abs(float((out == 0).float().mean()) - 26 / 256) < 0.0015
        # Mean-unbiased: the survivor scale uses the quantized rate.
        assert abs(float(out.mean()) - 1.0) < 0.0017

    def test_backward_takes_the_forward_mask(self):
        from av_separation_torch.ops.dropout import fast_dropout
        x = torch.ones(4096, requires_grad=True)
        out = fast_dropout(x, 0.3, torch.Generator().manual_seed(1))
        out.sum().backward()
        assert torch.equal(x.grad, out.detach())

    def test_module_identity_in_eval_and_needs_generator(self):
        from av_separation_torch.ops.dropout import Dropout
        drop = Dropout(0.1)
        x = torch.randn(8, 8)
        assert drop.eval()(x) is x
        with pytest.raises(ValueError, match="generator"):
            drop.train()(x)

    @pytest.mark.parametrize("kind", ["relu", "gelu"])
    def test_fused_activation_matches_unfused(self, kind):
        """Output and gradient against autograd of activation * mask *
        scale with the same bits (same generator seed)."""
        import torch.nn.functional as F

        from av_separation_torch.ops.activations import (gelu_dropout,
                                                         relu_dropout)
        from av_separation_torch.ops.dropout import (keep_bits, keep_scale,
                                                     quantized_rate)
        fused = {"relu": relu_dropout, "gelu": gelu_dropout}[kind]
        act = {"relu": torch.relu, "gelu": F.gelu}[kind]
        x = torch.from_numpy(rand((64, 96), 30))
        g = torch.from_numpy(rand((64, 96), 31))
        n = quantized_rate(0.1)
        keep = keep_bits(x.shape, torch.Generator().manual_seed(7),
                         "cpu") >= n
        xa = x.clone().requires_grad_()
        ref = torch.where(keep, act(xa) * keep_scale(n), 0.0)
        ref.backward(g)
        xb = x.clone().requires_grad_()
        out = fused(xb, 0.1, torch.Generator().manual_seed(7))
        out.backward(g)
        assert torch.equal(out.detach(), ref.detach())
        # GELU's derivative is recomputed in closed form: float32 rounding.
        np.testing.assert_allclose(xb.grad.numpy(), xa.grad.numpy(),
                                   atol=1e-6, rtol=1e-5)
        plain = fused(x, 0.0, None)
        assert torch.equal(plain, act(x))


# ---------------------------------------------------------------------------
# Backward rules of the fused projection and decoder.
# ---------------------------------------------------------------------------

class TestFusedBackward:
    # Float32 sums of up to 2 * 37 * 3 products per weight gradient.
    def test_audio_projection_matches_jax_vjp(self):
        from av_separation_tpu.ops.pallas.audio_proj import (
            fused_audio_projection)
        b, t, f, d = 2, 37, 65, 64
        args = [rand((b, t, f), 32), rand((3, f, d), 33, 0.1),
                rand((d,), 34, 0.1), rand((3, d, d), 35, 0.1),
                rand((d,), 36, 0.1)]
        g = rand((b, t, d), 37)
        y_ref, vjp = jax.vjp(fused_audio_projection,
                             *(jnp.asarray(a) for a in args))
        want = vjp(jnp.asarray(g))
        ts = [torch.from_numpy(a).requires_grad_() for a in args]
        y = audio_projection(*ts)
        y.backward(torch.from_numpy(g))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                                   atol=2e-5, rtol=1e-4)
        for name, t_, w in zip(("x", "w1", "b1", "w2", "b2"), ts, want):
            np.testing.assert_allclose(t_.grad.numpy(), np.asarray(w),
                                       atol=5e-5, rtol=1e-4, err_msg=name)

    # The Pallas forward's erf approximation (1.5e-7) reaches the decoder
    # gradients through the saved masks: 2e-5 on O(1) sums.
    def test_mask_decoder_matches_jax_vjp(self):
        from av_separation_tpu.ops.pallas.decoder import fused_mask_decoder
        b, t, d, s, f = 2, 37, 64, 2, 65
        args = [rand((b, t, d), 38), rand((d, 2 * d), 39, 0.05),
                rand((2 * d,), 40, 0.05), rand((2 * d, s * f), 41, 0.05),
                rand((s * f,), 42, 0.05), rand((b, f, t), 43)]
        g_sep, g_mask = rand((b, s, f, t), 44), rand((b, s, f, t), 45)
        _, vjp = jax.vjp(lambda *a: fused_mask_decoder(*a, s, f),
                         *(jnp.asarray(a) for a in args))
        want = vjp((jnp.asarray(g_sep), jnp.asarray(g_mask)))
        # The port takes the weights in the torch Linear layout (out, in)
        # and returns their gradients in it.
        ts = [torch.from_numpy(np.ascontiguousarray(a.T if i in (1, 3)
                                                    else a)).requires_grad_()
              for i, a in enumerate(args)]
        sep, masks = mask_decoder(*ts, s)
        torch.autograd.backward((sep, masks), (torch.from_numpy(g_sep),
                                               torch.from_numpy(g_mask)))
        for i, (name, t_, w) in enumerate(zip(
                ("x", "w1", "b1", "w2", "b2", "mixed"), ts, want)):
            got = t_.grad.numpy()
            np.testing.assert_allclose(got.T if i in (1, 3) else got,
                                       np.asarray(w), atol=2e-5, rtol=1e-4,
                                       err_msg=name)
