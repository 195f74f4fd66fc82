"""The arithmetic of the port's tensor-core and FFT kernel designs, on the
CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them against
their plain versions there).  These tests hold, in numpy, the algorithms the
kernels implement, against the port's plain versions and the JAX Pallas
kernels in interpret mode:

  - `csrc/stft_fft.cu`: the half-length complex FFT (radix-4 Stockham, the
    kernel's own float32 twiddle table and index arithmetic) plus the split
    step into the bins of the real transform;
  - `csrc/flash_attn_fwd.cu`: 3xTF32 products (TF32 big and small parts
    by the kernel's mask, or by cvt.rna.tf32.f32; big*small + small*big +
    big*big) inside the kernel's tile-by-tile online softmax; 1xTF32 does
    not hold the float32 tolerance;
and the STFT wrapper's choice of route and tile by shape.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from av_separation_torch.ops.kernels.attention import (flash_attn_fwd_torch,
                                                       keep_mask)
from av_separation_torch.ops.kernels.stft import (MAX_SMEM_BYTES, _check,
                                                  fft_smem_bytes, fft_tables,
                                                  fft_tile_frames, route,
                                                  stft_magnitude_fwd_torch)

SEED = -1234567


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# The STFT magnitude as a half-length complex FFT.
# ---------------------------------------------------------------------------

def fft_stft_emulated(audio: np.ndarray, n_fft: int, hop: int,
                      num_frames: int) -> np.ndarray:
    """(B, N) float32 -> (B, F, T) float32 by the steps of stft_fft.cu, in
    float32: window, pack z[n] = x[2n] + i x[2n+1], Stockham stages (one
    radix-2 stage when log2(M) is odd, then radix-4) with the kernel's
    twiddle indices, split step, magnitude."""
    f32 = np.float32
    window, tw = fft_tables(n_fft)
    m = n_fft // 2
    log2m = m.bit_length() - 1
    b, n = audio.shape
    pad = max(0, (num_frames - 1) * hop + n_fft - n)
    padded = np.pad(audio, ((0, 0), (0, pad)))
    idx = np.arange(num_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    x = padded[:, idx] * window                      # (B, T, n_fft) float32
    zr, zi = x[..., 0::2].copy(), x[..., 1::2].copy()

    def twiddle_at(idx):  # W^idx for idx in [0, 2M) from W^0 .. W^M
        sign = np.where(idx <= m, f32(1), f32(-1))
        idx = np.where(idx <= m, idx, idx - m)
        return sign * tw[idx, 0], sign * tw[idx, 1]

    def cmul(ar, ai, br, bi):
        return ar * br - ai * bi, ar * bi + ai * br

    log2ns = 0
    if log2m & 1:  # one radix-2 stage
        j = np.arange(m // 2)
        v0r, v0i = zr[..., j], zi[..., j]
        v1r, v1i = zr[..., j + m // 2], zi[..., j + m // 2]
        outr, outi = np.empty_like(zr), np.empty_like(zi)
        outr[..., 2 * j], outi[..., 2 * j] = v0r + v1r, v0i + v1i
        outr[..., 2 * j + 1], outi[..., 2 * j + 1] = v0r - v1r, v0i - v1i
        zr, zi = outr, outi
        log2ns = 1
    q = m // 4
    j = np.arange(q)
    while log2ns < log2m:  # radix-4 stages
        ns = 1 << log2ns
        k = j & (ns - 1)
        t = k << (log2m - 1 - log2ns)
        v0r, v0i = zr[..., j], zi[..., j]
        v1r, v1i = cmul(zr[..., j + q], zi[..., j + q], *twiddle_at(t))
        v2r, v2i = cmul(zr[..., j + 2 * q], zi[..., j + 2 * q],
                        *twiddle_at(2 * t))
        v3r, v3i = cmul(zr[..., j + 3 * q], zi[..., j + 3 * q],
                        *twiddle_at(3 * t))
        a0r, a0i = v0r + v2r, v0i + v2i
        a1r, a1i = v0r - v2r, v0i - v2i
        a2r, a2i = v1r + v3r, v1i + v3i
        a3r, a3i = v1i - v3i, v3r - v1r          # -i (v1 - v3)
        d = ((j - k) << 2) + k
        outr, outi = np.empty_like(zr), np.empty_like(zi)
        outr[..., d], outi[..., d] = a0r + a2r, a0i + a2i
        outr[..., d + ns], outi[..., d + ns] = a1r + a3r, a1i + a3i
        outr[..., d + 2 * ns], outi[..., d + 2 * ns] = a0r - a2r, a0i - a2i
        outr[..., d + 3 * ns], outi[..., d + 3 * ns] = a1r - a3r, a1i - a3i
        zr, zi = outr, outi
        log2ns += 2
    k = np.arange(m + 1)
    zkr, zki = zr[..., k & (m - 1)], zi[..., k & (m - 1)]
    zmr, zmi = zr[..., (m - k) & (m - 1)], zi[..., (m - k) & (m - 1)]
    ar, ai = zkr + zmr, zki - zmi
    br, bi = zkr - zmr, zki + zmi
    wr, wi = tw[:, 0], tw[:, 1]
    wbr, wbi = wr * br - wi * bi, wr * bi + wi * br
    xr, xi = f32(0.5) * (ar + wbi), f32(0.5) * (ai - wbr)
    mag = np.sqrt(xr * xr + xi * xi).astype(f32)
    return np.swapaxes(mag, -1, -2)


class TestFftStft:
    # Float32 sums over n_fft windowed samples in another order than the
    # matrix DFT (peaks up to ~150 on unit-normal audio at n_fft 4096): the
    # kernel's 2e-4 tolerance against its plain version on the card.
    @pytest.mark.parametrize("n_fft,hop,n", [(8, 4, 300), (16, 8, 500),
                                             (128, 64, 2000),
                                             (512, 128, 8000),
                                             (4096, 1024, 12288)])
    def test_matches_plain_and_pallas(self, n_fft, hop, n):
        from av_separation_tpu.ops.pallas.stft import stft_magnitude_pallas
        audio = rand((2, n), 50 + n_fft)
        frames = 1 + n // hop
        ours = fft_stft_emulated(audio, n_fft, hop, frames)
        plain = stft_magnitude_fwd_torch(torch.from_numpy(audio), n_fft,
                                         hop).numpy()
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(stft_magnitude_pallas(audio, n_fft, hop))
        assert ours.shape == plain.shape == (2, n_fft // 2 + 1, frames)
        np.testing.assert_allclose(ours, plain, atol=2e-4, rtol=0)
        np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)

    def test_tail_frame_and_split_edges(self):
        # The last frame starts at N and reads only zeros; bins 0 and M come
        # from Z[0] alone (Z[M] = Z[0]) and are the real sums of the even
        # and odd windowed samples.
        n_fft, hop, n = 64, 32, 256
        audio = rand((1, n), 51)
        frames = 1 + n // hop
        ours = fft_stft_emulated(audio, n_fft, hop, frames)
        assert np.all(ours[..., -1] == 0.0)
        window, _ = fft_tables(n_fft)
        x = (audio[0, :n_fft] * window).astype(np.float64)
        np.testing.assert_allclose(ours[0, 0, 0], abs(x.sum()), rtol=1e-5)
        np.testing.assert_allclose(ours[0, -1, 0],
                                   abs(x[0::2].sum() - x[1::2].sum()),
                                   rtol=1e-5, atol=1e-5)

    def test_twiddle_table_is_rounded_from_float64(self):
        window, tw = fft_tables(512)
        assert window.dtype == tw.dtype == np.float32
        assert tw.shape == (257, 2) and tw.flags.c_contiguous
        k = np.arange(257)
        np.testing.assert_array_equal(
            tw[:, 0], np.cos(-2 * np.pi * k / 512).astype(np.float32))
        assert tw[0, 1] == 0.0 and tw[256, 0] == -1.0


class TestStftRoute:
    @pytest.mark.parametrize("n_fft,want", [
        (8, "fft"), (128, "fft"), (512, "fft"), (4096, "fft"), (4, "dft"),
        (400, "dft"), (12, "dft"), (8192, "dft")])
    def test_route_by_n_fft(self, n_fft, want):
        assert route(n_fft) == want

    @pytest.mark.parametrize("signals,frames,tile", [
        (24, 501, 8),    # scaled device batch: 1,512 blocks
        (24, 63, 4),     # demo device batch: 384 blocks
        (3, 32, 1),      # odd shape: at most 96 blocks, the smallest tile
        (1, 10, 1)])
    def test_tile_fills_the_sms(self, signals, frames, tile):
        assert fft_tile_frames(512, 128, signals, frames, 132) == tile

    def test_tile_fits_shared_memory_at_4096(self):
        tile = fft_tile_frames(4096, 1024, 4096, 501, 132)
        assert tile == 4
        assert fft_smem_bytes(4096, 1024, tile) <= MAX_SMEM_BYTES
        assert fft_smem_bytes(4096, 1024, 2 * tile) > MAX_SMEM_BYTES

    @pytest.mark.parametrize("audio,n_fft,hop,match", [
        (torch.zeros(2, 300), 400, 32, "not a power of two"),
        (torch.zeros(2, 300, dtype=torch.float64), 512, 128, "float32"),
        (torch.zeros(65536, 8), 8, 4, "signals"),
        (torch.zeros(2, 300), 64, 30, "hop 30")])
    def test_fft_route_inputs_are_checked(self, audio, n_fft, hop, match):
        with pytest.raises(ValueError, match=match):
            _check(audio, n_fft, hop, 1 + audio.shape[-1] // hop, "fft")

    def test_dft_route_keeps_its_checks(self):
        # A shape the DFT route refuses (its 32-frame tile) is one the FFT
        # route serves: the check goes with the route.
        audio = torch.zeros(2, 300)
        with pytest.raises(ValueError, match="shared memory"):
            _check(audio, 512, 2048, 1, "dft")
        _check(audio, 512, 2048, 1, "fft")


# ---------------------------------------------------------------------------
# 3xTF32 products inside the flash forward's online softmax.
# ---------------------------------------------------------------------------

def tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round float32 to 10 mantissa bits, ties away from
    zero, kept in float32 layout with the low 13 bits zero."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_trunc(x: np.ndarray) -> np.ndarray:
    """The top 10 mantissa bits of a float32: the kernel's mask, and what
    the tensor core reads from an operand register."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x: np.ndarray, kind: str = "mask"):
    """x -> (big, small) as the tensor core sees them.  "mask" is the
    kernel's `split` (big = the masked x, small = x - big, read truncated);
    "rna" rounds both parts with cvt.rna.tf32.f32."""
    x = np.asarray(x, np.float32)
    if kind == "rna":
        big = tf32_rna(x)
        return big, tf32_rna(x - big)
    big = tf32_trunc(x)
    return big, tf32_trunc(x - big)


def product(a: np.ndarray, b: np.ndarray, passes: int,
            kind: str = "mask") -> np.ndarray:
    """a @ b on the tensor cores: 3 passes (big*small + small*big +
    big*big, CUTLASS's OpMultiplyAddFastF32) or 1 (big*big), each product
    of TF32 values exact and summed in float64, rounded to float32."""
    ab, as_ = split_tf32(a, kind)
    bb, bs = split_tf32(b, kind)
    f64 = np.float64
    acc = ab.astype(f64) @ bb.astype(f64)
    if passes == 3:
        acc += as_.astype(f64) @ bb.astype(f64) + ab.astype(f64) @ bs
    return acc.astype(np.float32)


def flash_tiles_emulated(q, k, v, rate, seed, passes, kind="mask",
                         block_k=32):
    """(Tq, dh), (Tk, dh) for one head -> (o, lse) as the kernel computes
    them: key tiles of 32, the running max and sum rescaled per tile, l
    over the undropped p, dropped p zeroed before PV."""
    f32 = np.float32
    tq, dh = q.shape
    tk = k.shape[0]
    scale = f32(1.0 / np.sqrt(dh))
    keep = keep_mask(seed, 1, 1, tq, tk, rate).numpy()[0, 0] if rate \
        else np.ones((tq, tk), bool)
    m = np.full(tq, -np.inf, f32)
    l = np.zeros(tq, f32)
    acc = np.zeros((tq, dh), f32)
    for k0 in range(0, tk, block_k):
        s = product(q, k[k0:k0 + block_k].T, passes, kind) * scale
        m_new = np.maximum(m, s.max(axis=1))
        alpha = np.exp(m - m_new).astype(f32)
        p = np.exp(s - m_new[:, None]).astype(f32)
        l = l * alpha + p.sum(axis=1, dtype=f32)
        p = np.where(keep[:, k0:k0 + block_k], p, f32(0))
        acc = acc * alpha[:, None] + product(p, v[k0:k0 + block_k], passes,
                                             kind)
        m = m_new
    o = acc / (l * f32(1.0 - rate))[:, None]
    return o, m + np.log(l)


class TestThreeTf32:
    def test_rna_rounds_and_mask_truncates_to_ten_mantissa_bits(self):
        ulp = 2.0 ** -10
        x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -20,
                      1 + 3 * ulp / 2, 3.0], np.float32)
        np.testing.assert_array_equal(
            tf32_rna(x), np.array([1 + ulp, -(1 + ulp), 1, 1 + 2 * ulp, 3],
                                  np.float32))
        np.testing.assert_array_equal(
            tf32_trunc(x), np.array([1, -1, 1, 1 + ulp, 3], np.float32))
        for kind in ("mask", "rna"):
            x = rand((1000,), 60)
            big, small = split_tf32(x, kind)
            assert np.all(big.view(np.uint32) & 0x1FFF == 0)
            assert np.all(small.view(np.uint32) & 0x1FFF == 0)
            # The two parts keep ~21 of float32's 24 bits.
            assert np.all(np.abs(big.astype(np.float64) + small - x)
                          <= 2.0 ** -20 * np.abs(x))

    # The audio self-attention shape (Tq = Tk = 501, dh 128) with B and H
    # cut to 1: 3xTF32 holds the kernel's float32 tolerances (2e-5 on o,
    # 1e-4 on lse) against the plain float32 version, 1xTF32 does not; with
    # the kernel's masking split and with cvt.rna.
    @pytest.mark.parametrize("kind", ["mask", "rna"])
    @pytest.mark.parametrize("rate", [0.0, 0.1])
    def test_3xtf32_holds_float32_tolerance_and_1xtf32_does_not(self, rate,
                                                                kind):
        t, dh = 501, 128
        q, k, v = rand((t, dh), 61), rand((t, dh), 62), rand((t, dh), 63)
        o_ref, lse_ref = flash_attn_fwd_torch(
            *(torch.from_numpy(x)[None, None] for x in (q, k, v)), rate,
            SEED)
        o_ref, lse_ref = o_ref[0, 0].numpy(), lse_ref[0, 0].numpy()
        o3, lse3 = flash_tiles_emulated(q, k, v, rate, SEED, 3, kind)
        assert np.abs(o3 - o_ref).max() <= 2e-5
        assert np.abs(lse3 - lse_ref).max() <= 1e-4
        o1, _ = flash_tiles_emulated(q, k, v, rate, SEED, 1, kind)
        assert np.abs(o1 - o_ref).max() > 2e-5
