"""The arithmetic of the port's tensor-core and FFT kernel designs, on the
CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them against
their plain versions there).  These tests hold, in numpy, the algorithms the
kernels implement, against the port's plain versions and the JAX Pallas
kernels in interpret mode:

  - `csrc/stft_fft.cu`: the FFT of every n_fft >= 2 (half-length
    packing of an even n_fft, two frames a sequence for an odd one;
    Stockham stages over the host's plan of radices 2, 3, 4, 5, 7 and 8,
    direct prime radices 11 to 31, Rader's convolution over L - 1 for a
    prime L, or Bluestein's chirp-z transform over a 7-smooth P; the
    kernel's own float32 tables, permutations, butterfly constants and
    index arithmetic: shifts and masks for a power of two,
    multiply-and-shift divisions otherwise)
    plus the split or separation step into the bins of the real transform;
    one block a tile of frames, or one a frame above 4096 where it fits,
    and beyond the four-step FFT's passes (columns, twiddles, rows, under
    Bluestein the chirp's product and the inverse's transposed passes, the
    last pass's pairs) with the plan of every n_fft in (4096, 65536];
  - `csrc/flash_attn_fwd.cu`: 3xTF32 products (TF32 big and small parts
    by the kernel's mask, or by cvt.rna.tf32.f32; big*small + small*big +
    big*big) inside the kernel's tile-by-tile online softmax; 1xTF32 does
    not hold the float32 tolerance;
  - `csrc/flash_attn_bwd.cu`: the same 3xTF32 products in the backward's
    tiles (dK/dV over 64-key blocks and 16-query tiles, dQ over 64-row
    blocks and 16-key tiles, no atomics) with the JAX dropout mask;
  - `csrc/mask_decoder.cu`: both GEMMs in 3xTF32 over the kernel's row
    tiles, 256-column chunks (S*F padded) and 32-deep k tiles, the GELU
    tile kept between them, the sigmoid and the transposed (S, F, T) store;
  - `csrc/audio_proj.cu` at a float32 x: both convs as products of
    three-part bf16 operands over the kernel's frame tiles (hidden rows
    with their halo, zero outside [0, T)), the input channels in chunks of
    64 (257 -> 320, the tail zero); its bf16 x and layouts are
    test_torch_proj_wgmma_design.py's;
  - the widths the projection and decoder kernels are not built for, run
    zero-padded to the next one they are;
and the wrappers' choice of route, plan and tile by shape.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from av_separation_torch.ops.kernels.attention import (flash_attn_bwd_torch,
                                                       flash_attn_fwd_torch,
                                                       keep_mask)
from av_separation_torch.ops.kernels.stft import (FFT_TILES,
                                                  MAX_PAD, MAX_SMEM_BYTES,
                                                  MAX_STAGES, PRIMES,
                                                  SMEM_SHARES, STAGED_MAX,
                                                  STAGE_TABLE_BYTES,
                                                  TINY_N_FFT, TINY_TILES,
                                                  _check, _chirp_tables,
                                                  fft_plan, fft_sequences,
                                                  fft_smem_bytes, fft_tables,
                                                  fft_tile_frames,
                                                  four_step_plan,
                                                  four_step_sequences,
                                                  four_step_tables,
                                                  primitive_root, radices,
                                                  route,
                                                  stft_magnitude_fwd_torch,
                                                  twiddle_half)

CSRC = Path(__file__).resolve().parents[1] / "av_separation_torch" / "csrc"

SEED = -1234567


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# The STFT magnitude as an FFT: half-length packing (even n_fft) or two
# frames a sequence (odd), mixed radix 2-7 or Bluestein.
# ---------------------------------------------------------------------------

def fast_div(n, d):
    """The kernel's `FastDiv`: n // d as (n * m) >> 31, m = ceil(2^31 / d),
    exact while n (m d - 2^31) < 2^31 (so wherever n d <= 2^31)."""
    m = ((1 << 31) + d - 1) // d
    return (np.asarray(n, np.uint64) * np.uint64(m)) >> np.uint64(31)


def kernel_divisions(n_fft, tile):
    """Every (divisor, largest numerator) the kernel divides by FastDiv at
    one n_fft and tile: the sequence index by the FFT length (every plan
    but a power-of-two L), each such stage's butterfly index by len / R
    and the butterfly by the stride ns, and the split step's index by F.
    A power-of-two L uses shifts."""
    plan = fft_plan(n_fft)
    seq, f = fft_sequences(n_fft, tile), n_fft // 2 + 1
    out = [(f, seq * f - 1)]
    n = plan.size
    if plan.kind != "pow2":
        out.append((n, seq * n - 1))
        ns = 1
        for r in plan.radices:
            out += [(n // r, seq * n // r - 1), (ns, n // r - 1)]
            ns *= r
    return out


# The kernel's butterfly constants, float64 rounded to float32.
C5A, C5B = np.float32(np.cos(2 * np.pi / 5)), np.float32(np.cos(4 * np.pi / 5))
S5A, S5B = np.float32(np.sin(2 * np.pi / 5)), np.float32(np.sin(4 * np.pi / 5))
S3 = np.float32(np.sin(2 * np.pi / 3))
C7 = [np.float32(np.cos(2 * np.pi * j / 7)) for j in (1, 2, 3)]
S7 = [np.float32(np.sin(2 * np.pi * j / 7)) for j in (1, 2, 3)]
S8 = np.float32(np.sin(np.pi / 4))
# The prime radices' cos and sin of 2 pi k / p, k = 1 .. (p - 1) / 2,
# float64 rounded to float32 (`kPrimeTrig`).
PRIME_COS = {p: [np.float32(np.cos(2 * np.pi * k / p))
                 for k in range(1, (p + 1) // 2)] for p in PRIMES}
PRIME_SIN = {p: [np.float32(np.sin(2 * np.pi * k / p))
                 for k in range(1, (p + 1) // 2)] for p in PRIMES}


def prime_butterfly(vr, vi):
    """stft_fft.cu's `prime_step` after its twiddles: the R-point DFT from
    the pairs a_j = v_j + v_(R-j), b_j = v_j - v_(R-j), summed in the
    kernel's order: X_0 = v_0 + a_1 + a_2 ..., X_m = c_m - i s_m,
    X_(R-m) = c_m + i s_m, c_m = v_0 + sum_j cos(2 pi m j / R) a_j,
    s_m = sum_j sin(2 pi m j / R) b_j (cos even, sin odd in m j mod R)."""
    r = len(vr)
    h = (r - 1) // 2
    ar = [vr[j] + vr[r - j] for j in range(1, h + 1)]
    ai = [vi[j] + vi[r - j] for j in range(1, h + 1)]
    br = [vr[j] - vr[r - j] for j in range(1, h + 1)]
    bi = [vi[j] - vi[r - j] for j in range(1, h + 1)]
    sr, si = vr[0], vi[0]
    for j in range(h):
        sr, si = sr + ar[j], si + ai[j]
    outr, outi = [sr] + [None] * (r - 1), [si] + [None] * (r - 1)
    for m in range(1, h + 1):
        cr, ci, dr, di = vr[0], vi[0], np.float32(0), np.float32(0)
        for j in range(1, h + 1):
            e = m * j % r
            cv = PRIME_COS[r][(e if e <= h else r - e) - 1]
            sv = PRIME_SIN[r][e - 1] if e <= h else -PRIME_SIN[r][r - e - 1]
            cr, ci = cr + cv * ar[j - 1], ci + cv * ai[j - 1]
            dr, di = dr + sv * br[j - 1], di + sv * bi[j - 1]
        outr[m], outi[m] = cr + di, ci - dr              # c - i s
        outr[r - m], outi[r - m] = cr - di, ci + dr      # c + i s
    return outr, outi


def butterfly(vr, vi):
    """The R-point DFT of stft_fft.cu's `butterfly<R>` on lists of R
    real and imaginary float32 arrays, term by term as the kernel sums."""
    f32, r = np.float32, len(vr)
    if r > 8:
        return prime_butterfly(vr, vi)
    if r == 2:
        return [vr[0] + vr[1], vr[0] - vr[1]], [vi[0] + vi[1], vi[0] - vi[1]]
    if r == 4:
        a0r, a0i = vr[0] + vr[2], vi[0] + vi[2]
        a1r, a1i = vr[0] - vr[2], vi[0] - vi[2]
        a2r, a2i = vr[1] + vr[3], vi[1] + vi[3]
        a3r, a3i = vi[1] - vi[3], vr[3] - vr[1]          # -i (v1 - v3)
        return ([a0r + a2r, a1r + a3r, a0r - a2r, a1r - a3r],
                [a0i + a2i, a1i + a3i, a0i - a2i, a1i - a3i])
    if r == 8:
        # Two radix-4 DFTs of the even and odd terms: X_m = E_m + W8^m O_m,
        # X_{m+4} = E_m - W8^m O_m.
        er, ei = butterfly(vr[0::2], vi[0::2])
        o_r, o_i = butterfly(vr[1::2], vi[1::2])
        tr = [o_r[0], S8 * (o_r[1] + o_i[1]), o_i[2], S8 * (o_i[3] - o_r[3])]
        ti = [o_i[0], S8 * (o_i[1] - o_r[1]), -o_r[2],
              -(S8 * (o_r[3] + o_i[3]))]
        return ([er[m] + tr[m] for m in range(4)]
                + [er[m] - tr[m] for m in range(4)],
                [ei[m] + ti[m] for m in range(4)]
                + [ei[m] - ti[m] for m in range(4)])
    if r == 3:
        tr, ti = vr[1] + vr[2], vi[1] + vi[2]
        dr, di = vr[1] - vr[2], vi[1] - vi[2]
        cr, ci = vr[0] - f32(0.5) * tr, vi[0] - f32(0.5) * ti
        mr, mi = S3 * di, -S3 * dr                       # -i sin(2pi/3) d
        return [vr[0] + tr, cr + mr, cr - mr], [vi[0] + ti, ci + mi, ci - mi]
    if r == 7:
        # Pairs v_j +- v_{7-j}; X_m = c_m - i s_m, X_{7-m} = c_m + i s_m,
        # c_m = v0 + sum_j cos(2 pi m j / 7) a_j, s_m = sum_j sin(..) b_j.
        ar = [vr[j] + vr[7 - j] for j in (1, 2, 3)]
        ai = [vi[j] + vi[7 - j] for j in (1, 2, 3)]
        br = [vr[j] - vr[7 - j] for j in (1, 2, 3)]
        bi = [vi[j] - vi[7 - j] for j in (1, 2, 3)]
        c1, c2, c3 = C7
        s1, s2, s3 = S7
        cos_rows = [(c1, c2, c3), (c2, c3, c1), (c3, c1, c2)]
        sin_rows = [(s1, s2, s3), (s2, -s3, -s1), (s3, -s1, s2)]
        outr, outi = [vr[0] + ar[0] + ar[1] + ar[2]] + [None] * 6, \
            [vi[0] + ai[0] + ai[1] + ai[2]] + [None] * 6
        for m in (1, 2, 3):
            (p, q, t), (u, v, w) = cos_rows[m - 1], sin_rows[m - 1]
            cr = vr[0] + p * ar[0] + q * ar[1] + t * ar[2]
            ci = vi[0] + p * ai[0] + q * ai[1] + t * ai[2]
            sr = u * br[0] + v * br[1] + w * br[2]
            si = u * bi[0] + v * bi[1] + w * bi[2]
            outr[m], outi[m] = cr + si, ci - sr          # c - i s
            outr[7 - m], outi[7 - m] = cr - si, ci + sr  # c + i s
        return outr, outi
    a1r, a1i = vr[1] + vr[4], vi[1] + vi[4]
    b1r, b1i = vr[1] - vr[4], vi[1] - vi[4]
    a2r, a2i = vr[2] + vr[3], vi[2] + vi[3]
    b2r, b2i = vr[2] - vr[3], vi[2] - vi[3]
    c1r, c1i = vr[0] + C5A * a1r + C5B * a2r, vi[0] + C5A * a1i + C5B * a2i
    c2r, c2i = vr[0] + C5B * a1r + C5A * a2r, vi[0] + C5B * a1i + C5A * a2i
    e1r, e1i = S5A * b1i + S5B * b2i, -(S5A * b1r + S5B * b2r)
    e2r, e2i = S5B * b1i - S5A * b2i, -(S5B * b1r - S5A * b2r)
    return ([vr[0] + a1r + a2r, c1r + e1r, c2r + e2r, c2r - e2r, c1r - e1r],
            [vi[0] + a1i + a2i, c1i + e1i, c2i + e2i, c2i - e2i, c1i - e1i])


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def stockham(zr, zi, plan_radices, tw, half):
    """The kernel's Stockham stages over the last axis (length n = the
    product of the radices), float32, with its twiddle indices: shifts and
    masks for a power of two, `fast_div` by the host's per-stage constants
    otherwise (the kernel divides at every length but a power-of-two L: the
    same indices).  `tw` holds W^0 .. W^half of W = exp(-2 pi i / 2 half)."""
    f32 = np.float32
    n = zr.shape[-1]
    pow2 = n & (n - 1) == 0
    log2n, log2q = n.bit_length() - 1, (2 * half).bit_length() - 1

    def twiddle_at(idx):  # W^idx for idx in [0, 2 half)
        sign = np.where(idx <= half, f32(1), f32(-1))
        idx = np.where(idx <= half, idx, idx - half)
        return sign * tw[idx, 0], sign * tw[idx, 1]

    ns, log2ns = 1, 0
    for r in plan_radices:
        mr = n // r
        j = np.arange(mr)       # the butterflies of one sequence
        if pow2:
            log2r = {2: 1, 4: 2, 8: 3}[r]
            k = j & (ns - 1)
            t = k << (log2q - log2r - log2ns)
            dst = ((j - k) << log2r) + k
        else:
            q = fast_div(j, ns).astype(np.int64)
            k = j - q * ns
            t = k * (2 * half // (r * ns))
            dst = q * ns * r + k
        vr, vi = [zr[..., j]], [zi[..., j]]
        for i in range(1, r):
            vr_i, vi_i = _cmul(zr[..., j + i * mr], zi[..., j + i * mr],
                               *twiddle_at(i * t))
            vr.append(vr_i)
            vi.append(vi_i)
        vr, vi = butterfly(vr, vi)
        outr, outi = np.empty_like(zr), np.empty_like(zi)
        for i in range(r):
            outr[..., dst + i * ns], outi[..., dst + i * ns] = vr[i], vi[i]
        zr, zi = outr, outi
        ns *= r
        log2ns += {2: 1, 4: 2, 8: 3}.get(r, 0)
    assert ns == n
    return zr, zi


def fft_stft_emulated(audio: np.ndarray, n_fft: int, hop: int,
                      num_frames: int, tile: int = 2) -> np.ndarray:
    """(B, N) float32 -> (B, F, T) float32 by the steps of stft_fft.cu, in
    float32: window; pack (even n_fft: z[n] = x[2n] + i x[2n+1], sample by
    sample, as the kernel reads at an odd hop; odd n_fft: frames 2s and
    2s + 1 of a tile as the real and imaginary parts, alone at tile 1);
    the FFT of L points by the plan's Stockham stages (prime radices
    included); under Rader the gather a[q] = z[g^q], the (L - 1)-point FFT,
    X[0] = z[0] + A[0], times the host's FFT(b) / (L - 1), conjugate, the
    FFT again, X[k] = z[0] + conj(V[p(k)]); under Bluestein z chirp,
    P-point FFT, times the chirp's transform, conjugate, P-point FFT,
    conjugate times the chirp; then the real split step (even) or the
    separation of the two frames (odd); magnitude."""
    f32 = np.float32
    tables = fft_tables(n_fft)
    plan = fft_plan(n_fft)
    length, pad = plan.length, plan.pad
    half = twiddle_half(plan)
    odd = n_fft % 2 == 1
    b, n = audio.shape
    frames = -(-num_frames // tile) * tile
    extra = max(0, (frames - 1) * hop + n_fft - n)
    padded = np.pad(audio, ((0, 0), (0, extra)))
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    x = padded[:, idx] * tables.window               # (B, frames, n_fft)
    if not odd:
        zr, zi = x[..., 0::2].copy(), x[..., 1::2].copy()
    elif tile > 1:
        zr, zi = x[:, 0::2].copy(), x[:, 1::2].copy()
    else:
        zr, zi = x.copy(), np.zeros_like(x)
    if plan.kind == "rader":
        m = plan.size
        gather, bins = tables.perm[:m], tables.perm[m:]
        z0r, z0i = zr[..., :1], zi[..., :1]
        ar, ai = stockham(zr[..., gather], zi[..., gather], plan.radices,
                          tables.twiddle, half)
        x0r, x0i = z0r[..., 0] + ar[..., 0], z0i[..., 0] + ai[..., 0]
        yr, yi = _cmul(ar, ai, tables.chirp_fft[:, 0], tables.chirp_fft[:, 1])
        vr, vi = stockham(yr, -yi, plan.radices, tables.twiddle, half)
        zr, zi = z0r + vr[..., bins], z0i - vi[..., bins]
        zr[..., 0], zi[..., 0] = x0r, x0i
    elif pad:
        cr, ci = tables.chirp[:, 0], tables.chirp[:, 1]
        zr, zi = _cmul(zr, zi, cr, ci)
        zr = np.concatenate([zr, np.zeros(zr.shape[:-1] + (pad - length,),
                                          f32)], axis=-1)
        zi = np.concatenate([zi, np.zeros(zi.shape[:-1] + (pad - length,),
                                          f32)], axis=-1)
        zr, zi = stockham(zr, zi, plan.radices, tables.twiddle, half)
        yr, yi = _cmul(zr, zi, tables.chirp_fft[:, 0], tables.chirp_fft[:, 1])
        zr, zi = stockham(yr, -yi, plan.radices, tables.twiddle, half)
        zr, zi = _cmul(cr, ci, zr[..., :length], -zi[..., :length])
    else:
        zr, zi = stockham(zr, zi, plan.radices, tables.twiddle, half)
    k = np.arange(n_fft // 2 + 1)
    if not odd:
        m = length
        kk, km = np.where(k == m, 0, k), np.where(k == 0, 0, m - k)
        zkr, zki, zmr, zmi = zr[..., kk], zi[..., kk], zr[..., km], zi[..., km]
        ar, ai = zkr + zmr, zki - zmi
        br, bi = zkr - zmr, zki + zmi
        wr, wi = tables.split[:, 0], tables.split[:, 1]
        wbr, wbi = wr * br - wi * bi, wr * bi + wi * br
        xr, xi = f32(0.5) * (ar + wbi), f32(0.5) * (ai - wbr)
        mag = np.sqrt(xr * xr + xi * xi).astype(f32)
    else:
        km = np.where(k == 0, 0, length - k)
        ar, ai, br, bi = zr[..., k], zi[..., k], zr[..., km], zi[..., km]
        pr, pi = ar + br, ai - bi                        # a + conj(b)
        qr, qi = ar - br, ai + bi                        # a - conj(b)
        first = f32(0.5) * np.sqrt(pr * pr + pi * pi)
        if tile == 1:
            mag = first
        else:
            second = f32(0.5) * np.sqrt(qr * qr + qi * qi)
            mag = np.stack([first, second], axis=2).reshape(
                b, frames, -1)
    return np.swapaxes(mag[:, :num_frames], -1, -2).astype(f32)


def plain_tol(peak):
    """The kernel's tolerance against its plain version: 2e-4 at the
    peaks of the tones (~100), scaled by the peak beyond that (float32
    sums of n_fft samples in another order)."""
    return 2e-4 * max(1.0, float(peak) / 100.0)


# Every kind of length: planned with radix 7 (448: L 224 = 2^5 7; 882:
# L 441 = 3^2 7^2, at an odd hop; odd 441); direct prime radices (286: L
# 143 = 11 13; 1102: L 551 = 19 29, at an odd hop; 46: L 23; 68: L 34 =
# 2 17; 1922: L 961 = 31^2); Rader (514: L 257 over 2^8; 1154: L 577 over
# 2^6 3^2; odd 401 over 2^4 5^2; 22, 26 and 62: L 11, 13 and 31 over 10,
# 12 and 30); Bluestein over a 7-smooth P (402: L 201 = 3 67, P 405; odd
# 4093 with P 8192, the largest block; 4098: L 2049, P 4116, one frame a
# block above 4096).
KINDS = [(62, 30, 600), (401, 160, 2000), (448, 112, 2000), (514, 128, 2000),
         (882, 441, 4000), (1102, 441, 4000), (4093, 1000, 6000),
         (441, 147, 3000), (22, 11, 300), (26, 13, 300), (286, 143, 2000),
         (1154, 577, 4000), (402, 100, 2000), (4098, 2049, 8196),
         (46, 23, 500), (68, 34, 700), (1922, 480, 4000)]


class TestFftStft:
    # Float32 sums over n_fft windowed samples in another order than the
    # matrix DFT (peaks up to ~150 on unit-normal audio at n_fft 4096): the
    # kernel's 2e-4 tolerance against its plain version on the card.
    # Mixed radix: the speech front ends' 400 / 160, 480 / 120 (a radix-3
    # stage), 320 / 80, and the short 24 / 12 and 40 / 20 (M = 12, 20).
    @pytest.mark.parametrize("n_fft,hop,n", [(8, 4, 300), (16, 8, 500),
                                             (128, 64, 2000),
                                             (512, 128, 8000),
                                             (4096, 1024, 12288),
                                             (400, 160, 8000),
                                             (480, 120, 6001),
                                             (320, 80, 4000),
                                             (24, 12, 500), (40, 20, 700)])
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

    # Every kind of length the FFT route now serves, against the plain
    # version (2e-4, scaled by the peak over 100), the Pallas kernel in
    # interpret mode and float64 numpy at tests/test_kernels.py's
    # tolerance for the Pallas kernel (5e-4 + 1e-4 rel).
    @pytest.mark.parametrize("n_fft,hop,n", KINDS)
    def test_every_kind_matches_plain_pallas_and_float64(self, n_fft, hop,
                                                         n):
        from av_separation_torch.data.synthetic import stft_magnitude_np
        from av_separation_tpu.ops.pallas.stft import stft_magnitude_pallas
        audio = rand((2, n), 60 + n_fft)
        frames = 1 + n // hop
        tile = fft_tile_frames(n_fft, hop, 2, frames, 132)
        ours = fft_stft_emulated(audio, n_fft, hop, frames, tile)
        plain = stft_magnitude_fwd_torch(torch.from_numpy(audio), n_fft,
                                         hop).numpy()
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(stft_magnitude_pallas(audio, n_fft, hop))
        want = np.stack([stft_magnitude_np(a, n_fft, hop, frames)
                         for a in audio])
        assert ours.shape == plain.shape == (2, n_fft // 2 + 1, frames)
        tol = plain_tol(want.max())
        np.testing.assert_allclose(ours, plain, atol=tol, rtol=0)
        np.testing.assert_allclose(ours, ref, atol=5e-4, rtol=1e-4)
        np.testing.assert_allclose(ours, want, atol=5e-4, rtol=1e-4)

    @pytest.mark.parametrize("n_fft", [3, 9, 401])
    def test_odd_n_fft_one_frame_a_tile(self, n_fft):
        # Tile 1: one frame in the real part, zeros in the imaginary.
        from av_separation_torch.data.synthetic import stft_magnitude_np
        audio = rand((1, 900), 61 + n_fft)
        frames = 1 + 900 // 7
        ours = fft_stft_emulated(audio, n_fft, 7, frames, tile=1)
        want = stft_magnitude_np(audio[0], n_fft, 7, frames)
        np.testing.assert_allclose(ours[0], want, atol=5e-4, rtol=1e-4)

    def test_tail_frame_and_split_edges(self):
        # The last frame starts at N and reads only zeros; bins 0 and M come
        # from Z[0] alone (Z[M] = Z[0]) and are the real sums of the even
        # and odd windowed samples.
        n_fft, hop, n = 64, 32, 256
        audio = rand((1, n), 51)
        frames = 1 + n // hop
        ours = fft_stft_emulated(audio, n_fft, hop, frames)
        assert np.all(ours[..., -1] == 0.0)
        window = fft_tables(n_fft).window
        x = (audio[0, :n_fft] * window).astype(np.float64)
        np.testing.assert_allclose(ours[0, 0, 0], abs(x.sum()), rtol=1e-5)
        np.testing.assert_allclose(ours[0, -1, 0],
                                   abs(x[0::2].sum() - x[1::2].sum()),
                                   rtol=1e-5, atol=1e-5)

    def test_fast_div_is_exact_where_the_kernel_divides(self):
        # Every divisor the kernel takes, at every n_fft of the FFT route
        # and every tile that fits, over its whole range of numerators:
        # checked at each q d - 1 (the largest remainder, where an error
        # would show first) and at the range's end.
        reach = {}
        for n_fft in range(2, STAGED_MAX + 1):
            for tile in TINY_TILES if n_fft <= TINY_N_FFT else FFT_TILES:
                if fft_smem_bytes(n_fft, 1, tile) > MAX_SMEM_BYTES:
                    continue
                for d, top in kernel_divisions(n_fft, tile):
                    reach[d] = max(reach.get(d, 0), top)
        assert max(reach) == 8192 and max(reach.values()) < 1 << 16
        for d, top in sorted(reach.items()):
            n = np.append(np.arange(d - 1, top + 1, d), top)
            np.testing.assert_array_equal(fast_div(n, d), n // d,
                                          err_msg=str(d))
            m = ((1 << 31) + d - 1) // d
            assert top * (m * d - (1 << 31)) < 1 << 31, d

    def test_butterfly_constants_are_rounded_from_float64(self):
        src = (CSRC / "stft_fft.cu").read_text()
        consts = dict(re.findall(r"constexpr float (k\w+) = ([-0-9.e]+)f;",
                                 src))
        want = {"kS3": S3, "kC5a": C5A, "kC5b": C5B, "kS5a": S5A,
                "kS5b": S5B, "kC7a": C7[0], "kC7b": C7[1], "kC7c": C7[2],
                "kS7a": S7[0], "kS7b": S7[1], "kS7c": S7[2], "kS8": S8}
        assert set(consts) == set(want)
        for name, value in consts.items():
            assert np.float32(float(value)) == want[name], name

    def test_prime_radix_constants_are_rounded_from_float64(self):
        # kPrimeTrig: for p = 11, 13, ..., 31 in turn, cos and then sin of
        # 2 pi k / p, k = 1 .. (p - 1) / 2.
        src = (CSRC / "stft_fft.cu").read_text()
        body = src[src.index("kPrimeTrig[136] = {"):]
        body = body[body.index("{") + 1:body.index("};")]
        got = [float(v) for v in re.findall(r"(-?[0-9.]+(?:e-?\d+)?)f", body)]
        want = [v for p in PRIMES for v in PRIME_COS[p] + PRIME_SIN[p]]
        assert len(got) == len(want) == 136
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.float32(g) == w, i
        assert PRIMES == (11, 13, 17, 19, 23, 29, 31)
        assert "constexpr int kMaxPrime = 31;" in src

    @pytest.mark.parametrize("r", [2, 3, 4, 5, 7, 8, *PRIMES])
    def test_butterfly_is_the_r_point_dft(self, r):
        v = rand((2, r, 16), 52 + r)
        got_r, got_i = butterfly(list(v[0]), list(v[1]))
        want = np.fft.fft(v[0].astype(np.float64) + 1j * v[1], axis=0)
        np.testing.assert_allclose(np.array(got_r), want.real, atol=1e-5)
        np.testing.assert_allclose(np.array(got_i), want.imag, atol=1e-5)

    def test_twiddle_table_is_rounded_from_float64(self):
        tables = fft_tables(512)
        window, tw = tables.window, tables.twiddle
        assert window.dtype == tw.dtype == np.float32
        assert tw.shape == (257, 2) and tw.flags.c_contiguous
        k = np.arange(257)
        np.testing.assert_array_equal(
            tw[:, 0], np.cos(-2 * np.pi * k / 512).astype(np.float32))
        assert tw[0, 1] == 0.0 and tw[256, 0] == -1.0
        assert tables.split is tw and tables.chirp.shape == (0, 2)

    @pytest.mark.parametrize("n_fft", [402, 4093, 4098])
    def test_bluestein_tables_are_rounded_from_float64(self, n_fft):
        # The chirp from the integer phase n^2 mod 2L; the chirp's
        # transform, divided by P, such that the convolution it makes is
        # the DFT: chirp-z of a unit impulse at n gives exp(-2 pi i n k/L).
        tables = fft_tables(n_fft)
        plan = fft_plan(n_fft)
        length, pad = plan.length, plan.pad
        assert tables.chirp.shape == (length, 2)
        assert tables.chirp_fft.shape == (pad, 2)
        assert tables.twiddle.shape == (twiddle_half(plan) + 1, 2)
        n = np.arange(length)
        want = np.exp(-1j * np.pi * (n.astype(np.float64) ** 2) / length)
        got = tables.chirp[:, 0] + 1j * tables.chirp[:, 1].astype(np.float64)
        np.testing.assert_allclose(got, want, atol=1e-7)
        z = np.zeros(length)
        z[5] = 1.0
        a = np.zeros(pad, complex)
        a[:length] = z * want
        spec = tables.chirp_fft[:, 0] + 1j * tables.chirp_fft[:, 1].astype(
            np.float64)
        y = np.fft.ifft(np.fft.fft(a) * spec) * pad
        np.testing.assert_allclose(want * y[:length],
                                   np.exp(-2j * np.pi * 5 * n / length),
                                   atol=1e-5)


    # Rader: L 401 (odd n_fft; 400 = 2^4 5^2), 257 (2^8), 577 (2^6 3^2).
    @pytest.mark.parametrize("n_fft", [401, 514, 1154])
    def test_rader_tables(self, n_fft):
        # The gather g^q and the bins' p(k) are permutations and inverse to
        # each other through g^-p = k; the transform of b[m] = W_L^(g^-m)
        # over L - 1 points is float64 rounded to float32; the split table
        # is the split step's; the twiddles are of order L - 1.
        plan, tables = fft_plan(n_fft), fft_tables(n_fft)
        length, m = plan.length, plan.size
        assert plan.kind == "rader" and m == length - 1
        g = primitive_root(length)
        assert sorted(pow(g, q, length) for q in range(m)) \
            == list(range(1, length))
        gather, bins = tables.perm[:m], tables.perm[m:]
        assert tables.perm.dtype == np.int32 and len(bins) == length
        np.testing.assert_array_equal(
            gather, [pow(g, q, length) for q in range(m)])
        assert sorted(bins[1:]) == list(range(m)) and bins[0] == 0
        for k in range(1, length):
            assert pow(g, (-int(bins[k])) % m, length) == k
        ginv = pow(g, length - 2, length)
        b = np.exp(-2j * np.pi * np.array(
            [pow(ginv, q, length) for q in range(m)], np.float64) / length)
        spec = np.fft.fft(b) / m
        np.testing.assert_array_equal(tables.chirp_fft[:, 0],
                                      spec.real.astype(np.float32))
        np.testing.assert_array_equal(tables.chirp_fft[:, 1],
                                      spec.imag.astype(np.float32))
        assert tables.twiddle.shape == (m // 2 + 1, 2)
        np.testing.assert_array_equal(
            tables.twiddle[:, 0],
            np.cos(-2 * np.pi * np.arange(m // 2 + 1) / m)
            .astype(np.float32))
        assert tables.chirp.shape == (0, 2)
        if n_fft % 2 == 0:
            assert tables.split.shape == (n_fft // 2 + 1, 2)
        # The convolution the tables make is the DFT, in float64.
        z = rand((2, length), 81 + n_fft).astype(np.float64)
        z = z[0] + 1j * z[1]
        a = np.fft.fft(z[gather])
        t = tables.chirp_fft.astype(np.float64)
        v = np.fft.fft(np.conj(a * (t[:, 0] + 1j * t[:, 1])))
        x = z[0] + np.conj(v[bins])
        x[0] = z[0] + a[0]
        np.testing.assert_allclose(x, np.fft.fft(z), atol=1e-4)


class TestStftRoute:
    # One block a frame: every n_fft in [2, 4096], whatever its factors
    # (448: L 224 = 2^5 7; 402: L 201 = 3 67), and above wherever that
    # block fits (8192); the four-step FFT beyond (8194: P 16384).
    @pytest.mark.parametrize("n_fft,want", [
        (8, "fft"), (128, "fft"), (512, "fft"), (4096, "fft"), (4, "fft"),
        (400, "fft"), (12, "fft"), (8192, "fft"), (480, "fft"),
        (448, "fft"), (402, "fft"), (8194, "four_step")])
    def test_route_by_n_fft(self, n_fft, want):
        assert route(n_fft) == want

    # A power of two in radix 8 after one 2 or 4; other lengths in 2, 4,
    # 3, 5, 7.
    @pytest.mark.parametrize("n_fft,plan", [
        (8, (4,)), (16, (8,)), (512, (4, 8, 8)),
        (4096, (4, 8, 8, 8)), (400, (2, 4, 5, 5)),
        (480, (4, 4, 3, 5)), (12, (2, 3)), (448, (2, 4, 4, 7)),
        (882, (3, 3, 7, 7)), (2, ())])
    def test_plan_by_n_fft(self, n_fft, plan):
        got = fft_plan(n_fft)
        assert got.radices == plan and got.pad == 0
        assert np.prod(plan) == got.length

    # Bluestein over the smallest 7-smooth P >= 2L - 1: L 201 = 3 67 (P 405
    # = 3^4 5), 503 (1008), odd 4093 (8192), 2047 = 23 89 (4096), 2049 =
    # 3 683 (4116, above 4096), 67 (135).
    @pytest.mark.parametrize("n_fft,length,pad", [
        (402, 201, 405), (1006, 503, 1008), (134, 67, 135), (4098, 2049, 4116),
        (4093, 4093, 8192), (4094, 2047, 4096)])
    def test_bluestein_by_n_fft(self, n_fft, length, pad):
        plan = fft_plan(n_fft)
        assert (plan.length, plan.pad, plan.kind) == (length, pad, "bluestein")
        assert np.prod(plan.radices) == pad == plan.size >= 2 * length - 1
        assert radices(length) is None
        assert all(radices(p) is None for p in range(2 * length - 1, pad))

    # Rader (a prime L whose L - 1 is 7-smooth, the primes 11 to 31 among
    # them) and the direct prime radices (L's factors at most 31), up to
    # n_fft 4096.
    @pytest.mark.parametrize("n_fft,kind,plan", [
        (22, "rader", (2, 5)), (26, "rader", (4, 3)), (62, "rader", (2, 3, 5)),
        (46, "prime", (23,)), (286, "prime", (11, 13)),
        (1102, "prime", (19, 29)), (176, "prime", (8, 11)),
        (1922, "prime", (31, 31)), (514, "rader", (4, 8, 8)),
        (401, "rader", (4, 4, 5, 5)), (1154, "rader", (4, 4, 4, 3, 3)),
        (74, "rader", (4, 3, 3))])
    def test_prime_and_rader_by_n_fft(self, n_fft, kind, plan):
        got = fft_plan(n_fft)
        assert (got.kind, got.radices, got.pad) == (kind, plan, 0)
        want = got.length - 1 if kind == "rader" else got.length
        assert np.prod(plan) == got.size == want

    # Every n_fft in [2, 4096] in one of the four routes: 247 7-smooth L,
    # 793 prime radices, 137 Rader, 2,918 Bluestein.  Rader first would
    # give 805 and 125: the 12 n_fft whose L is a prime from 11 to 31 with
    # a 7-smooth L - 1 (all but 23) take Rader.  Above 4096 no prime or
    # Rader plan.
    def test_route_counts(self):
        counts = {}
        for n_fft in range(2, 4097):
            kind = fft_plan(n_fft).kind
            counts[kind] = counts.get(kind, 0) + 1
        assert counts["pow2"] + counts["mixed"] == 247
        assert (counts["prime"], counts["rader"], counts["bluestein"]) == \
            (793, 137, 2918)
        moved = [n for n in range(2, 4097) if fft_plan(n).kind == "rader"
                 and fft_plan(n).length <= 31]
        assert moved == [11, 13, 17, 19, 22, 26, 29, 31, 34, 38, 58, 62]
        assert STAGED_MAX == 4096

    # Above 4096: one frame a block for 2,150 n_fft (2 powers of two, 158
    # 7-smooth L, 1,990 Bluestein at a 7-smooth P up to 8192), the
    # four-step FFT for the 59,290 others; no prime or Rader plan.
    def test_route_counts_above_4096(self):
        counts = {}
        for n_fft in range(4097, 65537):
            key = (route(n_fft), fft_plan(n_fft).kind)
            counts[key] = counts.get(key, 0) + 1
        assert counts == {("fft", "pow2"): 2, ("fft", "mixed"): 158,
                          ("fft", "bluestein"): 1990,
                          ("four_step", "pow2"): 2,
                          ("four_step", "mixed"): 204,
                          ("four_step", "bluestein"): 59084}

    def test_plans_fit_the_kernel(self):
        plans = [fft_plan(n) for n in range(2, 4097) if route(n) == "fft"]
        assert max(len(p.radices) for p in plans) <= MAX_STAGES
        assert len(plans) == 4095

    # Every n_fft in [2, 4096]: the FFT route; a plan that multiplies out
    # to the transform length (L - 1 under Rader, Bluestein's 7-smooth
    # P >= 2L - 1, at most the power of two the chirp-z transform would take
    # otherwise); stages within the kernel's cap, prime radices only in
    # prime plans; one frame a block fits shared memory at hop 1, n_fft and
    # 4 n_fft.
    @pytest.mark.parametrize("hop_of", ["1", "n_fft", "4 n_fft"])
    def test_every_length_takes_the_fft(self, hop_of):
        for n_fft in range(2, 4097):
            assert route(n_fft) == "fft", n_fft
            plan = fft_plan(n_fft)
            assert plan.length == (n_fft if n_fft % 2 else n_fft // 2)
            assert len(plan.radices) <= MAX_STAGES
            assert all(r in PRIMES for r in plan.radices if r > 8)
            assert plan.kind == "prime" or max(plan.radices, default=2) <= 8
            if plan.kind == "bluestein":
                assert radices(plan.length) is None
                pow2 = 1 << (2 * plan.length - 2).bit_length()
                assert radices(plan.pad) is not None
                assert np.prod(plan.radices) == plan.pad == plan.size
                assert 2 * plan.length - 1 <= plan.pad <= pow2
            elif plan.kind == "rader":
                assert np.prod(plan.radices) == plan.size == plan.length - 1
            else:
                assert np.prod(plan.radices) == plan.length, n_fft
            hop = {"1": 1, "n_fft": n_fft, "4 n_fft": 4 * n_fft}[hop_of]
            assert fft_smem_bytes(n_fft, hop, 1) <= MAX_SMEM_BYTES, n_fft
            assert fft_tile_frames(n_fft, hop, 1, 1, 132) in FFT_TILES
            assert fft_tile_frames(n_fft, hop, 24, 5000, 132) in (
                TINY_TILES if n_fft <= TINY_N_FFT else FFT_TILES)

    @pytest.mark.parametrize("signals,frames,tile", [
        (24, 501, 8),    # scaled device batch: 1,512 blocks
        (24, 63, 4),     # demo device batch: 384 blocks
        (3, 32, 1),      # odd shape: at most 96 blocks, the smallest tile
        (1, 10, 1)])
    def test_tile_fills_the_sms(self, signals, frames, tile):
        assert fft_tile_frames(512, 128, signals, frames, 132) == tile

    # Mixed radix at the scaled device batch: n_fft 400 and 480 fit 8
    # frames a block, as 512 does.
    @pytest.mark.parametrize("n_fft,hop", [(400, 160), (480, 120)])
    def test_tile_for_mixed_radix(self, n_fft, hop):
        tile = fft_tile_frames(n_fft, hop, 24, 1 + 64000 // hop, 132)
        assert tile == 8
        f = n_fft // 2 + 1
        assert fft_smem_bytes(n_fft, hop, tile) == 4 * (
            2 * max(n_fft * 8, 7 * hop + n_fft, f * 9) + 2 * f + n_fft) \
            + 20 * MAX_STAGES

    # Odd n_fft: a sequence holds two frames, so one frame a block is
    # never chosen where two fit.  Tiles whose blocks let four share an SM
    # come first (882: 8 frames take 62 KB; 1102 on radices 19, 29: 4
    # frames 44 KB; 514 under Rader over 256: 8 frames 38 KB).
    @pytest.mark.parametrize("n_fft,hop,signals,frames,tile", [
        (401, 160, 3, 32, 2), (4093, 1000, 1, 4, 2), (4093, 4093, 1, 4, 2),
        (882, 441, 24, 401, 4), (514, 128, 24, 501, 8),
        (1102, 441, 24, 401, 4), (401, 160, 24, 401, 8)])
    def test_tile_for_odd_and_bluestein(self, n_fft, hop, signals, frames,
                                        tile):
        assert fft_tile_frames(n_fft, hop, signals, frames, 132) == tile
        assert fft_smem_bytes(n_fft, hop, tile) <= MAX_SMEM_BYTES

    # Up to n_fft 64 a block takes up to 32 frames (a block of 8 is mostly
    # fixed cost); from 66 on at most 8, as before.
    @pytest.mark.parametrize("n_fft,hop,frames,tile", [
        (22, 11, 5819, 32), (62, 30, 267, 16), (16, 4, 16001, 32),
        (13, 6, 10667, 32), (64, 16, 4001, 32), (66, 33, 1940, 8),
        (128, 64, 1001, 8)])
    def test_tiny_n_fft_take_larger_tiles(self, n_fft, hop, frames, tile):
        assert fft_tile_frames(n_fft, hop, 24, frames, 132) == tile
        assert tile <= 32 and fft_smem_bytes(n_fft, hop, tile) <= \
            SMEM_SHARES[0]

    # No tile beyond the power of two that holds the frames (a pair for an
    # odd n_fft): 66,000 one-frame signals at 4098 take one frame a block,
    # though two fit shared memory at P 4116.
    @pytest.mark.parametrize("n_fft,hop,signals,frames,tile", [
        (4098, 4098, 66000, 1, 1), (4098, 4098, 6600, 2, 2),
        (512, 128, 70000, 1, 1), (512, 128, 70000, 3, 4),
        (401, 160, 70000, 1, 2), (8192, 1024, 5000, 1, 1)])
    def test_tile_holds_no_more_than_the_frames(self, n_fft, hop, signals,
                                                frames, tile):
        assert fft_tile_frames(n_fft, hop, signals, frames, 132) == tile
        assert fft_smem_bytes(n_fft, hop, 2) <= MAX_SMEM_BYTES

    def test_tile_fits_shared_memory_at_4096(self):
        # No tile lets four blocks share an SM; 2 frames let two (96 KB);
        # 4 frames fit (160 KB) alone; 8 do not fit.
        four, two, one = SMEM_SHARES
        tile = fft_tile_frames(4096, 1024, 4096, 501, 132)
        assert tile == 2
        assert four < fft_smem_bytes(4096, 1024, 1)
        assert fft_smem_bytes(4096, 1024, tile) <= two
        assert two < fft_smem_bytes(4096, 1024, 4) <= one == MAX_SMEM_BYTES \
            < fft_smem_bytes(4096, 1024, 8)

    @pytest.mark.parametrize("audio,n_fft,hop,match", [
        (torch.zeros(2, 0), 512, 32, "audio must be"),
        (torch.zeros(2, 300, dtype=torch.float64), 512, 128, "float32"),
        (torch.zeros(2, 300), 1, 1, "n_fft 1"),
        (torch.zeros(2, 300), 64, 0, "hop 0")])
    def test_fft_route_inputs_are_checked(self, audio, n_fft, hop, match):
        with pytest.raises(ValueError, match=match):
            _check(audio, n_fft, hop, 1 + audio.shape[-1] // max(hop, 1))

    def test_fft_route_takes_any_hop_and_signal_count(self):
        # Odd hops and n_fft, hops that are no multiple of 4, and more
        # than 65,535 signals (more than a grid's y dimension holds).
        for n_fft, hop in ((882, 441), (401, 160), (64, 30), (2, 1)):
            _check(torch.zeros(2, 900), n_fft, hop, 1 + 900 // hop)
        _check(torch.zeros(70000, 8), 8, 4, 3)


def unit_root(m, p):
    """stft_fft.cu's `unit_root`: W_P^m from sincospif(2m / P), the
    argument the float32 quotient 2m / P; float64 cos and sin of pi times
    it, rounded to float32, stand for sincospif (within an ulp of it)."""
    x = (np.float32(2) * np.asarray(m, np.float32)) / np.float32(p)
    ang = np.pi * x.astype(np.float64)
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def four_step_passes(n_fft: int) -> tuple:
    """A model of the plan `avsep_stft_4step_fwd` (stft_fft.cu) derives
    for each pass of the four-step regime from `four_step_plan`: its name,
    FFT length, sequences a block, blocks a sequence, work region (complex
    values) and shared memory (two regions, the FFT's table of len + 1
    values, the static stage table)."""
    p = four_step_plan(n_fft)
    size = p.pad or p.length
    out = [dict(name="columns", len=p.n1, seq=p.cols,
                groups=-(-p.n2 // p.cols), region=p.n1 * p.cols)]
    if p.pad:
        out.append(dict(name="rows_middle", len=p.n2, seq=p.rows,
                        groups=-(-p.n1 // p.rows), region=p.rows * p.n2))
    axis = p.n2 if p.pad else p.n1
    a = p.length % axis
    reps = a // 2 + 1 + (axis - a) // 2
    last = dict(name="columns_last" if p.pad else "rows_last",
                len=p.n1 if p.pad else p.n2, seq=2 * p.pairs,
                groups=-(-reps // p.pairs), reps=reps, a=a,
                q=p.length // axis, axis=axis)
    last["region"] = 2 * p.pairs * (p.n1 if p.pad else p.n2)
    out.append(last)
    for d in out:
        d["smem"] = 8 * (2 * d["region"] + d["len"] + 1) + STAGE_TABLE_BYTES
        d["size"] = size
    return tuple(out)


def four_step_emulated(audio: np.ndarray, n_fft: int, hop: int,
                       num_frames: int) -> np.ndarray:
    """(B, N) float32 -> (B, F, T) float32 by the four-step passes of
    stft_fft.cu, in float32: pack (under Bluestein times the chirp, zero
    to P) into the [a][c] matrix of n = n2 a + c; the columns' n1-point
    Stockham FFTs, times W_P^(c k1), as [k1][c]; then the rows' n2-point
    FFTs (no Bluestein), or under Bluestein the rows' FFTs, times the
    chirp's transform in the [k1][k2] layout, conjugated, the rows' FFTs,
    times W_P^(k1 m2) and the columns' FFTs; last, block by block over the
    representatives of the pairs (x, (a - x) mod A), the split (or the
    separation of two frames) from Z[j] and its partner at
    (q - p - [x > a]) in the pair's other sequence.  Every bin of every
    frame must be written exactly once."""
    f32 = np.float32
    plan, tables = four_step_plan(n_fft), four_step_tables(n_fft)
    last = four_step_passes(n_fft)[-1]
    length, n1, n2 = plan.length, plan.n1, plan.n2
    size = plan.pad or length
    odd = n_fft % 2 == 1
    b, n = audio.shape
    seqs = four_step_sequences(n_fft, num_frames)
    frames = 2 * seqs if odd else seqs
    extra = max(0, (frames - 1) * hop + n_fft - n)
    padded = np.pad(audio, ((0, 0), (0, extra)))
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    x = padded[:, idx] * tables.window               # (B, frames, n_fft)
    if odd:
        x[:, num_frames:] = 0.0                      # the pair's second
        zr, zi = x[:, 0::2], x[:, 1::2]
    else:
        zr, zi = x[..., 0::2], x[..., 1::2]
    if plan.pad:
        zr, zi = _cmul(zr, zi, tables.chirp[:, 0], tables.chirp[:, 1])
        pad = ((0, 0), (0, 0), (0, size - length))
        zr, zi = np.pad(zr, pad), np.pad(zi, pad)

    def cols_fft(ar, ai):    # (.., n1, n2) [a][c] -> [c][k1]
        return stockham(np.swapaxes(ar, -1, -2).copy(),
                        np.swapaxes(ai, -1, -2).copy(), plan.radices1,
                        tables.twiddle1, n1)

    def rows_fft(ar, ai):    # (.., n1, n2), over the rows
        return stockham(ar, ai, plan.radices2, tables.twiddle2, n2)

    ar, ai = cols_fft(zr.reshape(b, seqs, n1, n2), zi.reshape(b, seqs, n1, n2))
    c, k1 = np.meshgrid(np.arange(n2), np.arange(n1), indexing="ij")
    ar, ai = _cmul(ar, ai, *unit_root(c * k1, size))
    ar, ai = np.swapaxes(ar, -1, -2), np.swapaxes(ai, -1, -2)  # [k1][c]
    ar, ai = rows_fft(ar, ai)
    if plan.pad:
        cf = tables.chirp_fft.reshape(n1, n2, 2)
        ar, ai = _cmul(ar, ai, cf[..., 0], cf[..., 1])
        ar, ai = rows_fft(ar, -ai)
        k1, m2 = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
        ar, ai = _cmul(ar, ai, *unit_root(k1 * m2, size))
        ar, ai = cols_fft(ar, ai)                    # [m2][m1]
    # The last pass: the sequences along its axis x, positions p.
    big, q_len = last["axis"], last["len"]
    a, q, reps = last["a"], last["q"], last["reps"]
    f = n_fft // 2 + 1
    jmax = f if odd else length
    out = np.full((b, f, num_frames), np.nan, f32)

    def put(k, t, value):
        assert np.isnan(out[:, k, t]).all(), "a bin written twice"
        out[:, k, t] = value

    def z_at(x, p, j):
        zr_, zi_ = ar[:, :, x, p], ai[:, :, x, p]
        if plan.pad:  # c*[j] conj(v)
            return _cmul(tables.chirp[j, 0], tables.chirp[j, 1], zr_, -zi_)
        return zr_, zi_

    h0 = a // 2 + 1
    for u0 in range(0, reps, plan.pairs):
        for u in range(u0, min(u0 + plan.pairs, reps)):
            x0 = u if u < h0 else a + 1 + (u - h0)
            pair = (x0, (a - x0) % big)
            for slot, x in enumerate(pair):
                if slot and x == pair[0]:
                    continue
                p = np.arange(q_len)
                j = x + big * p
                keep = j < jmax
                p, j = p[keep], j[keep]
                pm = np.where(j > 0, q - p - (x > a), p)
                jm = np.where(j > 0, length - j, 0)
                zkr, zki = z_at(x, p, j)
                zmr, zmi = z_at(pair[1 - slot], pm, jm)
                zmr = np.where(j > 0, zmr, zkr)
                zmi = np.where(j > 0, zmi, zki)
                if not odd:
                    def split_mag(wr, wi, zmr, zmi):
                        ar_, ai_ = zkr + zmr, zki - zmi
                        br, bi = zkr - zmr, zki + zmi
                        wbr, wbi = wr * br - wi * bi, wr * bi + wi * br
                        xr, xi = f32(0.5) * (ar_ + wbi), f32(0.5) * (ai_ - wbr)
                        return np.sqrt(xr * xr + xi * xi)
                    mag = split_mag(tables.split[j, 0], tables.split[j, 1],
                                    zmr, zmi)
                    put(j, slice(None), np.moveaxis(mag, 1, 2)
                        .reshape(b, len(j), seqs)[:, :, :num_frames])
                    if j.size and j[0] == 0:
                        top = split_mag(tables.split[length, 0],
                                        tables.split[length, 1], zkr, zki)
                        put(length, slice(None), top[..., 0])
                else:
                    pr, pi = zkr + zmr, zki - zmi
                    qr, qi = zkr - zmr, zki + zmi
                    first = f32(0.5) * np.sqrt(pr * pr + pi * pi)
                    second = f32(0.5) * np.sqrt(qr * qr + qi * qi)
                    both = np.stack([first, second], axis=2)  # (B, S, 2, J)
                    both = np.moveaxis(both.reshape(b, 2 * seqs, len(j)), 1,
                                       2)[:, :, :num_frames]
                    put(j, slice(None), both)
    assert not np.isnan(out).any(), "a bin never written"
    return out


def float64_tol(want):
    """tests/test_kernels.py's tolerance for the Pallas kernel against
    float64 numpy: 5e-4 + 1e-4 relative (as an absolute bound)."""
    return 5e-4 + 1e-4 * np.abs(want)


@pytest.fixture
def drop_plain_bases():
    """The plain bases of a large n_fft (up to 1 GB at 16384) are cached
    by the port's and the JAX package's `dft_basis`; let them go after
    the test."""
    yield
    from av_separation_torch.ops.stft import dft_basis
    from av_separation_tpu.ops.stft import dft_basis as jax_dft_basis
    dft_basis.cache_clear()
    jax_dft_basis.cache_clear()


@pytest.mark.usefixtures("drop_plain_bases")
class TestLargeNfft:
    # Every n_fft in (4096, 65536], in eight runs: its regime ('fft' where
    # one frame's block fits 227 KB, else 'four_step'), a shared memory
    # that fits, stages within the kernel's cap, every FastDiv exact over
    # its range, a grid within its cap at 70,000 signals of one frame.
    @pytest.mark.parametrize("lo", range(4097, 65537, 7680))
    def test_every_n_fft_has_a_plan_that_fits(self, lo):
        counts = {"fft": 0, "four_step": 0}
        for n_fft in range(lo, min(lo + 7680, 65537)):
            kind = route(n_fft)
            counts[kind] += 1
            plan = fft_plan(n_fft)
            if kind == "fft":
                assert plan.pad <= MAX_PAD and len(plan.radices) <= MAX_STAGES
                assert fft_smem_bytes(n_fft, 1, 1) <= MAX_SMEM_BYTES, n_fft
                tile = fft_tile_frames(n_fft, 441, 70000, 3, 132)
                assert tile in (1, 2)
                assert fft_smem_bytes(n_fft, 441, tile) <= MAX_SMEM_BYTES
                assert 70000 * -(-3 // tile) <= 2 ** 31 - 1
                for d, top in kernel_divisions(n_fft, tile):
                    m = ((1 << 31) + d - 1) // d
                    assert top * (m * d - (1 << 31)) < 1 << 31, (n_fft, d)
                continue
            fs = four_step_plan(n_fft)
            size = fs.pad or fs.length
            assert fs.n1 * fs.n2 == size < 1 << 24
            assert fs.n2 <= 2048 and fs.n1 <= 8192
            assert np.prod(fs.radices1) == fs.n1
            assert np.prod(fs.radices2) == fs.n2
            assert max(len(fs.radices1), len(fs.radices2)) <= MAX_STAGES
            assert fs.cols & (fs.cols - 1) == 0
            assert fs.pairs & (fs.pairs - 1) == 0
            assert fs.sequences * 8 * size <= max(32 << 20, 8 * size)
            for p in four_step_passes(n_fft):
                assert p["smem"] <= MAX_SMEM_BYTES, (n_fft, p)
                assert p["groups"] * fs.sequences <= 2 ** 31 - 1
                seq, ln = p["seq"], p["len"]
                if ln & (ln - 1):   # mixed radix: FastDiv by len / r, ns
                    ns = 1
                    for r in (fs.radices1 if ln == fs.n1 else fs.radices2):
                        for d, top in ((ln // r, seq * ln // r),
                                       (ns, ln // r)):
                            m = ((1 << 31) + d - 1) // d
                            assert top * (m * d - (1 << 31)) < 1 << 31
                        ns *= r
        hi = min(lo + 7680, 65537)
        assert counts["fft"] + counts["four_step"] == hi - lo
        if lo == 4097:   # 4097 itself: L 4097 needs P 16384
            assert counts["fft"] > 0 and route(4097) == "four_step"

    # One frame a block (the 'fft' regime above 4096: nothing staged, the
    # same arithmetic): a power of two (8192, 16384), the mixed radix (4410:
    # L 2205 = 3^2 5 7^2) and Bluestein at P 4116 (4098: L 2049), against
    # the plain version at 2e-4 x max(1, peak / 100).
    @pytest.mark.parametrize("n_fft,hop,n", [(8192, 1024, 12000),
                                             (16384, 4096, 20000),
                                             (4410, 441, 6000),
                                             (4098, 4098, 8196)])
    def test_one_frame_a_block_matches_plain(self, n_fft, hop, n):
        assert route(n_fft) == "fft"
        audio = rand((2, n), 70 + n_fft)
        frames = 1 + n // hop
        ours = fft_stft_emulated(audio, n_fft, hop, frames, tile=1)
        plain = stft_magnitude_fwd_torch(torch.from_numpy(audio), n_fft,
                                         hop).numpy()
        assert ours.shape == plain.shape == (2, n_fft // 2 + 1, frames)
        np.testing.assert_allclose(ours, plain, atol=plain_tol(plain.max()),
                                   rtol=0)

    def test_four_step_matches_plain_under_bluestein(self):
        # n_fft 8194: L 4097 = 17 241, P 16384 = 8 x 2048, three passes.
        audio = rand((2, 12000), 80)
        frames = 1 + 12000 // 2048
        ours = four_step_emulated(audio, 8194, 2048, frames)
        plain = stft_magnitude_fwd_torch(torch.from_numpy(audio), 8194,
                                         2048).numpy()
        assert ours.shape == plain.shape == (2, 4098, frames)
        np.testing.assert_allclose(ours, plain, atol=plain_tol(plain.max()),
                                   rtol=0)

    # Against float64 numpy where the plain bases (2 n_fft F floats) are
    # too large to build here: a power of two (32768: 8 x 2048; 65536: 16 x
    # 2048), 7-smooth lengths (19600: L 9800 = 5 x 1960; odd 10125 = 5 x
    # 2025, two frames a sequence, an odd frame count) and odd Bluestein
    # (8193, P 32768 = 16 x 2048).
    @pytest.mark.parametrize("n_fft,hop,n", [(32768, 8192, 50000),
                                             (65536, 16384, 70000),
                                             (19600, 4900, 30000),
                                             (10125, 2205, 14000),
                                             (8193, 2048, 13000)])
    def test_four_step_matches_float64(self, n_fft, hop, n):
        from av_separation_torch.data.synthetic import stft_magnitude_np
        assert route(n_fft) == "four_step"
        audio = rand((2, n), 90 + n_fft % 97)
        frames = 1 + n // hop
        ours = four_step_emulated(audio, n_fft, hop, frames)
        want = np.stack([stft_magnitude_np(a, n_fft, hop, frames)
                         for a in audio])
        assert ours.shape == want.shape == (2, n_fft // 2 + 1, frames)
        assert np.all(np.abs(ours - want) <= float64_tol(want))
        assert np.abs(ours - want).max() <= plain_tol(want.max())

    # The last pass's pairs: the orbits of x -> (a - x) mod A cover the
    # axis once, each sequence's partner holds Z[L - j].
    @pytest.mark.parametrize("n_fft", [8194, 32768, 10125, 8193])
    def test_last_pass_pairs_cover_the_axis(self, n_fft):
        last = four_step_passes(n_fft)[-1]
        a, big, reps = last["a"], last["axis"], last["reps"]
        h0 = a // 2 + 1
        seen = []
        for u in range(reps):
            x = u if u < h0 else a + 1 + (u - h0)
            y = (a - x) % big
            seen += [x] if x == y else [x, y]
        assert sorted(seen) == list(range(big))
        length = four_step_plan(n_fft).length
        assert last["q"] * big + a == length

    def test_pass_model_follows_the_c_entry(self):
        # `four_step_passes` copies the arithmetic of the C entry point's
        # plan: each line it copies must still be there, word for word.
        src = (CSRC / "stft_fft.cu").read_text()
        body = " ".join(src[src.index('"C" int avsep_stft_4step_fwd'):]
                        .split())
        for line in ("f.groups = (n2 + cols - 1) / cols;",
                     "f.region = n1 * cols;",
                     "f.groups = (n1 + rows - 1) / rows;",
                     "f.region = rows * n2;",
                     "const int A = pass == kRowsLast ? n1 : n2;",
                     "f.a = L % A;", "f.q = L / A;",
                     "f.reps = f.a / 2 + 1 + (A - f.a) / 2;",
                     "f.groups = (f.reps + pairs - 1) / pairs;",
                     "seq = 2 * pairs;",
                     "f.region = seq * (pass == kRowsLast ? n2 : n1);",
                     "f.len = on_columns ? n1 : n2;",
                     "(2 * (size_t)f.region + f.len + 1) * sizeof(float2) "
                     "+ sizeof(Stage) * kMaxStages > kMaxSmem"):
            assert line in body, line
        assert STAGE_TABLE_BYTES == 20 * MAX_STAGES
        assert "static_assert(sizeof(Stage) == 20," in src
        assert f"constexpr int kMaxStages = {MAX_STAGES};" in src

    def test_four_step_tables(self):
        # The chirp's transform in the [k1][k2] layout; the stages' tables
        # of order 2 n1 and 2 n2; the split table of order n_fft.
        plan, tables = four_step_plan(8194), four_step_tables(8194)
        spec = _chirp_tables(4097, 16384)[1]   # the one-block formula
        assert spec.shape == (16384, 2) and plan.pad == 16384
        cf = tables.chirp_fft.reshape(plan.n1, plan.n2, 2)
        np.testing.assert_array_equal(
            cf, spec.reshape(plan.n2, plan.n1, 2).transpose(1, 0, 2))
        k1, k2 = 3, 100
        ref = np.fft.fft(np.r_[
            np.exp(1j * np.pi * (np.arange(4097) ** 2 % 8194) / 4097),
            np.zeros(16384 - 2 * 4097 + 1),
            np.exp(1j * np.pi * (np.arange(4096, 0, -1) ** 2 % 8194)
                   / 4097)]) / 16384
        np.testing.assert_allclose(cf[k1, k2, 0] + 1j * cf[k1, k2, 1],
                                   ref[k1 + plan.n1 * k2], atol=1e-7)
        assert tables.twiddle1.shape == (plan.n1 + 1, 2)
        assert tables.twiddle2.shape == (plan.n2 + 1, 2)
        assert tables.split.shape == (4098, 2)
        np.testing.assert_array_equal(
            tables.split[:, 0],
            np.cos(-2 * np.pi * np.arange(4098) / 8194).astype(np.float32))

    @pytest.mark.parametrize("audio,n_fft,hop,match", [
        (torch.zeros(2, 9000, dtype=torch.float64), 8192, 1024, "float32"),
        (torch.zeros(9000, 2).t(), 32768, 8192, "contiguous"),
        # 2^31 signals of 41 frames: one frame a block exceeds grid x (a
        # meta tensor: no memory).
        (torch.empty(2 ** 31, 40, device="meta"), 8192, 1, "grid")])
    def test_large_n_fft_inputs_are_checked(self, audio, n_fft, hop, match):
        with pytest.raises(ValueError, match=match):
            _check(audio, n_fft, hop, 1 + audio.shape[-1] // hop)

    def test_four_step_takes_any_signal_count(self):
        # No grid cap: a chunk of sequences a launch.
        _check(torch.empty(2 ** 31, 40, device="meta"), 32768, 1, 41)
        plan = four_step_plan(32768)
        assert plan.sequences == (32 << 20) // (8 * 16384)


@pytest.mark.usefixtures("drop_plain_bases")
class TestDftRoute:
    # The plain version (a matrix DFT against float64-built bases) at the
    # n_fft above 4096, against the Pallas kernel in interpret mode.
    def test_plain_matches_pallas_at_4410_441(self):
        # The 44.1 kHz 100 ms window (n_fft 4410, hop 441): the plain
        # version against the Pallas kernel in interpret mode (float32
        # sums of 4410 windowed samples in another order: 2e-4 x the peak
        # over 100, as the card's rows).
        import jax.numpy as jnp

        from av_separation_tpu.ops.pallas.stft import stft_magnitude_pallas
        audio = rand((2, 17640), 96)
        want = stft_magnitude_fwd_torch(torch.from_numpy(audio), 4410,
                                        441).numpy()
        with pltpu.force_tpu_interpret_mode():
            got = np.asarray(stft_magnitude_pallas(jnp.asarray(audio), 4410,
                                                   441))
        assert got.shape == want.shape == (2, 2206, 41)
        np.testing.assert_allclose(got, want,
                                   atol=2e-4 * max(1.0, want.max() / 100))

    def test_plain_matches_pallas_at_8192(self):
        # n_fft 8192, two frames (hop 1024): the plain version and the
        # one-frame-a-block emulation against the Pallas kernel.
        import jax.numpy as jnp

        from av_separation_tpu.ops.pallas.stft import stft_magnitude_pallas
        audio = rand((1, 9216), 97)
        want = stft_magnitude_fwd_torch(torch.from_numpy(audio), 8192,
                                        1024, 2).numpy()
        ours = fft_stft_emulated(audio, 8192, 1024, 2, tile=1)
        with pltpu.force_tpu_interpret_mode():
            got = np.asarray(stft_magnitude_pallas(jnp.asarray(audio), 8192,
                                                   1024, 2))
        assert got.shape == want.shape == (1, 4097, 2)
        tol = 2e-4 * max(1.0, want.max() / 100)
        np.testing.assert_allclose(got, want, atol=tol)
        np.testing.assert_allclose(ours, got, atol=tol)


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
    # Also at dh 64, the reference's default model (d 256, 4 heads).
    @pytest.mark.parametrize("dh", [128, 64])
    @pytest.mark.parametrize("kind", ["mask", "rna"])
    @pytest.mark.parametrize("rate", [0.0, 0.1])
    def test_3xtf32_holds_float32_tolerance_and_1xtf32_does_not(self, rate,
                                                                kind, dh):
        t = 501
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


# ---------------------------------------------------------------------------
# 3xTF32 products in the flash backward's tiles.
# ---------------------------------------------------------------------------

def flash_bwd_tiles_emulated(q, k, v, o, do, lse, rate, seed, passes,
                             block=64, tile=16):
    """(Tq, dh), (Tk, dh) for one head -> (dq, dk, dv) as the kernels of
    flash_attn_bwd.cu compute them: delta = rowsum(dO * O); the dK/dV
    kernel over blocks of 64 keys walks 16-query tiles (S^T = K Q^T,
    dP^T = V dO^T, then dV += Pd^T dO and dK += dS^T Q); the dQ kernel over
    blocks of 64 rows walks 16-key tiles (S = Q K^T, dP = dO V^T, then
    dQ += dS K).  Every product in 3xTF32 (passes 3) or 1xTF32 (passes 1);
    each tile's sum added to float32 accumulators; no atomics.  (Head dim
    256 runs on the pair kernels: tests/test_torch_pair_design.py.)"""
    f32 = np.float32
    tq, dh = q.shape
    tk = k.shape[0]
    scale = f32(1.0 / np.sqrt(dh))
    inv_keep = f32(1.0) / f32(1.0 - rate)
    keep = keep_mask(seed, 1, 1, tq, tk, rate).numpy()[0, 0] if rate \
        else np.ones((tq, tk), bool)
    delta = (do * o).sum(axis=1, dtype=f32)
    dk = np.zeros_like(k)
    dv = np.zeros_like(v)
    for k0 in range(0, tk, block):
        kb, vb = k[k0:k0 + block], v[k0:k0 + block]
        for q0 in range(0, tq, tile):
            qt, dot = q[q0:q0 + tile], do[q0:q0 + tile]
            st = product(kb, qt.T, passes) * scale
            dpt = product(vb, dot.T, passes)
            p = np.exp(st - lse[None, q0:q0 + tile]).astype(f32)
            kt = keep[q0:q0 + tile, k0:k0 + block].T
            pd = np.where(kt, p * inv_keep, f32(0))
            dpt = np.where(kt, dpt * inv_keep, f32(0))
            ds = p * (dpt - delta[None, q0:q0 + tile]) * scale
            dv[k0:k0 + block] += product(pd, dot, passes)
            dk[k0:k0 + block] += product(ds, qt, passes)
    dq = np.zeros_like(q)
    for q0 in range(0, tq, block):
        qb, dob = q[q0:q0 + block], do[q0:q0 + block]
        for k0 in range(0, tk, tile):
            kt, vt = k[k0:k0 + tile], v[k0:k0 + tile]
            s = product(qb, kt.T, passes) * scale
            dp = product(dob, vt.T, passes)
            p = np.exp(s - lse[q0:q0 + block, None]).astype(f32)
            kp = keep[q0:q0 + block, k0:k0 + tile]
            dp = np.where(kp, dp * inv_keep, f32(0))
            ds = p * (dp - delta[q0:q0 + block, None]) * scale
            dq[q0:q0 + block] += product(ds, kt, passes)
    return dq, dk, dv


def _bwd_case(tq, tk, dh, rate, seeds):
    q, k, v, do = (rand(shape, s) for shape, s in zip(
        ((tq, dh), (tk, dh), (tk, dh), (tq, dh)), seeds))
    t = [torch.from_numpy(x)[None, None] for x in (q, k, v)]
    o, lse = flash_attn_fwd_torch(*t, rate, SEED)
    ref = flash_attn_bwd_torch(*t, o, torch.from_numpy(do)[None, None], lse,
                               rate, SEED)
    o, lse = o[0, 0].numpy(), lse[0, 0].numpy()
    return (q, k, v, o, do, lse), [g[0, 0].numpy() for g in ref]


class TestBackwardThreeTf32:
    # The audio self-attention shape (Tq = Tk = 501, dh 128) with B and H
    # cut to 1, as the card's kernel row holds it: 3xTF32 keeps dQ, dK and
    # dV within the kernel's 2e-5 of the plain float32 version; 1xTF32 does
    # not.  Also at dh 64.
    @pytest.mark.parametrize("dh", [128, 64])
    @pytest.mark.parametrize("rate", [0.0, 0.1])
    def test_3xtf32_holds_float32_tolerance_and_1xtf32_does_not(self, rate,
                                                                dh):
        inputs, ref = _bwd_case(501, 501, dh, rate, (70, 71, 72, 73))
        got = flash_bwd_tiles_emulated(*inputs, rate, SEED, 3)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            assert np.abs(g - r).max() <= 2e-5, name
        got1 = flash_bwd_tiles_emulated(*inputs, rate, SEED, 1)
        assert max(np.abs(g - r).max() for g, r in zip(got1, ref)) > 2e-5

    # A ragged shape (Tq 37, Tk 45: partial tiles and blocks at both
    # edges) against the JAX vjp with the Pallas kernels in interpret mode,
    # at test_torch_kernels.py's backward tolerance.
    @pytest.mark.parametrize("dh", [128, 64])
    @pytest.mark.parametrize("rate", [0.0, 0.3])
    def test_matches_jax_vjp(self, rate, dh):
        import jax
        import jax.numpy as jnp

        from av_separation_tpu.ops.pallas.attention import (
            flash_attention, flash_attention_packed_qkv)
        inputs, _ = _bwd_case(37, 45, dh, rate, (74, 75, 76, 77))
        q, k, v, o, do, lse = inputs
        seed = jnp.asarray([SEED], jnp.int32) if rate > 0 else None
        # The packed (B, T, H*dh) kernel takes dh 128; dh 64 goes through
        # the split (B, H, T, dh) one, as the JAX model routes it.
        if dh % 128:
            fn, lead = (lambda a, b, c: flash_attention(
                a, b, c, dropout_rate=rate, dropout_seed=seed)), (1, 1)
        else:
            fn, lead = (lambda a, b, c: flash_attention_packed_qkv(
                a, b, c, 1, dropout_rate=rate, dropout_seed=seed)), (1,)
        with pltpu.force_tpu_interpret_mode():
            _, vjp = jax.vjp(fn, *(jnp.asarray(x.reshape(lead + x.shape))
                                   for x in (q, k, v)))
            want = vjp(jnp.asarray(do.reshape(lead + do.shape)))
        got = flash_bwd_tiles_emulated(*inputs, rate, SEED, 3)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, np.asarray(w).reshape(g.shape),
                                       atol=5e-5, rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# 3xTF32 products in the mask decoder's and the projection's tiles.
# ---------------------------------------------------------------------------

BN = 128  # the kernels' output columns a block


def tiled_product(a, w_rows, passes, bk=32):
    """a (M, K) times w_rows (N, K)^T as the tiled kernels sum it: k in
    tiles of `bk`, each tile's product added to float32 accumulators."""
    f32 = np.float32
    acc = np.zeros((a.shape[0], w_rows.shape[0]), f32)
    for k0 in range(0, a.shape[1], bk):
        acc = (acc + product(a[:, k0:k0 + bk], w_rows[:, k0:k0 + bk].T,
                             passes)).astype(f32)
    return acc


def erf_gelu(v):
    from scipy.special import erf
    return (0.5 * v * (1.0 + erf(v / np.sqrt(2.0)))).astype(np.float32)


def decoder_tiles_emulated(x, w1, b1, w2, b2, mixed, s, passes, rows=128):
    """(B, T, d) -> (separated, masks) in (B, S, F, T) as mask_decoder.cu
    computes them: over the B*T rows in blocks of `rows` (rows past B*T
    zero) and 128 output columns (weight rows past S*F zero), the first
    GEMM + b1 + erf GELU into the hidden buffer, the second + b2 + sigmoid,
    each block's tile stored column by column along T (row m is frame
    m % T of utterance m // T).  w1 (2d, d) and w2 (S*F, 2d) in the torch
    Linear layout, as the kernel reads them."""
    f32 = np.float32
    b, t, d = x.shape
    f = mixed.shape[1]
    sf = s * f
    m_all = b * t

    def gemm(a, w, bias, act):
        m_pad = -(-m_all // rows) * rows
        n_pad = -(-w.shape[0] // BN) * BN
        ap = np.zeros((m_pad, a.shape[1]), f32)
        ap[:m_all] = a
        wp = np.zeros((n_pad, w.shape[1]), f32)
        wp[:w.shape[0]] = w
        out = np.zeros((m_pad, n_pad), f32)
        for m0 in range(0, m_pad, rows):
            for n0 in range(0, n_pad, BN):
                out[m0:m0 + rows, n0:n0 + BN] = tiled_product(
                    ap[m0:m0 + rows], wp[n0:n0 + BN], passes)
        return act((out[:m_all, :w.shape[0]] + bias).astype(f32))

    hidden = gemm(x.reshape(m_all, d), w1, b1, erf_gelu)
    masks_mo = gemm(hidden, w2, b2,
                    lambda v: (f32(1) / (f32(1) + np.exp(-v))).astype(f32))
    masks = np.zeros(b * sf * t, f32)
    sep = np.zeros(b * sf * t, f32)
    m = np.arange(m_all)[:, None]
    o = np.arange(sf)[None, :]
    bi, tt = m // t, m % t
    idx = (bi * sf + o) * t + tt                 # the staged (S, F, T) store
    masks[idx] = masks_mo
    sep[idx] = masks_mo * mixed[bi, o % f, tt]
    return sep.reshape(b, s, f, t), masks.reshape(b, s, f, t)


def proj_tiles_emulated(x, w1, b1, w2, b2, passes, rows=128):
    """(B, T, F) -> (y, h) as audio_proj.cu computes them at a float32 x,
    in blocks of `rows` frames (the kernel's 128; the emulation of
    test_torch_proj_wgmma_design.py): x, h and the weights each in three
    bf16 parts, the six products that reach 2^-24 summed in float32
    (`passes` 3), or one product of the bf16-rounded values (`passes` 1);
    h is zero outside [0, T) where conv2 reads it."""
    from test_torch_proj_wgmma_design import proj_wgmma_emulated
    return proj_wgmma_emulated(x, w1, b1, w2, b2, one_product=passes == 1,
                               dtype="f32", rows=rows)


def _decoder_case(b, t, d, s, f, seed, mixed_scale=10.0):
    """The card's decoder rows: x ~ N(0, 1), torch Linear initialisation,
    mixed = 10 |N(0, 1)|; weights in the torch layout."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    lim1, lim2 = d ** -0.5, (2 * d) ** -0.5
    x = rng.normal(size=(b, t, d)).astype(f32)
    w1 = rng.uniform(-lim1, lim1, (2 * d, d)).astype(f32)
    b1 = rng.uniform(-lim1, lim1, 2 * d).astype(f32)
    w2 = rng.uniform(-lim2, lim2, (s * f, 2 * d)).astype(f32)
    b2 = rng.uniform(-lim2, lim2, s * f).astype(f32)
    mixed = (np.abs(rng.normal(size=(b, f, t))) * mixed_scale).astype(f32)
    return x, w1, b1, w2, b2, mixed


def _proj_case(b, t, f, d, seed):
    """The card's projection rows: x = |N(0, 1)|, torch Conv1d
    initialisation, in the flax (3, C_in, C_out) layout."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    lim1, lim2 = (3 * f) ** -0.5, (3 * d) ** -0.5
    return (np.abs(rng.normal(size=(b, t, f))).astype(f32),
            rng.uniform(-lim1, lim1, (3, f, d)).astype(f32),
            rng.uniform(-lim1, lim1, d).astype(f32),
            rng.uniform(-lim2, lim2, (3, d, d)).astype(f32),
            rng.uniform(-lim2, lim2, d).astype(f32))


class TestDecoderThreeTf32:
    # F 257, S 3 (771 columns: 6 full 128-column tiles and a 3-column one)
    # and B*T 74 (a partial block of rows across the utterance boundary),
    # against the plain version and the Pallas kernel in interpret mode
    # (its (in, out) weights are the transposes; its erf approximation is
    # within 1.5e-7: test_torch_kernels.py's 2e-6 on the masks, 2e-5 on
    # separated at |mixed| ~ 4).
    @pytest.mark.parametrize("rows", [128, 64, 32])
    def test_matches_plain_and_pallas(self, rows):
        import jax.numpy as jnp

        from av_separation_torch.ops.kernels.decoder import (
            mask_decoder_fwd_torch)
        from av_separation_tpu.ops.pallas.decoder import fused_mask_decoder
        b, t, d, s, f = 2, 37, 64, 3, 257
        x, w1, b1, w2, b2, mixed = _decoder_case(b, t, d, s, f, 80, 4.0)
        sep, masks = decoder_tiles_emulated(x, w1, b1, w2, b2, mixed, s, 3,
                                            rows)
        sep_p, masks_p = mask_decoder_fwd_torch(
            *(torch.from_numpy(a) for a in (x, w1, b1, w2, b2, mixed)), s)
        np.testing.assert_allclose(masks, masks_p.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(sep, sep_p.numpy(),
                                   atol=1e-5 * np.abs(mixed).max(), rtol=0)
        with pltpu.force_tpu_interpret_mode():
            sep_j, masks_j = fused_mask_decoder(
                *(jnp.asarray(a) for a in (x, w1.T, b1, w2.T, b2, mixed)),
                s, f)
        np.testing.assert_allclose(masks, np.asarray(masks_j), atol=2e-6,
                                   rtol=1e-5)
        np.testing.assert_allclose(sep, np.asarray(sep_j), atol=2e-5,
                                   rtol=1e-5)

    # The scaled serving shape (T 501, d 512, S 2, F 257) with B cut to 1,
    # as the card's row holds it: 3xTF32 keeps the masks within 1e-5 and
    # separated within 1e-5 of the peak of mixed; 1xTF32 does not.
    def test_3xtf32_holds_float32_tolerance_and_1xtf32_does_not(self):
        from av_separation_torch.ops.kernels.decoder import (
            mask_decoder_fwd_torch)
        x, w1, b1, w2, b2, mixed = _decoder_case(1, 501, 512, 2, 257, 81)
        sep_p, masks_p = (a.numpy() for a in mask_decoder_fwd_torch(
            *(torch.from_numpy(a) for a in (x, w1, b1, w2, b2, mixed)), 2))
        sep_tol = 1e-5 * np.abs(mixed).max()
        sep3, masks3 = decoder_tiles_emulated(x, w1, b1, w2, b2, mixed, 2, 3)
        assert np.abs(masks3 - masks_p).max() <= 1e-5
        assert np.abs(sep3 - sep_p).max() <= sep_tol
        sep1, masks1 = decoder_tiles_emulated(x, w1, b1, w2, b2, mixed, 2, 1)
        assert np.abs(masks1 - masks_p).max() > 1e-5 \
            or np.abs(sep1 - sep_p).max() > sep_tol

    # (B*T, columns) -> block rows on 132 SMs: the largest tile whose grid
    # still gives every SM a block.
    @pytest.mark.parametrize("m,n,rows", [
        (8 * 501, 1024, 128), (8 * 501, 514, 128),      # scaled: 256, 160
        (8 * 63, 1024, 32), (8 * 63, 771, 32),          # three_speaker
        (16 * 501, 2048, 128), (16 * 501, 1028, 128),   # multihost
        (4 * 63, 256, 32)])                             # demo
    def test_rows_by_shape(self, m, n, rows):
        from av_separation_torch.ops.kernels.decoder import decoder_rows
        assert decoder_rows(m, n, 132) == rows


class TestProjectionThreeTf32:
    # The projection at a float32 x (float32 accuracy from bf16 products of
    # three-part operands: the rate of 3xTF32).  F 257 (chunks of 64, the
    # tail zero), T 37 (a partial block) in blocks of 128, 64 and 32
    # frames, against the plain version and the Pallas kernel in interpret
    # mode at test_torch_kernels.py's 2e-5 + 1e-4 relative.
    @pytest.mark.parametrize("rows", [128, 64, 32])
    def test_matches_plain_and_pallas(self, rows):
        import jax.numpy as jnp

        from av_separation_torch.ops.kernels.audio_proj import (
            audio_proj_fwd_torch)
        from av_separation_tpu.ops.pallas.audio_proj import _fwd_impl
        args = _proj_case(2, 37, 257, 64, 82)
        y, h = proj_tiles_emulated(*args, 3, rows)
        y_p, h_p = audio_proj_fwd_torch(*(torch.from_numpy(a) for a in args))
        np.testing.assert_allclose(y, y_p.numpy(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(h, h_p.numpy(), atol=1e-4, rtol=0)
        with pltpu.force_tpu_interpret_mode():
            y_j, h_j = _fwd_impl(*(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(y, np.asarray(y_j), atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(h, np.asarray(h_j), atol=2e-5, rtol=1e-4)

    def test_hidden_halo_is_zero_not_relu_bias(self):
        # x = 0, b1 = 1: h = 1 inside [0, T), and conv2 at the first and
        # last frames sees zeros beyond them: 2 taps of ones, not 3.
        t, f, d = 70, 257, 64
        x = np.zeros((1, t, f), np.float32)
        w1 = np.zeros((3, f, d), np.float32)
        w2 = np.full((3, d, d), 1.0 / d, np.float32)
        y, h = proj_tiles_emulated(x, w1, np.ones(d, np.float32), w2,
                                   np.zeros(d, np.float32), 3)
        assert np.all(h == 1.0)
        np.testing.assert_allclose(y[0, [0, t - 1]], 2.0, rtol=1e-6)
        np.testing.assert_allclose(y[0, 1:t - 1], 3.0, rtol=1e-6)

    # The scaled serving shape (T 501, F 257, D 512) with B cut to 1: the
    # six products keep y and h within the card's 1e-4 of the plain
    # version; one product of bf16-rounded values does not.
    def test_3xtf32_holds_float32_tolerance_and_1xtf32_does_not(self):
        from av_separation_torch.ops.kernels.audio_proj import (
            audio_proj_fwd_torch)
        args = _proj_case(1, 501, 257, 512, 83)
        y_p, h_p = (a.numpy() for a in audio_proj_fwd_torch(
            *(torch.from_numpy(a) for a in args)))
        y3, h3 = proj_tiles_emulated(*args, 3)
        assert np.abs(y3 - y_p).max() <= 1e-4
        assert np.abs(h3 - h_p).max() <= 1e-4
        y1, h1 = proj_tiles_emulated(*args, 1)
        assert max(np.abs(y1 - y_p).max(), np.abs(h1 - h_p).max()) > 1e-4

    # (B, T, D) -> channels a block on 132 SMs (128 frames each): 128
    # where that still gives half the SMs a block, else 64.
    @pytest.mark.parametrize("shape,bn", [
        ((8, 501, 512), 128),     # scaled: 128 blocks
        ((4, 63, 128), 64),       # demo: 8 blocks
        ((8, 63, 512), 64),       # three_speaker: 64 blocks
        ((16, 501, 1024), 128),   # multihost: 512 blocks
        ((2, 376, 512), 64)])     # lrs2, batch 2: 48 blocks
    def test_rows_by_shape(self, shape, bn):
        from av_separation_torch.ops.kernels.audio_proj import proj_plan
        assert proj_plan(*shape, 132)["bn"] == bn


class TestPaddedWidths:
    # Widths the projection and decoder kernels are not built for (below
    # 64, or not a multiple of 8) run zero-padded to `kernel_width(d)`;
    # widths above 1024 run as they are.  The padded route through the
    # plain versions and through the numpy emulation of the kernels'
    # products (3xTF32; the projection's three-part bf16), against the unpadded plain version and the JAX Pallas kernels
    # in interpret mode: y and h within 1e-4 (the card's rows), masks
    # within 1e-5 and separated within 1e-5 of the peak of mixed.
    @pytest.mark.parametrize("d,width", [(8, 64), (36, 64), (64, 64),
                                         (196, 200), (1536, 1536)])
    def test_kernel_width(self, d, width):
        from av_separation_torch.ops.kernels import kernel_width
        assert kernel_width(d) == width

    @pytest.mark.parametrize("d", [36, 196, 1536])
    def test_projection(self, d):
        import jax.numpy as jnp

        from av_separation_torch.ops.kernels import kernel_width
        from av_separation_torch.ops.kernels.audio_proj import (
            audio_proj_fwd_torch, padded_proj)
        from av_separation_tpu.ops.pallas.audio_proj import _fwd_impl
        args = _proj_case(1, 21, 65, d, 90)
        ts = [torch.from_numpy(a) for a in args]
        widths = []

        def emulated(*a):
            widths.append(a[1].shape[-1])
            return tuple(torch.from_numpy(r) for r in proj_tiles_emulated(
                *(t.numpy() for t in a), 3))

        y_u, h_u = audio_proj_fwd_torch(*ts)
        with pltpu.force_tpu_interpret_mode():
            y_j, h_j = (np.asarray(r)
                        for r in _fwd_impl(*(jnp.asarray(a) for a in args)))
        for y, h in (padded_proj(audio_proj_fwd_torch, *ts),
                     padded_proj(emulated, *ts)):
            assert y.shape == h.shape == (1, 21, d)
            for got, u, j in ((y, y_u, y_j), (h, h_u, h_j)):
                np.testing.assert_allclose(got.numpy(), u.numpy(), atol=1e-4,
                                           rtol=0)
                np.testing.assert_allclose(got.numpy(), j, atol=1e-4, rtol=0)
        assert widths == [kernel_width(d)]

    @pytest.mark.parametrize("d", [36, 196, 1536])
    def test_decoder(self, d):
        import jax.numpy as jnp

        from av_separation_torch.ops.kernels import kernel_width
        from av_separation_torch.ops.kernels.decoder import (
            mask_decoder_fwd_torch, padded_decoder)
        from av_separation_tpu.ops.pallas.decoder import fused_mask_decoder
        b, t, s, f = 1, 21, 2, 65
        args = _decoder_case(b, t, d, s, f, 91, 4.0)
        x, w1, b1, w2, b2, mixed = args
        ts = [torch.from_numpy(a) for a in args]
        widths = []

        def emulated(*a):
            widths.append(a[0].shape[-1])
            return tuple(torch.from_numpy(r) for r in decoder_tiles_emulated(
                *(t.numpy() for t in a[:6]), s, 3, 32))

        sep_u, masks_u = mask_decoder_fwd_torch(*ts, s)
        with pltpu.force_tpu_interpret_mode():
            sep_j, masks_j = (np.asarray(r) for r in fused_mask_decoder(
                *(jnp.asarray(a) for a in (x, w1.T, b1, w2.T, b2, mixed)),
                s, f))
        sep_tol = 1e-5 * np.abs(mixed).max()
        for sep, masks in (padded_decoder(mask_decoder_fwd_torch, *ts, s),
                           padded_decoder(emulated, *ts, s)):
            assert masks.shape == sep.shape == (b, s, f, t)
            for got, u, j, tol in ((masks, masks_u, masks_j, 1e-5),
                                   (sep, sep_u, sep_j, sep_tol)):
                np.testing.assert_allclose(got.numpy(), u.numpy(), atol=tol,
                                           rtol=0)
                np.testing.assert_allclose(got.numpy(), j, atol=tol, rtol=0)
        assert widths == [kernel_width(d)]

    def test_padded_weights_are_kept_per_version(self):
        from av_separation_torch.ops.kernels import zero_padded
        w = torch.ones(3, 5)
        first = zero_padded(w, (4, 8))
        assert zero_padded(w, (4, 8)) is first
        assert torch.equal(first[:3, :5], w) and float(first.sum()) == 15
        w.mul_(2)  # an in-place update, as an optimizer step
        again = zero_padded(w, (4, 8))
        assert again is not first and float(again.sum()) == 30
