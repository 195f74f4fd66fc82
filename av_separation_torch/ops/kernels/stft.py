"""Fused STFT magnitude: the CUDA kernels of `csrc/stft_fft.cu`, and their
plain PyTorch version.

Port of `av_separation_tpu/ops/pallas/stft.py` (`_stft_kernel`, called from
`stft_magnitude_pallas`): framing, the symmetric Hann window, the rDFT and
the magnitude.  Reference semantics (reference dataset.py:122-135): frame i
starts at sample i * hop, no centering, samples past N are zero, T defaults
to 1 + N // hop.  The on-device data generator (`data/device_synthetic.py`)
runs it once per generated batch; the serving path keeps `ops/stft.py`'s
matmul DFT, as the JAX `Separator` keeps the XLA STFT.

An FFT for every n_fft >= 2, at any hop and any number of signals.  An even
n_fft transforms L = n_fft / 2 points (two samples packed into one complex
value, then the real split step), an odd one L = n_fft points (two frames
packed into one complex sequence, then separated).  The transform of L
(`fft_plan`), the first that applies:
  - 'pow2' / 'mixed': a 7-smooth L, a Stockham FFT of radices 2, 3, 4, 5,
    7 and 8;
  - 'rader' (n_fft <= 4096): a prime L whose L - 1 is 7-smooth, Rader's
    cyclic convolution of L - 1 points (257: 256; 401: 400; 31: 30);
  - 'prime' (n_fft <= 4096): every prime factor of L at most 31, the same
    stages and direct radix-11 to -31 stages (551 = 19 x 29; 23);
  - 'bluestein': any other L, the chirp-z transform through an FFT of P
    points, the smallest 7-smooth P >= 2L - 1 (257 -> 525 were it not
    Rader's; 551 -> 1120; 2049 -> 4116).
Two regimes on the card, chosen by shape (`route`; not a fallback: an error
in either raises):
  - 'fft', one block a tile of frames with the whole transform in shared
    memory, wherever one frame's block fits (every n_fft up to 4096, and
    above it up to n_fft 16384 for a power-of-two L, 19,208 for a 7-smooth
    one, 8,190 under Bluestein): one launch, counted under `stft_mag_fwd`;
  - 'four_step', the four-step FFT of L (or Bluestein's power of two
    P >= 2L - 1) = n1 n2 points through a global scratch (`four_step_plan`),
    two passes (three under Bluestein) a chunk of frames: counted once a
    call under `stft_mag_4step_fwd`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from av_separation_torch.ops import kernels
from av_separation_torch.ops.kernels import _build
from av_separation_torch.ops.stft import hann_symmetric, stft_magnitude

MAX_SMEM_BYTES = 232448     # shared memory a block may use (H100)
MAX_GRID_X = 2 ** 31 - 1
# A block's share of an SM's 233,472 bytes (less 1 KB a block) when four,
# two or one blocks reside on it (H100).
SMEM_SHARES = (57344, 115712, MAX_SMEM_BYTES)
STAGED_MAX = 4096           # n_fft up to which a block stages span and window
FFT_TILES = (8, 4, 2, 1)    # frames a block of the 'fft' regime
# Up to n_fft 64 also 32 and 16 frames: a block of 8 such frames is mostly
# fixed cost (the span, the tables, the barriers).  On an H100 32 frames cut
# 22 / 11 from 0.0994 to 0.0363 device ms and 16 / 4 from 0.1179 to 0.0409
# (`tools/torch_stft_sweep.py variants`, PERF.md).
TINY_N_FFT = 64
TINY_TILES = (32, 16) + FFT_TILES
WIDE_TILES = (2, 1)         # the same above n_fft 4096
MAX_STAGES = 12             # kMaxStages in stft_fft.cu
STAGE_TABLE_BYTES = 20 * MAX_STAGES  # its static shared Stage table
MAX_PAD = 8192              # Bluestein's P in the 'fft' regime (kMaxPad)
# The direct prime radices (kMaxPrime); they and Rader serve up to
# STAGED_MAX (256-thread blocks).
PRIMES = (11, 13, 17, 19, 23, 29, 31)
# The C enum of transforms (stft_fft.cu).
KIND_CODES = {"pow2": 0, "mixed": 1, "bluestein": 2, "prime": 3, "rader": 4}
# The four-step regime: row and column lengths (kMaxRow, kMaxColumn), the
# complex points a block works on, and the scratch a chunk of sequences
# may hold (it stays in the H100's 50 MB L2).
MAX_ROW = 2048
MAX_COLUMN = 8192
BLOCK_POINTS = 4096
SCRATCH_BYTES = 32 << 20
MAX_FOUR_STEP = 1 << 24     # P < 2^24: sincospif's argument 2m / P exact


def stft_magnitude_fwd_torch(audio: torch.Tensor, n_fft: int, hop: int,
                             num_frames: int | None = None) -> torch.Tensor:
    """Plain version: `ops/stft.stft_magnitude`, (..., N) -> (..., F, T)."""
    return stft_magnitude(audio, n_fft, hop, num_frames)


class FftPlan(NamedTuple):
    """The transform of one n_fft."""
    length: int                # L: the complex transform's length
    radices: Tuple[int, ...]   # the Stockham stages over `size` points
    pad: int                   # Bluestein's P (7-smooth, >= 2L - 1), else 0
    kind: str                  # 'pow2', 'mixed', 'prime', 'rader',
    #                            'bluestein' (KIND_CODES)
    size: int                  # the FFT's length: L, L - 1 (Rader) or P


def radices(n: int) -> Optional[Tuple[int, ...]]:
    """The Stockham stages of an n-point FFT: for a power of two 2^e, one 2
    (e mod 3 = 1) or one 4 (e mod 3 = 2), then 8s (256: 4, 8, 8; 1024: 2,
    8, 8, 8); otherwise one 2 when n's power of two has an odd exponent,
    then 4s, 3s, 5s and 7s (200: 2, 4, 5, 5; 441: 3, 3, 7, 7).  None when
    n has a prime factor above 7."""
    twos = 0
    while n > 1 and n % 2 == 0:
        n //= 2
        twos += 1
    if n == 1:
        return (2,) * (twos % 3 == 1) + (4,) * (twos % 3 == 2) \
            + (8,) * (twos // 3)
    plan = [2] * (twos % 2) + [4] * (twos // 2)
    for r in (3, 5, 7):
        while n % r == 0:
            n //= r
            plan.append(r)
    return tuple(plan) if n == 1 else None


def prime_radices(n: int) -> Optional[Tuple[int, ...]]:
    """The stages of n whose prime factors are all at most 31 and one of
    them above 7: `radices` of its 7-smooth part, then the primes 11 to 31
    in ascending order (143: 11, 13; 551: 19, 29; 88: 8, 11).  None
    otherwise."""
    primes = []
    for p in PRIMES:
        while n % p == 0:
            n //= p
            primes.append(p)
    rest = radices(n)
    return rest + tuple(primes) if primes and rest is not None else None


def is_prime(n: int) -> bool:
    return n > 1 and all(n % d for d in range(2, math.isqrt(n) + 1))


def smooth_at_least(n: int) -> int:
    """The smallest 7-smooth number >= n (1 for n <= 1)."""
    m = max(n, 1)
    while radices(m) is None:
        m += 1
    return m


@functools.lru_cache(maxsize=None)
def fft_plan(n_fft: int) -> FftPlan:
    """The transform of one n_fft: L = n_fft / 2 (even) or n_fft (odd);
    L's own radices when it is 7-smooth (448: L 224, radices 2, 4, 4, 7);
    up to n_fft 4096 Rader over L - 1 for a prime L whose L - 1 is
    7-smooth (514: L 257, radices 4, 8, 8 over 256; 62: L 31 over 30),
    else the prime radices when L's factors are at most 31 (1102: L 551,
    radices 19, 29; 46: L 23, as 22 is not 7-smooth); else Bluestein over
    the smallest 7-smooth P >= 2L - 1 (402: L 201, P 405, radices 3, 3,
    3, 3, 5).  Rader comes first for the primes 11 to 31 too: on an H100
    it beat their single direct stage at n_fft 22, 26, 34, 58 and 62 and
    tied at 38 (the direct stage's block holds 80 registers, Rader's 40;
    `tools/torch_stft_sweep.py`, PERF.md)."""
    length = n_fft // 2 if n_fft % 2 == 0 else n_fft
    plan = radices(length)
    if plan is not None:
        kind = "pow2" if length & (length - 1) == 0 else "mixed"
        return FftPlan(length, plan, 0, kind, length)
    if n_fft <= STAGED_MAX:
        if is_prime(length) and radices(length - 1) is not None:
            return FftPlan(length, radices(length - 1), 0, "rader",
                           length - 1)
        plan = prime_radices(length)
        if plan is not None:
            return FftPlan(length, plan, 0, "prime", length)
    pad = smooth_at_least(2 * length - 1)
    return FftPlan(length, radices(pad), pad, "bluestein", pad)


def twiddle_half(plan: FftPlan) -> int:
    """h of the stages' twiddle table exp(-pi i j / h), j <= h (`half` in
    stft_fft.cu): L for the transforms of L points; half the FFT's length
    under Rader (L - 1 is even) and under Bluestein at an even P; P at an
    odd P, whose stages' twiddles exp(-2 pi i m / P) then sit at even j."""
    if plan.kind in ("pow2", "mixed", "prime"):
        return plan.length
    return plan.size // 2 if plan.size % 2 == 0 else plan.size


def fft_sequences(n_fft: int, tile: int) -> int:
    """Complex sequences of one 'fft' block: one a frame (even n_fft), one
    a pair of frames (odd)."""
    return (tile + 1) // 2 if n_fft % 2 else tile


def fft_region_floats(n_fft: int, hop: int, tile: int) -> int:
    """Floats of each of the 'fft' block's two work regions
    (`region_floats` in stft_fft.cu): the staged span (up to n_fft 4096),
    the sequences of the FFT's ping-pong and the (bin, frame) stage all
    fit; rounded up to 4 so the next region stays 16-byte aligned."""
    plan = fft_plan(n_fft)
    f = n_fft // 2 + 1
    span = (tile - 1) * hop + n_fft if n_fft <= STAGED_MAX else 0
    r = max(2 * fft_sequences(n_fft, tile) * plan.size, span, f * (tile + 1))
    return -(-r // 4) * 4


def fft_smem_bytes(n_fft: int, hop: int, tile: int) -> int:
    """Shared memory of one 'fft' block (`smem` in stft_fft.cu plus the
    static stage table): two work regions, the FFT's twiddle table, the
    split step's (even n_fft under Rader and Bluestein; otherwise it is the
    twiddle table), Rader's z[0] and X[0] of each sequence, the window
    (staged up to n_fft 4096)."""
    plan = fft_plan(n_fft)
    own = plan.kind in ("rader", "bluestein")
    split = n_fft // 2 + 1 if own and n_fft % 2 == 0 else 0
    dc = 2 * fft_sequences(n_fft, tile) if plan.kind == "rader" else 0
    window = n_fft if n_fft <= STAGED_MAX else 0
    return (4 * 2 * fft_region_floats(n_fft, hop, tile)
            + 8 * (twiddle_half(plan) + 1 + split + dc) + 4 * window
            + STAGE_TABLE_BYTES)


def route(n_fft: int) -> str:
    """'fft' where one frame's block of the whole transform fits shared
    memory (every n_fft in [2, 4096]; above, without staging and with at
    most P 8192 under Bluestein), else 'four_step'.  n_fft below 2 has no
    route: the checks raise."""
    plan = fft_plan(max(n_fft, 2))
    if plan.pad > MAX_PAD:
        return "four_step"
    return "fft" if fft_smem_bytes(n_fft, 1, 1) <= MAX_SMEM_BYTES \
        else "four_step"


def fft_tile_frames(n_fft: int, hop: int, signals: int, num_frames: int,
                    sm_count: int) -> int:
    """Frames a block of the 'fft' regime, a power of two <= 8 (<= 32 up
    to n_fft 64).  Among the
    tiles whose blocks let four share an SM (else two, else one), the
    largest whose grid gives every SM at least two blocks, or the smallest
    (for an odd n_fft, whose sequence holds two frames, 2 rather than 1).
    On an H100 (`tools/torch_stft_sweep.py tiles`) four resident blocks
    beat larger tiles at n_fft 1102, 514 and 401, and 8 frames beat 16 at
    512.  Above n_fft 4096 (512 threads a block, whose registers let at
    most three share an SM) two frames where they fit, else one: two beat
    one at 8192 / 1024 (one block an SM against two) and at 4410 / 441
    (`variants --rows large`).  No tile beyond the power of two that
    holds all `num_frames` (a pair for an odd n_fft): its blocks would
    transform empty frames (66,000 one-frame signals at 4098).  One frame
    fits at every n_fft of the regime and every hop."""
    cover = max(n_fft % 2 + 1, 1 << (max(num_frames, 1) - 1).bit_length())
    if n_fft > STAGED_MAX:
        tiles = [t for t in WIDE_TILES if t <= cover
                 and fft_smem_bytes(n_fft, hop, t) <= MAX_SMEM_BYTES]
        for t in tiles:
            if signals * -(-num_frames // t) >= 2 * sm_count:
                return t
        return tiles[-1]
    for share in SMEM_SHARES:
        tiles = [t for t in (TINY_TILES if n_fft <= TINY_N_FFT else FFT_TILES)
                 if t <= cover and fft_smem_bytes(n_fft, hop, t) <= share]
        if n_fft % 2 and 2 in tiles:
            tiles.remove(1)
        for t in tiles:
            if signals * -(-num_frames // t) >= 2 * sm_count:
                return t
        if tiles:
            return tiles[-1]
    raise ValueError(f"no FFT tile fits shared memory at n_fft {n_fft}")


class FourStepPlan(NamedTuple):
    """What the 'four_step' regime runs for one n_fft: P = n1 n2 points
    (P = L, or Bluestein's pad), columns of n1 points and rows of n2."""
    length: int                  # L
    pad: int                     # Bluestein's P, else 0
    n1: int                      # the column FFTs' length
    n2: int                      # the row FFTs' length, P's largest
    #                              divisor up to MAX_ROW
    radices1: Tuple[int, ...]
    radices2: Tuple[int, ...]
    cols: int                    # columns a block of the first pass (2^k)
    rows: int                    # rows a block of Bluestein's middle pass
    pairs: int                   # pairs a block of the last pass (2^k)
    sequences: int               # sequences a chunk (the scratch's)


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


@functools.lru_cache(maxsize=None)
def four_step_plan(n_fft: int) -> FourStepPlan:
    """The four-step plan of one n_fft: P = L for a 7-smooth L, else
    Bluestein's power of two P >= 2L - 1; n2 the largest divisor of P up to
    2048, n1 = P / n2 (up to 8192); about BLOCK_POINTS points a block in
    every pass; chunks of sequences whose scratch fits SCRATCH_BYTES.
    n_fft 32768: L 16384 = 8 x 2048; 8194: L 4097, P 16384 = 8 x 2048."""
    length = n_fft // 2 if n_fft % 2 == 0 else n_fft
    pad = 0 if radices(length) else 1 << (2 * length - 2).bit_length()
    size = pad or length
    n2 = next(d for d in range(min(size, MAX_ROW), 0, -1) if size % d == 0)
    n1 = size // n2
    if n1 > MAX_COLUMN or size >= MAX_FOUR_STEP or n1 < 2 or n2 < 2:
        raise ValueError(f"n_fft {n_fft}: no four-step split of {size} "
                         f"points into columns <= {MAX_COLUMN} and rows "
                         f"<= {MAX_ROW}")
    cols = _pow2_floor(BLOCK_POINTS // n1)
    while cols > 1 and cols // 2 >= n2:
        cols //= 2
    rows = max(1, BLOCK_POINTS // n2)
    q = n1 if pad else n2               # the last pass's sequence length
    pairs = _pow2_floor(BLOCK_POINTS // (2 * q))
    return FourStepPlan(length, pad, n1, n2, radices(n1),
                        radices(n2), cols, rows, pairs,
                        max(1, SCRATCH_BYTES // (8 * size)))


def four_step_sequences(n_fft: int, num_frames: int) -> int:
    """Sequences of one signal: a frame each (even n_fft), a pair of
    frames each (odd)."""
    return -(-num_frames // 2) if n_fft % 2 else num_frames


class FftTables(NamedTuple):
    """The 'fft' regime's constant tables, float32, each computed in float64
    (complex values as (re, im) rows), in the order of the C entry point's
    table arguments."""
    window: np.ndarray     # (n_fft,) the symmetric Hann window
    twiddle: np.ndarray    # (h + 1, 2) exp(-2 pi i j / 2h), h the plan's
    #                        `twiddle_half`
    split: np.ndarray      # (n_fft/2 + 1, 2) exp(-2 pi i k / n_fft): even
    #                        n_fft (the twiddle table itself when L is
    #                        transformed in its own radices); empty for odd
    chirp: np.ndarray      # (L, 2) exp(-i pi (n^2 mod 2L) / L): Bluestein
    chirp_fft: np.ndarray  # Bluestein: (P, 2) P-point FFT of
    #                        exp(i pi m^2 / L) over |m| < L (circular),
    #                        divided by P.  Rader: (L - 1, 2) the FFT of
    #                        b[m] = exp(-2 pi i (g^-m mod L) / L), divided by
    #                        L - 1
    perm: np.ndarray       # Rader: (2L - 1,) int32, the gather g^q mod L
    #                        (q < L - 1), then for each bin k < L the p with
    #                        g^-p = k (entry 0 unused: 0)


def _unit(phase_num: np.ndarray, phase_den: int) -> np.ndarray:
    """exp(-2 pi i num / den) as float32 (re, im) rows, from float64."""
    ang = -2.0 * np.pi * phase_num.astype(np.float64) / phase_den
    return np.ascontiguousarray(
        np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32))


def _chirp_tables(length: int, pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """Bluestein's chirp c*[n] (L rows) and the P-point FFT of the chirp
    over |m| < L, divided by P (P rows).  The phase n^2 mod 2L is taken in
    integers, so no angle grows with n."""
    n = np.arange(length, dtype=np.int64)
    sq = (n * n) % (2 * length)
    chirp = _unit(sq, 2 * length)               # exp(-i pi n^2 / L)
    c = np.exp(1j * np.pi * sq / length)        # exp(+i pi n^2 / L)
    b = np.zeros(pad, np.complex128)
    b[:length] = c
    b[pad - length + 1:] = c[1:][::-1]
    spec = np.fft.fft(b) / pad
    return chirp, np.ascontiguousarray(
        np.stack([spec.real, spec.imag], axis=1).astype(np.float32))


def primitive_root(p: int) -> int:
    """The smallest generator of the multiplicative group mod a prime p."""
    factors = {q for q in range(2, p) if (p - 1) % q == 0 and is_prime(q)}
    return next(g for g in range(2, p)
                if all(pow(g, (p - 1) // q, p) != 1 for q in factors))


def _rader_tables(length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rader's permutations and convolution table for a prime L (see
    `FftTables`): with g a primitive root, a[q] = z[g^q] and
    b[m] = W_L^(g^-m), X[g^-p] = z[0] + (a (*) b)[p], the cyclic
    convolution of M = L - 1 points.  Every exponent is taken in integers,
    so each b[m] is exact in float64 before its transform."""
    m = length - 1
    g = primitive_root(length)
    gather = np.array([pow(g, q, length) for q in range(m)], np.int64)
    ginv = pow(g, length - 2, length)
    b = np.exp(-2j * np.pi * np.array([pow(ginv, q, length)
                                       for q in range(m)]) / length)
    spec = np.fft.fft(b) / m
    bins = np.zeros(length, np.int64)
    bins[gather] = (-np.arange(m)) % m        # k = g^q  <-  p = -q mod M
    perm = np.concatenate([gather, bins]).astype(np.int32)
    return perm, np.ascontiguousarray(
        np.stack([spec.real, spec.imag], axis=1).astype(np.float32))


def fft_tables(n_fft: int) -> FftTables:
    """The tables of one n_fft (see `FftTables`)."""
    plan = fft_plan(n_fft)
    half = twiddle_half(plan)
    twiddle = _unit(np.arange(half + 1), 2 * half)
    empty = np.zeros((0, 2), np.float32)
    if n_fft % 2:
        split = empty
    elif plan.kind in ("rader", "bluestein"):
        split = _unit(np.arange(n_fft // 2 + 1), n_fft)
    else:
        split = twiddle
    chirp, chirp_fft, perm = empty, empty, np.zeros(0, np.int32)
    if plan.kind == "bluestein":
        chirp, chirp_fft = _chirp_tables(plan.length, plan.pad)
    elif plan.kind == "rader":
        perm, chirp_fft = _rader_tables(plan.length)
    return FftTables(hann_symmetric(n_fft).astype(np.float32), twiddle,
                     split, chirp, chirp_fft, perm)


class FourStepTables(NamedTuple):
    """The 'four_step' regime's tables, float32 from float64."""
    window: np.ndarray     # (n_fft,)
    twiddle1: np.ndarray   # (n1 + 1, 2) exp(-2 pi i j / 2 n1)
    twiddle2: np.ndarray   # (n2 + 1, 2) exp(-2 pi i j / 2 n2)
    split: np.ndarray      # (n_fft/2 + 1, 2) exp(-2 pi i k / n_fft): even
    chirp: np.ndarray      # (L, 2): Bluestein
    chirp_fft: np.ndarray  # (P, 2) as FftTables', in the [k1][k2] layout:
    #                        row k1 n2 + k2 holds entry k1 + n1 k2


def four_step_tables(n_fft: int) -> FourStepTables:
    p = four_step_plan(n_fft)
    empty = np.zeros((0, 2), np.float32)
    split = empty if n_fft % 2 else _unit(np.arange(n_fft // 2 + 1), n_fft)
    chirp, chirp_fft = empty, empty
    if p.pad:
        chirp, spec = _chirp_tables(p.length, p.pad)
        chirp_fft = np.ascontiguousarray(
            spec.reshape(p.n2, p.n1, 2).transpose(1, 0, 2).reshape(-1, 2))
    return FourStepTables(hann_symmetric(n_fft).astype(np.float32),
                          _unit(np.arange(p.n1 + 1), 2 * p.n1),
                          _unit(np.arange(p.n2 + 1), 2 * p.n2), split,
                          chirp, chirp_fft)


@functools.lru_cache(maxsize=8)
def _fft_tables(n_fft: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(t, device=device) for t in fft_tables(n_fft))


@functools.lru_cache(maxsize=8)
def _four_step_tables(n_fft: int, device: torch.device
                      ) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(t, device=device)
                 for t in four_step_tables(n_fft))


@functools.lru_cache(maxsize=None)
def _fft_entry():
    lib = _build.load("stft_fft")
    fn = lib.avsep_stft_fft_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _four_step_entry():
    lib = _build.load("stft_fft")
    fn = lib.avsep_stft_4step_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int] * 2 \
        + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(audio: torch.Tensor, n_fft: int, hop: int,
           num_frames: int) -> None:
    """The kernels' input checks, and the limits of the route `n_fft`
    takes: the 'fft' regime's grid (a grid this large takes the tile it
    would on any card), the four-step split's reach."""
    if audio.dtype != torch.float32:
        raise ValueError(f"audio must be float32, got {audio.dtype}")
    if not audio.is_contiguous():
        raise ValueError("audio must be contiguous")
    if audio.dim() < 1 or audio.shape[-1] < 1:
        raise ValueError(f"audio must be (..., N), got {tuple(audio.shape)}")
    if n_fft < 2:
        raise ValueError(f"n_fft {n_fft} must be at least 2")
    if hop < 1:
        raise ValueError(f"hop {hop} must be positive")
    if num_frames < 1:
        raise ValueError(f"num_frames {num_frames} must be positive")
    if route(n_fft) == "four_step":
        four_step_plan(n_fft)
        return
    signals = math.prod(audio.shape[:-1])
    if signals:
        tile = fft_tile_frames(n_fft, hop, signals, num_frames, 1)
        if signals * -(-num_frames // tile) > MAX_GRID_X:
            raise ValueError(f"{signals} signals of {num_frames} frames in "
                             f"tiles of {tile} exceed the grid's "
                             f"{MAX_GRID_X} blocks")


def stft_magnitude_fwd(audio: torch.Tensor, n_fft: int, hop: int,
                       num_frames: int | None = None) -> torch.Tensor:
    """|STFT| of (..., N) float32 audio -> (..., n_fft // 2 + 1, T).

    CPU tensors take the plain version; CUDA tensors launch the FFT kernel
    of the shape's regime (`route`).
    """
    if audio.device.type == "cpu":
        return stft_magnitude_fwd_torch(audio, n_fft, hop, num_frames)
    if audio.device.type != "cuda":
        raise ValueError(f"unsupported device {audio.device}")
    n = audio.shape[-1]
    if num_frames is None:
        num_frames = 1 + n // hop
    _check(audio, n_fft, hop, num_frames)
    lead = audio.shape[:-1]
    b = math.prod(lead)
    freq_bins = n_fft // 2 + 1
    out = torch.empty((b, freq_bins, num_frames), dtype=torch.float32,
                      device=audio.device)
    if b == 0:
        return out.reshape(*lead, freq_bins, num_frames)
    index = audio.device.index
    stream = kernels.stream(audio.device)
    if route(n_fft) == "fft":
        tables = _fft_tables(n_fft, audio.device)
        tile = fft_tile_frames(n_fft, hop, b, num_frames, _sm_count(index))
        vec = int(n_fft <= STAGED_MAX and hop % 4 == 0 and n % 4 == 0
                  and audio.data_ptr() % 16 == 0)
        plan = fft_plan(n_fft)
        lib, fn = _fft_entry()
        rc = fn(audio.data_ptr(), *(t.data_ptr() for t in tables),
                out.data_ptr(), b, n, num_frames, n_fft, hop, tile, vec,
                (ctypes.c_int * len(plan.radices))(*plan.radices),
                len(plan.radices), KIND_CODES[plan.kind], plan.pad, index,
                stream)
        _build.check(lib, rc, "stft_mag_fwd")
        kernels.LAUNCHES["stft_mag_fwd"] += 1
        return out.reshape(*lead, freq_bins, num_frames)
    plan = four_step_plan(n_fft)
    tables = _four_step_tables(n_fft, audio.device)
    total = b * four_step_sequences(n_fft, num_frames)
    chunk = min(total, plan.sequences)
    scratch = torch.empty((chunk, plan.pad or plan.length, 2),
                          dtype=torch.float32, device=audio.device)
    r1 = (ctypes.c_int * len(plan.radices1))(*plan.radices1)
    r2 = (ctypes.c_int * len(plan.radices2))(*plan.radices2)
    lib, fn = _four_step_entry()
    for seq0 in range(0, total, chunk):
        rc = fn(audio.data_ptr(), *(t.data_ptr() for t in tables),
                scratch.data_ptr(), out.data_ptr(), b, n, num_frames, n_fft,
                hop, plan.n1, plan.n2, r1, len(plan.radices1), r2,
                len(plan.radices2), plan.pad, plan.cols, plan.rows,
                plan.pairs, seq0, min(chunk, total - seq0), index, stream)
        _build.check(lib, rc, "stft_mag_4step_fwd")
    kernels.LAUNCHES["stft_mag_4step_fwd"] += 1
    return out.reshape(*lead, freq_bins, num_frames)
