"""Fused STFT magnitude: the CUDA kernels `csrc/stft_fft.cu` and
`csrc/stft_mag.cu`, and their plain PyTorch version.

Port of `av_separation_tpu/ops/pallas/stft.py` (`_stft_kernel`, called from
`stft_magnitude_pallas`): framing, the symmetric Hann window, the rDFT and
the magnitude, in one launch.  Reference semantics (reference
dataset.py:122-135): frame i starts at sample i * hop, no centering, samples
past N are zero, T defaults to 1 + N // hop.  The on-device data generator
(`data/device_synthetic.py`) runs it once per generated batch; the serving
path keeps `ops/stft.py`'s matmul DFT, as the JAX `Separator` keeps the XLA
STFT.

Two routes on the card, chosen by shape (not a fallback: an error in either
raises):
  - n_fft in [2, 4096], at any hop and any number of signals:
    `stft_fft.cu`, an FFT in shared memory.  An even n_fft transforms
    L = n_fft / 2 points (two samples packed into one complex value, then
    the real split step), an odd one L = n_fft points (two frames packed
    into one complex sequence, then separated).  A 7-smooth L takes a
    Stockham FFT of radices 2, 3, 4, 5, 7 and 8; any other L takes
    Bluestein's chirp-z transform through a power-of-two FFT of
    P >= 2L - 1 points.  Launches count under `stft_mag_fwd`.
  - n_fft above 4096, at any hop and any number of signals: `stft_mag.cu`,
    the matrix DFT against windowed cos/sin bases, 32 frames a block
    (`dft_plan`); launches count under `stft_mag_dft_fwd`.
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
from av_separation_torch.ops.stft import (dft_basis, hann_symmetric,
                                          stft_magnitude)

TILE_FRAMES = 32            # frames per block of the DFT route (stft_mag.cu)
MAX_SMEM_BYTES = 232448     # shared memory a block may use (H100)
DFT_STATIC_SMEM = 32 * 12   # stft_mag.cu's per-frame offsets and lengths
STAGE_STRIDE = 33           # its (bin, frame) stage's row stride
MAX_GRID_X = 2 ** 31 - 1
# A block's share of an SM's 233,472 bytes (less 1 KB a block) when four,
# two or one blocks reside on it (H100).
SMEM_SHARES = (57344, 115712, MAX_SMEM_BYTES)
FFT_SIZES = (2, 4096)       # n_fft the FFT route takes; above, the DFT's
FFT_TILES = (8, 4, 2, 1)    # frames a block of the FFT route
MAX_STAGES = 12             # kMaxStages in stft_fft.cu
STAGE_TABLE_BYTES = 20 * MAX_STAGES  # its static shared Stage table


def stft_magnitude_fwd_torch(audio: torch.Tensor, n_fft: int, hop: int,
                             num_frames: int | None = None) -> torch.Tensor:
    """Plain version: `ops/stft.stft_magnitude`, (..., N) -> (..., F, T)."""
    return stft_magnitude(audio, n_fft, hop, num_frames)


class FftPlan(NamedTuple):
    """What the FFT route runs for one n_fft."""
    length: int                # L: the complex transform's length
    radices: Tuple[int, ...]   # the Stockham stages, over L or over `pad`
    pad: int                   # Bluestein's P (2^k >= 2L - 1), else 0


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


def fft_plan(n_fft: int) -> FftPlan:
    """The FFT route's transform of one n_fft: L = n_fft / 2 (even) or
    n_fft (odd); L's own radices when it is 7-smooth, else Bluestein over
    the power of two P >= 2L - 1 (n_fft 448: L 224, radices 2, 4, 4, 7;
    514: L 257, P 1024)."""
    length = n_fft // 2 if n_fft % 2 == 0 else n_fft
    plan = radices(length)
    if plan is not None:
        return FftPlan(length, plan, 0)
    pad = 1 << (2 * length - 2).bit_length()
    return FftPlan(length, radices(pad), pad)


def route(n_fft: int) -> str:
    """'fft' for n_fft in [2, 4096], 'dft' above (and below, where no
    route serves it and the checks raise)."""
    lo, hi = FFT_SIZES
    return "fft" if lo <= n_fft <= hi else "dft"


def launch_shape(n_fft: int) -> Tuple[int, int]:
    """DFT route: (threads per block, padded bin count): one bin per thread,
    at most 4 warps a block, the bins split evenly over ceil(warps / 4)
    blocks."""
    warps = -(-(n_fft // 2 + 1) // 32)
    groups = -(-warps // 4)
    threads = 32 * -(-warps // groups)
    return threads, groups * threads


class DftPlan(NamedTuple):
    """How the DFT route (`stft_mag.cu`) runs one call."""
    kind: str                # "staged_vec", "staged" or "global"
    threads: int             # bins a block, one a thread
    f_pad: int               # bins padded to a multiple of `threads`
    grid: Tuple[int, int]    # (tiles of 32 frames, bin groups)
    smem_bytes: int          # dynamic shared memory a block


DFT_KINDS = ("staged_vec", "staged", "global")  # stft_mag.cu's KIND order


def dft_plan(n_fft: int, hop: int, signals: int, num_frames: int) -> DftPlan:
    """The DFT route's launch.  A signal of at least 32 frames whose
    32-frame span, 31 hop + n_fft samples, fits in shared memory stages
    that span (four samples a load where n_fft and hop are multiples of 4):
    a block is 32 frames of one signal.  Otherwise a block reads 32
    consecutive frames of the flattened (signal, frame) index from global
    memory (a large hop, or fewer than 32 frames a signal: n_fft 4098 at
    one frame over 66,000 signals).  Signals fold into grid x."""
    if n_fft < 2 or hop < 1 or signals < 1 or num_frames < 1:
        raise ValueError(f"no DFT launch for n_fft {n_fft}, hop {hop}, "
                         f"{signals} signals of {num_frames} frames")
    threads, f_pad = launch_shape(n_fft)
    stage = threads * STAGE_STRIDE
    span = (TILE_FRAMES - 1) * hop + n_fft
    if num_frames >= TILE_FRAMES and \
            4 * max(span, stage) + DFT_STATIC_SMEM <= MAX_SMEM_BYTES:
        kind = "staged" if n_fft % 4 or hop % 4 else "staged_vec"
        floats = max(span, stage)
        blocks = signals * -(-num_frames // TILE_FRAMES)
    else:
        kind, floats = "global", stage
        blocks = -(-signals * num_frames // TILE_FRAMES)
    if blocks > MAX_GRID_X:
        raise ValueError(f"{blocks} blocks of {TILE_FRAMES} frames exceed "
                         f"the grid's {MAX_GRID_X}")
    return DftPlan(kind, threads, f_pad, (blocks, f_pad // threads),
                   4 * floats)


def fft_sequences(n_fft: int, tile: int) -> int:
    """Complex sequences of one FFT block: one a frame (even n_fft), one a
    pair of frames (odd)."""
    return (tile + 1) // 2 if n_fft % 2 else tile


def fft_region_floats(n_fft: int, hop: int, tile: int) -> int:
    """Floats of each of the FFT block's two work regions
    (`region_floats` in stft_fft.cu): the staged span, the sequences of
    the FFT's ping-pong and the (bin, frame) stage all fit; rounded up to
    4 so the next region stays 16-byte aligned."""
    plan = fft_plan(n_fft)
    f = n_fft // 2 + 1
    r = max(2 * fft_sequences(n_fft, tile) * (plan.pad or plan.length),
            (tile - 1) * hop + n_fft, f * (tile + 1))
    return -(-r // 4) * 4


def fft_smem_bytes(n_fft: int, hop: int, tile: int) -> int:
    """Shared memory of one FFT block (`smem_bytes` in stft_fft.cu plus
    the static stage table): two work regions, the FFT's twiddle table,
    the split step's (even n_fft under Bluestein; otherwise it is the
    twiddle table), the window."""
    plan = fft_plan(n_fft)
    half = plan.pad // 2 if plan.pad else plan.length
    split = n_fft // 2 + 1 if plan.pad and n_fft % 2 == 0 else 0
    return (4 * 2 * fft_region_floats(n_fft, hop, tile)
            + 8 * (half + 1 + split) + 4 * n_fft + STAGE_TABLE_BYTES)


def fft_tile_frames(n_fft: int, hop: int, signals: int, num_frames: int,
                    sm_count: int) -> int:
    """Frames a block of the FFT route, a power of two <= 8.  Among the
    tiles whose blocks let four share an SM (else two, else one), the
    largest whose grid gives every SM at least two blocks, or the smallest
    (for an odd n_fft, whose sequence holds two frames, 2 rather than 1).
    On an H100 (`tools/torch_stft_sweep.py tiles`) four resident blocks
    beat larger tiles at n_fft 1102, 514 and 401, and 8 frames beat 16 at
    512.  One frame fits at every n_fft in [2, 4096] and every hop."""
    for share in SMEM_SHARES:
        tiles = [t for t in FFT_TILES
                 if fft_smem_bytes(n_fft, hop, t) <= share]
        if n_fft % 2 and 2 in tiles:
            tiles.remove(1)
        for t in tiles:
            if signals * -(-num_frames // t) >= 2 * sm_count:
                return t
        if tiles:
            return tiles[-1]
    raise ValueError(f"no FFT tile fits shared memory at n_fft {n_fft}")


@functools.lru_cache(maxsize=8)
def _bases(n_fft: int, device: torch.device
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DFT route: the windowed bases (n_fft, F_pad) on `device`, zero past
    column F."""
    _, f_pad = launch_shape(n_fft)
    cos_np, sin_np = dft_basis(n_fft)
    pad = ((0, 0), (0, f_pad - cos_np.shape[1]))
    return (torch.as_tensor(np.pad(cos_np, pad), device=device),
            torch.as_tensor(np.pad(sin_np, pad), device=device))


class FftTables(NamedTuple):
    """The FFT route's constant tables, float32, each computed in float64
    (complex values as (re, im) rows)."""
    window: np.ndarray     # (n_fft,) the symmetric Hann window
    twiddle: np.ndarray    # (h + 1, 2) exp(-2 pi i j / 2h), h = L, or P / 2
    split: np.ndarray      # (n_fft/2 + 1, 2) exp(-2 pi i k / n_fft): even
    #                        n_fft (the twiddle table itself when L is
    #                        planned); empty for odd n_fft
    chirp: np.ndarray      # (L, 2) exp(-i pi (n^2 mod 2L) / L): Bluestein
    chirp_fft: np.ndarray  # (P, 2) P-point FFT of exp(i pi m^2 / L) over
    #                        |m| < L (circular), divided by P: Bluestein


def _unit(phase_num: np.ndarray, phase_den: int) -> np.ndarray:
    """exp(-2 pi i num / den) as float32 (re, im) rows, from float64."""
    ang = -2.0 * np.pi * phase_num.astype(np.float64) / phase_den
    return np.ascontiguousarray(
        np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32))


def fft_tables(n_fft: int) -> FftTables:
    """The tables of one n_fft (see `FftTables`).  Bluestein's chirp phase
    n^2 mod 2L is taken in integers, so no angle grows with n."""
    plan = fft_plan(n_fft)
    length, pad = plan.length, plan.pad
    half = pad // 2 if pad else length
    twiddle = _unit(np.arange(half + 1), 2 * half)
    empty = np.zeros((0, 2), np.float32)
    if n_fft % 2:
        split = empty
    elif pad:
        split = _unit(np.arange(n_fft // 2 + 1), n_fft)
    else:
        split = twiddle
    chirp, chirp_fft = empty, empty
    if pad:
        n = np.arange(length, dtype=np.int64)
        sq = (n * n) % (2 * length)
        chirp = _unit(sq, 2 * length)               # exp(-i pi n^2 / L)
        c = np.exp(1j * np.pi * sq / length)        # exp(+i pi n^2 / L)
        b = np.zeros(pad, np.complex128)
        b[:length] = c
        b[pad - length + 1:] = c[1:][::-1]
        spec = np.fft.fft(b) / pad
        chirp_fft = np.ascontiguousarray(
            np.stack([spec.real, spec.imag], axis=1).astype(np.float32))
    return FftTables(hann_symmetric(n_fft).astype(np.float32), twiddle,
                     split, chirp, chirp_fft)


@functools.lru_cache(maxsize=8)
def _fft_tables(n_fft: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(t, device=device) for t in fft_tables(n_fft))


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("stft_mag")
    fn = lib.avsep_stft_mag_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _fft_entry():
    lib = _build.load("stft_fft")
    fn = lib.avsep_stft_fft_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(audio: torch.Tensor, n_fft: int, hop: int, num_frames: int,
           kind: str = "dft") -> None:
    """The kernels' input checks; `kind` names the route ('dft' or 'fft')
    whose own limits are checked."""
    if audio.dtype != torch.float32:
        raise ValueError(f"audio must be float32, got {audio.dtype}")
    if not audio.is_contiguous():
        raise ValueError("audio must be contiguous")
    if audio.dim() < 1 or audio.shape[-1] < 1:
        raise ValueError(f"audio must be (..., N), got {tuple(audio.shape)}")
    if hop < 1:
        raise ValueError(f"hop {hop} must be positive")
    if num_frames < 1:
        raise ValueError(f"num_frames {num_frames} must be positive")
    if kind == "fft":
        lo, hi = FFT_SIZES
        if not lo <= n_fft <= hi:
            raise ValueError(f"n_fft {n_fft} is outside the FFT route's "
                             f"[{lo}, {hi}]")
        return
    if n_fft < 2:
        raise ValueError(f"n_fft {n_fft} must be at least 2")
    signals = math.prod(audio.shape[:-1])
    if signals:
        dft_plan(n_fft, hop, signals, num_frames)


def stft_magnitude_fwd(audio: torch.Tensor, n_fft: int, hop: int,
                       num_frames: int | None = None) -> torch.Tensor:
    """|STFT| of (..., N) float32 audio -> (..., n_fft // 2 + 1, T).

    CPU tensors take the plain version; CUDA tensors launch the FFT kernel
    for n_fft in [2, 4096] and the matrix-DFT kernel above.
    """
    if audio.device.type == "cpu":
        return stft_magnitude_fwd_torch(audio, n_fft, hop, num_frames)
    if audio.device.type != "cuda":
        raise ValueError(f"unsupported device {audio.device}")
    n = audio.shape[-1]
    if num_frames is None:
        num_frames = 1 + n // hop
    kind = route(n_fft)
    _check(audio, n_fft, hop, num_frames, kind)
    lead = audio.shape[:-1]
    b = math.prod(lead)
    freq_bins = n_fft // 2 + 1
    out = torch.empty((b, freq_bins, num_frames), dtype=torch.float32,
                      device=audio.device)
    if b == 0:
        return out.reshape(*lead, freq_bins, num_frames)
    index = audio.device.index
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    if kind == "fft":
        tables = _fft_tables(n_fft, audio.device)
        tile = fft_tile_frames(n_fft, hop, b, num_frames, _sm_count(index))
        vec = int(hop % 4 == 0 and n % 4 == 0
                  and audio.data_ptr() % 16 == 0)
        plan = fft_plan(n_fft)
        lib, fn = _fft_entry()
        rc = fn(audio.data_ptr(), *(t.data_ptr() for t in tables),
                out.data_ptr(), b, n, num_frames, n_fft, hop, tile, vec,
                (ctypes.c_int * len(plan.radices))(*plan.radices),
                len(plan.radices), plan.pad, index, stream)
        _build.check(lib, rc, "stft_mag_fwd")
        kernels.LAUNCHES["stft_mag_fwd"] += 1
    else:
        plan = dft_plan(n_fft, hop, b, num_frames)
        cos_b, sin_b = _bases(n_fft, audio.device)
        lib, fn = _entry()
        rc = fn(audio.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
                out.data_ptr(), b, n, num_frames, n_fft, hop, freq_bins,
                plan.f_pad, plan.threads, DFT_KINDS.index(plan.kind), index,
                stream)
        _build.check(lib, rc, "stft_mag_dft_fwd")
        kernels.LAUNCHES["stft_mag_dft_fwd"] += 1
    return out.reshape(*lead, freq_bins, num_frames)
