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
  - n_fft a multiple of 4 in [8, 4096] whose half has no prime factor above
    5 (every config: 512; the speech front ends' 400): `stft_fft.cu`, a
    half-length mixed-radix complex FFT in shared memory plus the real
    split step; launches count under `stft_mag_fwd`.
  - any other n_fft (a multiple of 4, such as 448): `stft_mag.cu`, the
    matrix DFT against windowed cos/sin bases; launches count under
    `stft_mag_dft_fwd`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from av_separation_torch.ops import kernels
from av_separation_torch.ops.kernels import _build
from av_separation_torch.ops.stft import (dft_basis, hann_symmetric,
                                          stft_magnitude)

TILE_FRAMES = 32            # frames per block of the DFT route (stft_mag.cu)
MAX_SMEM_BYTES = 232448     # dynamic shared memory a block may use (H100)
FFT_SIZES = (8, 4096)       # n_fft the FFT route takes
MAX_GRID_Y = 65535          # signals: the FFT route's grid.y


def stft_magnitude_fwd_torch(audio: torch.Tensor, n_fft: int, hop: int,
                             num_frames: int | None = None) -> torch.Tensor:
    """Plain version: `ops/stft.stft_magnitude`, (..., N) -> (..., F, T)."""
    return stft_magnitude(audio, n_fft, hop, num_frames)


def fft_plan(n_fft: int) -> Tuple[int, ...]:
    """The radices of the FFT route's Stockham stages over M = n_fft / 2
    points: one 2 when M's power of two has an odd exponent, then 4s, 3s
    and 5s (M = 256: 4, 4, 4, 4; M = 200: 2, 4, 5, 5).  Empty when M has
    another prime factor."""
    m, twos = n_fft // 2, 0
    while m > 1 and m % 2 == 0:
        m //= 2
        twos += 1
    plan = [2] * (twos % 2) + [4] * (twos // 2)
    for r in (3, 5):
        while m % r == 0:
            m //= r
            plan.append(r)
    return tuple(plan) if m == 1 else ()


def route(n_fft: int) -> str:
    """'fft' for a multiple of 4 in [8, 4096] whose half has no prime
    factor above 5, else 'dft'."""
    lo, hi = FFT_SIZES
    ok = lo <= n_fft <= hi and n_fft % 4 == 0 and fft_plan(n_fft)
    return "fft" if ok else "dft"


def launch_shape(n_fft: int) -> Tuple[int, int]:
    """DFT route: (threads per block, padded bin count): one bin per thread,
    at most 4 warps a block, the bins split evenly over ceil(warps / 4)
    blocks."""
    warps = -(-(n_fft // 2 + 1) // 32)
    groups = -(-warps // 4)
    threads = 32 * -(-warps // groups)
    return threads, groups * threads


def fft_smem_bytes(n_fft: int, hop: int, tile: int) -> int:
    """Shared memory of one FFT block (`smem_bytes` in stft_fft.cu): two
    work regions that each hold the staged span, tile frames of n_fft/2
    complex values and the (bin, frame) stage, then the twiddles and the
    window."""
    f = n_fft // 2 + 1
    r = max(n_fft * tile, (tile - 1) * hop + n_fft, f * (tile + 1))
    r = -(-r // 4) * 4
    return 4 * (2 * r + 2 * f + n_fft)


def fft_tile_frames(n_fft: int, hop: int, signals: int, num_frames: int,
                    sm_count: int) -> int:
    """Frames a block of the FFT route: the largest power of two <= 8
    whose block fits shared memory and whose grid gives every SM at least
    two blocks; if none does, the smallest that fits.  (At the scaled
    device batch, 8 frames a block ran faster than 16 on an H100.)"""
    # One frame always fits: at n_fft 4096 its block takes 65.5 KB.
    fits = [t for t in (8, 4, 2, 1)
            if fft_smem_bytes(n_fft, hop, t) <= MAX_SMEM_BYTES]
    for t in fits:
        if signals * -(-num_frames // t) >= 2 * sm_count:
            return t
    return fits[-1]


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


def fft_tables(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """FFT route: the float32 window (n_fft,) and twiddles (n_fft/2 + 1, 2)
    = exp(-2 pi i k / n_fft) as (re, im), both computed in float64."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    ang = -2.0 * np.pi * k / n_fft
    twiddle = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    return (hann_symmetric(n_fft).astype(np.float32),
            np.ascontiguousarray(twiddle.astype(np.float32)))


@functools.lru_cache(maxsize=8)
def _fft_tables(n_fft: int, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    window, twiddle = fft_tables(n_fft)
    return (torch.as_tensor(window, device=device),
            torch.as_tensor(twiddle, device=device))


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("stft_mag")
    fn = lib.avsep_stft_mag_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _fft_entry():
    lib = _build.load("stft_fft")
    fn = lib.avsep_stft_fft_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 2 \
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
    # float4 broadcasts of frame samples (DFT) and 16-byte copies of the
    # span (FFT) need both to be multiples of 4.
    if n_fft % 4 or n_fft < 4:
        raise ValueError(f"n_fft {n_fft} must be a positive multiple of 4")
    if hop % 4 or hop < 4:
        raise ValueError(f"hop {hop} must be a positive multiple of 4")
    if num_frames < 1:
        raise ValueError(f"num_frames {num_frames} must be positive")
    if kind == "dft":
        if 4 * ((TILE_FRAMES - 1) * hop + n_fft) > MAX_SMEM_BYTES:
            raise ValueError(f"a tile of {TILE_FRAMES} frames at hop {hop} "
                             f"and n_fft {n_fft} does not fit in shared "
                             f"memory")
    elif route(n_fft) != "fft":
        raise ValueError(f"n_fft {n_fft} is not in {FFT_SIZES} with a half "
                         f"whose prime factors are 2, 3 and 5")
    elif math.prod(audio.shape[:-1]) > MAX_GRID_Y:
        raise ValueError(f"more than {MAX_GRID_Y} signals")


def stft_magnitude_fwd(audio: torch.Tensor, n_fft: int, hop: int,
                       num_frames: int | None = None) -> torch.Tensor:
    """|STFT| of (..., N) float32 audio -> (..., n_fft // 2 + 1, T).

    CPU tensors take the plain version; CUDA tensors launch the FFT kernel
    where `route` says 'fft' and the matrix-DFT kernel for any other n_fft.
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
        window, twiddle = _fft_tables(n_fft, audio.device)
        tile = fft_tile_frames(n_fft, hop, b, num_frames, _sm_count(index))
        vec = int(n % 4 == 0 and audio.data_ptr() % 16 == 0)
        plan = fft_plan(n_fft)
        lib, fn = _fft_entry()
        rc = fn(audio.data_ptr(), window.data_ptr(), twiddle.data_ptr(),
                out.data_ptr(), b, n, num_frames, n_fft, hop, tile, vec,
                (ctypes.c_int * len(plan))(*plan), len(plan), index, stream)
        _build.check(lib, rc, "stft_mag_fwd")
        kernels.LAUNCHES["stft_mag_fwd"] += 1
    else:
        threads, f_pad = launch_shape(n_fft)
        cos_b, sin_b = _bases(n_fft, audio.device)
        lib, fn = _entry()
        rc = fn(audio.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
                out.data_ptr(), b, n, num_frames, n_fft, hop, freq_bins,
                f_pad, threads, index, stream)
        _build.check(lib, rc, "stft_mag_dft_fwd")
        kernels.LAUNCHES["stft_mag_dft_fwd"] += 1
    return out.reshape(*lead, freq_bins, num_frames)
