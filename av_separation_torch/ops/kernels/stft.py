"""Fused STFT magnitude: the CUDA kernel `csrc/stft_mag.cu` and its plain
PyTorch version.

Port of `av_separation_tpu/ops/pallas/stft.py` (`_stft_kernel`, called from
`stft_magnitude_pallas`): framing, the symmetric Hann window, the rDFT as
two float32 products against windowed cos/sin bases, and the magnitude, in
one launch.  Reference semantics (reference dataset.py:122-135): frame i
starts at sample i * hop, no centering, samples past N are zero, T defaults
to 1 + N // hop.  The on-device data generator (`data/device_synthetic.py`)
runs it once per generated batch; the serving path keeps `ops/stft.py`'s
matmul DFT, as the JAX `Separator` keeps the XLA STFT.
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
from av_separation_torch.ops.stft import dft_basis, stft_magnitude

TILE_FRAMES = 32            # frames per block (csrc/stft_mag.cu kTile)
MAX_SMEM_BYTES = 232448     # dynamic shared memory a block may use (H100)


def stft_magnitude_fwd_torch(audio: torch.Tensor, n_fft: int, hop: int,
                             num_frames: int | None = None) -> torch.Tensor:
    """Plain version: `ops/stft.stft_magnitude`, (..., N) -> (..., F, T)."""
    return stft_magnitude(audio, n_fft, hop, num_frames)


def launch_shape(n_fft: int) -> Tuple[int, int]:
    """(threads per block, padded bin count): one bin per thread, at most
    4 warps a block, the bins split evenly over ceil(warps / 4) blocks."""
    warps = -(-(n_fft // 2 + 1) // 32)
    groups = -(-warps // 4)
    threads = 32 * -(-warps // groups)
    return threads, groups * threads


@functools.lru_cache(maxsize=8)
def _bases(n_fft: int, device: torch.device
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The windowed bases (n_fft, F_pad) on `device`, zero past column F."""
    _, f_pad = launch_shape(n_fft)
    cos_np, sin_np = dft_basis(n_fft)
    pad = ((0, 0), (0, f_pad - cos_np.shape[1]))
    return (torch.as_tensor(np.pad(cos_np, pad), device=device),
            torch.as_tensor(np.pad(sin_np, pad), device=device))


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("stft_mag")
    fn = lib.avsep_stft_mag_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(audio: torch.Tensor, n_fft: int, hop: int, num_frames: int) -> None:
    if audio.dtype != torch.float32:
        raise ValueError(f"audio must be float32, got {audio.dtype}")
    if not audio.is_contiguous():
        raise ValueError("audio must be contiguous")
    if audio.dim() < 1 or audio.shape[-1] < 1:
        raise ValueError(f"audio must be (..., N), got {tuple(audio.shape)}")
    # float4 broadcasts of frame samples need both to be multiples of 4.
    if n_fft % 4 or n_fft < 4:
        raise ValueError(f"n_fft {n_fft} must be a positive multiple of 4")
    if hop % 4 or hop < 4:
        raise ValueError(f"hop {hop} must be a positive multiple of 4")
    if 4 * ((TILE_FRAMES - 1) * hop + n_fft) > MAX_SMEM_BYTES:
        raise ValueError(f"a tile of {TILE_FRAMES} frames at hop {hop} and "
                         f"n_fft {n_fft} does not fit in shared memory")
    if num_frames < 1:
        raise ValueError(f"num_frames {num_frames} must be positive")


def stft_magnitude_fwd(audio: torch.Tensor, n_fft: int, hop: int,
                       num_frames: int | None = None) -> torch.Tensor:
    """|STFT| of (..., N) float32 audio -> (..., n_fft // 2 + 1, T).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
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
    threads, f_pad = launch_shape(n_fft)
    cos_b, sin_b = _bases(n_fft, audio.device)
    out = torch.empty((b, freq_bins, num_frames), dtype=torch.float32,
                      device=audio.device)
    if b == 0:
        return out.reshape(*lead, freq_bins, num_frames)
    lib, fn = _entry()
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    rc = fn(audio.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
            out.data_ptr(), b, n, num_frames, n_fft, hop, freq_bins, f_pad,
            threads, audio.device.index, stream)
    _build.check(lib, rc, "stft_mag_fwd")
    kernels.LAUNCHES["stft_mag_fwd"] += 1
    return out.reshape(*lead, freq_bins, num_frames)
