"""STFT magnitude front-end as a windowed matmul-DFT (port of
`av_separation_tpu/ops/stft.py`).

Reference semantics (reference dataset.py:122-135): a symmetric Hann window
(`np.hanning`), frames at ``i * hop`` with no centering, the tail zero-padded,
the magnitude of the rDFT, laid out (..., freq_bins, T).  The DFT is two
float32 matmuls against cos/sin bases built in float64.  On the card they run
in full float32 as long as `torch.backends.cuda.matmul.allow_tf32` stays
False, its default.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hann_symmetric(n_fft: int) -> np.ndarray:
    """Symmetric Hann window, exactly `np.hanning(n_fft)` (denominator
    n_fft - 1, not torch.stft's periodic window)."""
    n = np.arange(n_fft)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (n_fft - 1))).astype(np.float64)


@functools.lru_cache(maxsize=8)
def dft_basis(n_fft: int):
    """Windowed rDFT bases (n_fft, freq_bins) as float32 NumPy arrays."""
    freq_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None].astype(np.float64)
    k = np.arange(freq_bins)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * n * k / n_fft
    w = hann_symmetric(n_fft)[:, None]
    return ((w * np.cos(ang)).astype(np.float32),
            (w * -np.sin(ang)).astype(np.float32))


def frame_signal(audio: torch.Tensor, n_fft: int, hop: int,
                 num_frames: int) -> torch.Tensor:
    """(..., N) -> (..., num_frames, n_fft): frame i = audio[i*hop : i*hop +
    n_fft], zero-padded past the end.  The frames are a strided view of the
    padded signal."""
    pad = max(0, (num_frames - 1) * hop + n_fft - audio.shape[-1])
    padded = torch.nn.functional.pad(audio, (0, pad))
    return padded.unfold(-1, n_fft, hop)[..., :num_frames, :]


def stft_complex(audio: torch.Tensor, n_fft: int, hop: int,
                 num_frames: int | None = None):
    """Reference-semantics complex STFT -> (re, im), each (..., F, T)."""
    if num_frames is None:
        num_frames = 1 + audio.shape[-1] // hop
    frames = frame_signal(audio.float(), n_fft, hop, num_frames)
    cos_np, sin_np = dft_basis(n_fft)
    cos_b = torch.as_tensor(cos_np, device=audio.device)
    sin_b = torch.as_tensor(sin_np, device=audio.device)
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    return re.transpose(-1, -2), im.transpose(-1, -2)


def stft_magnitude(audio: torch.Tensor, n_fft: int, hop: int,
                   num_frames: int | None = None) -> torch.Tensor:
    """(..., N) float -> (..., freq_bins, T) float32, T = 1 + N // hop."""
    re, im = stft_complex(audio, n_fft, hop, num_frames)
    return torch.sqrt(re * re + im * im)
