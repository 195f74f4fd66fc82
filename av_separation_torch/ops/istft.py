"""Audio-domain reconstruction: masked iSTFT and waveform SI-SNR (port of
`av_separation_tpu/ops/istft.py`).

  - ``istft_overlap_add``: least-squares inverse STFT (Griffin & Lim
    LSEE-MSTFT): matmul-irDFT per frame, synthesis window = analysis window,
    overlap-add by `index_add_`, divided by the summed squared window.
  - ``masked_istft``: per-speaker waveforms from soft masks applied to the
    complex mixture STFT (masked magnitude with the mixture's phase).
  - ``si_snr_waveform``: zero-mean, scale-projected waveform SI-SNR in dB;
    ``permutation_si_snr_waveform`` its best-permutation mean per sample.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from av_separation_torch.losses import permutation_table
from av_separation_torch.ops.stft import hann_symmetric, stft_complex


@functools.lru_cache(maxsize=8)
def irdft_basis(n_fft: int):
    """Inverse-rDFT bases (freq_bins, n_fft), float32 NumPy.

    x[n] = sum_k c_k/N (Re X_k cos(2 pi k n / N) - Im X_k sin(2 pi k n / N)),
    c_k = 1 for k in {0, N/2}, else 2.
    """
    freq_bins = n_fft // 2 + 1
    k = np.arange(freq_bins)[:, None].astype(np.float64)
    n = np.arange(n_fft)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * k * n / n_fft
    coef = np.full((freq_bins, 1), 2.0 / n_fft)
    coef[0, 0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        coef[-1, 0] = 1.0 / n_fft
    return ((coef * np.cos(ang)).astype(np.float32),
            (-coef * np.sin(ang)).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _ola_window_norm(n_fft: int, hop: int, num_frames: int,
                     out_len: int, eps: float = 1e-12) -> np.ndarray:
    """Summed squared synthesis window over the overlap-add span (out_len,)."""
    w2 = hann_symmetric(n_fft) ** 2
    total = (num_frames - 1) * hop + n_fft
    acc = np.zeros(total, dtype=np.float64)
    for i in range(num_frames):
        acc[i * hop:i * hop + n_fft] += w2
    return np.maximum(acc[:out_len], eps).astype(np.float32)


def istft_overlap_add(re: torch.Tensor, im: torch.Tensor, n_fft: int,
                      hop: int, num_audio: int) -> torch.Tensor:
    """Least-squares iSTFT: (..., F, T) complex parts -> (..., num_audio)."""
    num_frames = re.shape[-1]
    dev = re.device
    cos_np, sin_np = irdft_basis(n_fft)
    frames = (torch.matmul(re.transpose(-1, -2),
                           torch.as_tensor(cos_np, device=dev))
              + torch.matmul(im.transpose(-1, -2),
                             torch.as_tensor(sin_np, device=dev)))
    frames = frames * torch.as_tensor(hann_symmetric(n_fft),
                                      dtype=frames.dtype, device=dev)
    total = (num_frames - 1) * hop + n_fft
    idx = (np.arange(num_frames)[:, None] * hop
           + np.arange(n_fft)[None, :]).reshape(-1)
    lead = frames.shape[:-2]
    out = torch.zeros(lead + (total,), dtype=frames.dtype, device=dev)
    out.index_add_(-1, torch.as_tensor(idx, device=dev),
                   frames.reshape(lead + (-1,)))
    norm = torch.as_tensor(
        _ola_window_norm(n_fft, hop, num_frames, num_audio), device=dev)
    return out[..., :num_audio] / norm


def masked_istft(masks: torch.Tensor, mixed_audio: torch.Tensor, n_fft: int,
                 hop: int) -> torch.Tensor:
    """Soft masks (B, S, F, T) + mixture (B, N) -> waveforms (B, S, N).

    The mask scales the complex mixture bins: masked magnitude with the
    mixture's phase.
    """
    re, im = stft_complex(mixed_audio, n_fft, hop, masks.shape[-1])
    return istft_overlap_add(masks * re[:, None], masks * im[:, None],
                             n_fft, hop, mixed_audio.shape[-1])


def si_snr_waveform(estimate: torch.Tensor, target: torch.Tensor,
                    eps: float = 1e-8) -> torch.Tensor:
    """Waveform-domain scale-invariant SNR in dB over the last axis."""
    estimate = estimate - estimate.mean(dim=-1, keepdim=True)
    target = target - target.mean(dim=-1, keepdim=True)
    dot = (estimate * target).sum(dim=-1, keepdim=True)
    energy = (target * target).sum(dim=-1, keepdim=True)
    proj = dot / (energy + eps) * target
    noise = estimate - proj
    ratio = (proj * proj).sum(dim=-1) / ((noise * noise).sum(dim=-1) + eps)
    return 10.0 * torch.log10(ratio + eps)


def permutation_si_snr_waveform(estimates: torch.Tensor,
                                targets: torch.Tensor) -> torch.Tensor:
    """Best-permutation mean waveform SI-SNR per sample: (B, S, N) x
    (B, S, N) -> (B,), the waveform analogue of
    `utils.metrics.permutation_snr`."""
    per_perm = [si_snr_waveform(estimates[:, list(perm)], targets)
                .mean(dim=-1) for perm in permutation_table(estimates.shape[1])]
    return torch.stack(per_perm).max(dim=0).values
