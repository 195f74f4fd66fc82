"""Host-side synthetic audio-visual dataset, bit-matching the reference.

A NumPy-only copy of `av_separation_tpu/data/synthetic.py` (which this
package may not import): per-index `np.random.default_rng(idx)`, the same
draw order (amplitudes, then per speaker a frequency jitter and a phase, then
per speaker per video frame one lip-noise draw), the reference's
float32-rounded hand-rolled STFT, and lip brightness from window energy.
`dataset[idx]` is bit-identical to `tests/golden/golden_dataset.npz`.

`clean_audios` also supplies the per-speaker waveforms whose sum the serving
path separates.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from av_separation_torch.config import DataConfig


def stft_magnitude_np(audio: np.ndarray, n_fft: int, hop: int,
                      num_frames: int) -> np.ndarray:
    """Reference-semantics STFT magnitude, vectorized.  (N,) -> (F, T)."""
    window = np.hanning(n_fft)
    pad = max(0, (num_frames - 1) * hop + n_fft - audio.shape[-1])
    padded = np.concatenate([audio, np.zeros(pad, dtype=np.float32)])
    idx = np.arange(num_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    # The reference windows each frame in place on a float32 buffer, so the
    # windowed frame is rounded to float32 before the rfft.
    frames = (padded[idx] * window).astype(np.float32)  # (T, n_fft)
    spec = np.abs(np.fft.rfft(frames, axis=-1))  # (T, F)
    return spec.T.astype(np.float32)  # (F, T)


class SyntheticAVDataset:
    """Synthetic AV separation dataset; samples bit-match the reference.

    Each sample is a dict of NumPy arrays:
        mixed_spec  : (freq_bins, T) float32
        lip_frames  : (num_speakers * num_frames, H, W) float32
        clean_specs : (num_speakers, freq_bins, T) float32
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.t_axis = np.linspace(0.0, cfg.duration, cfg.num_samples_audio,
                                  endpoint=False)

    def __len__(self) -> int:
        return self.cfg.num_samples

    def clean_audios(self, idx: int) -> tuple[np.ndarray, np.random.Generator]:
        """Per-speaker clean waveforms (S, N) float32 for sample `idx`, and
        the RNG positioned for the lip-noise draws."""
        cfg = self.cfg
        rng = np.random.default_rng(idx)
        amps = rng.uniform(0.3, 1.0, size=cfg.num_speakers)
        audios = np.empty((cfg.num_speakers, cfg.num_samples_audio),
                          dtype=np.float32)
        for i, (freq, amp) in enumerate(zip(cfg.speaker_freqs, amps)):
            jittered = freq * rng.uniform(0.95, 1.05)
            phase = rng.uniform(0.0, 2.0 * math.pi)
            audios[i] = (amp * np.sin(2.0 * math.pi * jittered * self.t_axis
                                      + phase)).astype(np.float32)
        return audios, rng

    def lip_stream(self, audios: np.ndarray,
                   rng: np.random.Generator) -> np.ndarray:
        """(S, N) waveforms -> (S * num_frames, H, W) lip frames."""
        cfg = self.cfg
        step = cfg.num_samples_audio // cfg.num_frames
        h0, h1 = cfg.frame_h // 4, 3 * cfg.frame_h // 4
        w0, w1 = cfg.frame_w // 4, 3 * cfg.frame_w // 4
        out = np.zeros((cfg.num_speakers * cfg.num_frames,
                        cfg.frame_h, cfg.frame_w), dtype=np.float32)
        for s in range(cfg.num_speakers):
            wave = audios[s]
            for fi in range(cfg.num_frames):
                seg = wave[fi * step:min((fi + 1) * step,
                                         cfg.num_samples_audio)]
                energy = float(np.mean(seg ** 2))
                brightness = min(1.0, energy * 20.0)
                noise = rng.normal(0.0, 0.05,
                                   (h1 - h0, w1 - w0)).astype(np.float32)
                out[s * cfg.num_frames + fi, h0:h1, w0:w1] = np.clip(
                    brightness + noise, 0.0, 1.0)
        return out

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        audios, rng = self.clean_audios(idx)
        mixed = audios.sum(axis=0).astype(np.float32)
        mixed_spec = stft_magnitude_np(mixed, cfg.n_fft, cfg.hop_length,
                                       cfg.num_stft_frames)
        clean_specs = np.stack([
            stft_magnitude_np(audios[s], cfg.n_fft, cfg.hop_length,
                              cfg.num_stft_frames)
            for s in range(cfg.num_speakers)
        ], axis=0)
        lip_frames = self.lip_stream(audios, rng)
        return {
            "mixed_spec": mixed_spec,
            "lip_frames": lip_frames,
            "clean_specs": clean_specs,
        }
