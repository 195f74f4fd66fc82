"""Batched inference (port of `av_separation_tpu/inference.py`).

``Separator`` holds an eval-mode model on one device and serves two APIs:
  - ``separate``: (B, F, T) magnitude + (B, N, H, W) lip frames ->
    (separated, masks), the reference model's contract;
  - ``separate_waveform``: (B, N_audio) raw mixture -> STFT magnitude ->
    model -> masks applied to the complex mixture STFT -> least-squares
    iSTFT -> per-speaker waveforms (B, S, N_audio).
  - ``separate_waveform_streaming``: a mixture of any length through
    fixed-size chunks, each one bucketed waveform forward on the device,
    stitched by a linear cross-fade.
Requests are zero-padded along the batch axis to the next power-of-two
bucket, as in the JAX package; padded rows never mix with real ones and are
sliced off.  ``from_checkpoint`` builds one from the model variables of a
`utils/checkpoint.py` checkpoint.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from av_separation_torch.config import DataConfig, ModelConfig
from av_separation_torch.models.model import (AVSeparationTransformer,
                                              resolve_device)
from av_separation_torch.ops.istft import masked_istft
from av_separation_torch.ops.stft import stft_magnitude


MAX_BUCKET = 256


def bucket_batch(b: int) -> int:
    """Next power-of-two bucket >= b (b > MAX_BUCKET pads to exactly b)."""
    bucket = 1
    while bucket < b and bucket < MAX_BUCKET:
        bucket *= 2
    return max(bucket, b)


class Separator:
    """Serving wrapper around an eval-mode model on one device.

    Parameters
    ----------
    model_cfg  : ModelConfig of the weights.
    state_dict : the model's weights (torch names; see utils/transplant.py).
    data_cfg   : STFT geometry (n_fft, hop) for the waveform API.
    device     : where the model runs; the card unless the caller asks for
                 'cpu'.  Raises when CUDA is asked for and absent.
    """

    def __init__(self, model_cfg: ModelConfig,
                 state_dict: Mapping[str, torch.Tensor],
                 data_cfg: Optional[DataConfig] = None, *,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.data_cfg = data_cfg
        model = AVSeparationTransformer(model_cfg)
        model.load_state_dict(state_dict)
        self.model = model.eval().to(self.device)

    @classmethod
    def from_checkpoint(cls, path: str, model_cfg: ModelConfig,
                        data_cfg: Optional[DataConfig] = None, *,
                        device: torch.device | str = "cuda") -> "Separator":
        """A Separator over the newest checkpoint under `path`."""
        from av_separation_torch.utils.checkpoint import restore_variables
        return cls(model_cfg, restore_variables(path), data_cfg,
                   device=device)

    def _padded(self, x: np.ndarray, bucket: int) -> torch.Tensor:
        x = np.ascontiguousarray(x, np.float32)
        pad = bucket - x.shape[0]
        if pad:
            x = np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
        return torch.from_numpy(x).to(self.device)

    @torch.inference_mode()
    def separate(self, mixed_spec: np.ndarray, lip_frames: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, F, T) magnitude + (B, N, H, W) frames -> (separated, masks)."""
        b = len(mixed_spec)
        bucket = bucket_batch(b)
        separated, masks = self.model(self._padded(mixed_spec, bucket),
                                      self._padded(lip_frames, bucket))
        return separated[:b].cpu().numpy(), masks[:b].cpu().numpy()

    def _wave_forward(self, mixed_audio: np.ndarray, lip_frames: np.ndarray
                      ) -> Tuple[torch.Tensor, ...]:
        """One bucketed waveform forward; (waveforms, masks, mixed_spec) of
        the B real rows, left on the device."""
        n_fft, hop = self.data_cfg.n_fft, self.data_cfg.hop_length
        b = len(mixed_audio)
        bucket = bucket_batch(b)
        audio = self._padded(mixed_audio, bucket)
        mixed_spec = stft_magnitude(audio, n_fft, hop)
        _, masks = self.model(mixed_spec, self._padded(lip_frames, bucket))
        waves = masked_istft(masks, audio, n_fft, hop)
        return waves[:b], masks[:b], mixed_spec[:b]

    @torch.inference_mode()
    def separate_waveform(self, mixed_audio: np.ndarray,
                          lip_frames: np.ndarray) -> Dict[str, np.ndarray]:
        """(B, N_audio) mixture + (B, N, H, W) frames -> dict of 'waveforms'
        (B, S, N_audio), 'masks' (B, S, F, T), 'mixed_spec' (B, F, T)."""
        if self.data_cfg is None:
            raise ValueError("separate_waveform requires data_cfg (STFT "
                             "geometry: n_fft, hop_length)")
        waves, masks, mixed_spec = self._wave_forward(mixed_audio, lip_frames)
        return {"waveforms": waves.cpu().numpy(),
                "masks": masks.cpu().numpy(),
                "mixed_spec": mixed_spec.cpu().numpy()}

    @torch.inference_mode()
    def separate_waveform_streaming(self, mixed_audio: np.ndarray,
                                    lip_frames: np.ndarray,
                                    chunk_s: Optional[float] = None,
                                    overlap_s: Optional[float] = None
                                    ) -> Dict[str, np.ndarray]:
        """A mixture of any length: (B, N_long) mixture + its lip streams
        (B, S*N_f, H, W) -> {'waveforms' (B, S, N_long), 'num_chunks'}.

        The JAX `Separator.separate_waveform_streaming`: fixed-size chunks
        (the tail zero-padded), each one bucketed waveform forward on the
        device, overlap-added under a linear cross-fade.  chunk_s defaults
        to the training utterance length, overlap_s to chunk_s / 4; both
        round down to whole video frames, and the overlap stays below the
        chunk by one frame.  lip_frames holds all speakers' streams
        concatenated on the frame axis (the dataset's layout); each chunk
        takes the matching slice of every speaker's stream, so output
        channel s follows lip stream s from chunk to chunk.  The stitching
        runs on the device in float32, as the JAX package's in numpy: a
        region that one chunk covers alone (weight 1) equals that chunk's
        `separate_waveform`.
        """
        if self.data_cfg is None:
            raise ValueError("streaming requires data_cfg (STFT geometry)")
        d = self.data_cfg
        sr = d.sample_rate
        spf = d.num_samples_audio // d.num_frames  # samples per video frame
        chunk = int((chunk_s or d.duration) * sr)
        chunk -= chunk % spf
        if chunk <= 0:
            raise ValueError("chunk_s too small for one video frame")
        overlap = int((chunk / 4) if overlap_s is None else overlap_s * sr)
        overlap -= overlap % spf
        overlap = min(overlap, chunk - spf)
        stride = chunk - overlap

        mixed_audio = np.asarray(mixed_audio, np.float32)
        lip_frames = np.asarray(lip_frames, np.float32)
        b, n = mixed_audio.shape
        s = self.cfg.num_speakers
        h, w = lip_frames.shape[-2:]
        n_f = lip_frames.shape[1] // s
        lips = lip_frames.reshape(b, s, n_f, h, w)

        n_chunks = max(1, -(-(n - overlap) // stride))
        padded_n = (n_chunks - 1) * stride + chunk
        audio_p = np.pad(mixed_audio, ((0, 0), (0, padded_n - n)))
        pad_f = padded_n // spf - n_f
        if pad_f > 0:
            lips = np.pad(lips, ((0, 0), (0, 0), (0, pad_f), (0, 0), (0, 0)))

        # Cross-fade window: linear ramps over the overlap on both edges;
        # dividing by the summed weights renormalizes the outer edges.
        win = np.ones(chunk, np.float32)
        if overlap:
            ramp = (np.arange(overlap, dtype=np.float32) + 1.0) / (overlap + 1)
            win[:overlap] = ramp
            win[-overlap:] = ramp[::-1]
        win_t = torch.from_numpy(win).to(self.device)

        out = torch.zeros((b, s, padded_n), dtype=torch.float32,
                          device=self.device)
        wsum = np.zeros(padded_n, np.float32)
        fpc = chunk // spf  # video frames per chunk
        for k in range(n_chunks):
            a0 = k * stride
            f0 = a0 // spf
            fr = lips[:, :, f0:f0 + fpc].reshape(b, s * fpc, h, w)
            waves, _, _ = self._wave_forward(audio_p[:, a0:a0 + chunk], fr)
            out[:, :, a0:a0 + chunk] += waves * win_t
            wsum[a0:a0 + chunk] += win
        wsum_t = torch.from_numpy(np.maximum(wsum, 1e-8)).to(self.device)
        out /= wsum_t
        return {"waveforms": out[:, :, :n].cpu().numpy(),
                "num_chunks": np.int32(n_chunks)}
