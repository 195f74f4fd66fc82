"""Batched inference (port of `av_separation_tpu/inference.py`).

``Separator`` holds an eval-mode model on one device and serves two APIs:
  - ``separate``: (B, F, T) magnitude + (B, N, H, W) lip frames ->
    (separated, masks), the reference model's contract;
  - ``separate_waveform``: (B, N_audio) raw mixture -> STFT magnitude ->
    model -> masks applied to the complex mixture STFT -> least-squares
    iSTFT -> per-speaker waveforms (B, S, N_audio).
Requests are zero-padded along the batch axis to the next power-of-two
bucket, as in the JAX package; padded rows never mix with real ones and are
sliced off.  ``from_checkpoint`` builds one from the model variables of a
`utils/checkpoint.py` checkpoint.  Streaming (`separate_waveform_streaming`)
is not ported yet.
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
        x = np.asarray(x, np.float32)
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

    @torch.inference_mode()
    def separate_waveform(self, mixed_audio: np.ndarray,
                          lip_frames: np.ndarray) -> Dict[str, np.ndarray]:
        """(B, N_audio) mixture + (B, N, H, W) frames -> dict of 'waveforms'
        (B, S, N_audio), 'masks' (B, S, F, T), 'mixed_spec' (B, F, T)."""
        if self.data_cfg is None:
            raise ValueError("separate_waveform requires data_cfg (STFT "
                             "geometry: n_fft, hop_length)")
        n_fft, hop = self.data_cfg.n_fft, self.data_cfg.hop_length
        b = len(mixed_audio)
        bucket = bucket_batch(b)
        audio = self._padded(mixed_audio, bucket)
        mixed_spec = stft_magnitude(audio, n_fft, hop)
        _, masks = self.model(mixed_spec, self._padded(lip_frames, bucket))
        waves = masked_istft(masks, audio, n_fft, hop)
        return {"waveforms": waves[:b].cpu().numpy(),
                "masks": masks[:b].cpu().numpy(),
                "mixed_spec": mixed_spec[:b].cpu().numpy()}
