"""Evaluation metrics of the reference demo script (port of
`av_separation_tpu/utils/metrics.py`): `snr_db` (reference demo.py:24-28),
the best-permutation output SNR (demo.py:67-80), batched, and
`evaluate_separation`, the two numbers the demo prints."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from av_separation_torch.losses import permutation_table


def snr_db(signal: torch.Tensor, noise: torch.Tensor,
           eps: float = 1e-8) -> torch.Tensor:
    """10 log10(|signal|^2 / |noise|^2) over the last two axes."""
    s = signal.square().sum(dim=(-2, -1))
    n = noise.square().sum(dim=(-2, -1))
    return 10.0 * torch.log10(s / (n + eps) + eps)


def input_snr(mixed_spec: torch.Tensor,
              clean_specs: torch.Tensor) -> torch.Tensor:
    """Mean over speakers of snr_db(target, mixed - target): (B,)."""
    return snr_db(clean_specs, mixed_spec[:, None] - clean_specs).mean(-1)


def permutation_snr(separated: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Best-permutation mean output SNR per sample: (B,)."""
    snrs = []
    for perm in permutation_table(separated.shape[1]):
        perm_sep = separated[:, torch.as_tensor(perm)]
        snrs.append(snr_db(targets, perm_sep - targets).mean(-1))
    return torch.stack(snrs).max(dim=0).values


@torch.no_grad()
def evaluate_separation(model: torch.nn.Module,
                        mixed: np.ndarray | torch.Tensor,
                        frames: np.ndarray | torch.Tensor,
                        targets: np.ndarray | torch.Tensor
                        ) -> Tuple[float, float]:
    """(mean input SNR, mean best-permutation output SNR) over the batch,
    the model run in eval mode (its mode is restored) on its own device:
    the two numbers the reference demo prints (demo.py:31-64)."""
    device = next(model.parameters()).device
    mixed, frames, targets = (torch.as_tensor(x, device=device)
                              for x in (mixed, frames, targets))
    was_training = model.training
    model.eval()
    try:
        separated, _ = model(mixed, frames)
    finally:
        model.train(was_training)
    return (float(input_snr(mixed, targets).mean()),
            float(permutation_snr(separated, targets).mean()))
