"""Evaluation metrics of the reference demo script (port of
`av_separation_tpu/utils/metrics.py`): `snr_db` (reference demo.py:24-28)
and the best-permutation output SNR (demo.py:67-80), batched."""

from __future__ import annotations

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
