"""Operators of the port: attention, dropout, activations, STFT and the
kernel wrappers (`ops/kernels/`)."""

import torch


def upcast(t: torch.Tensor) -> torch.Tensor:
    """t in the dtype its math runs in: float32 for bf16 (exact), t itself
    at float32 and float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))
