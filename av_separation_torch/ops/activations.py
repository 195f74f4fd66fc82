"""Fused activation + dropout (port of `av_separation_tpu/ops/activations.py`).

  relu_dropout  saves only its output: out = keep * scale * max(x, 0) is
                positive exactly where the gradient passes, so
                dx = g * scale * (out > 0) reproduces mask and sign in one
                test, as the JAX package's backward reads the sign of the
                saved output.
  gelu_dropout  exact (erf) GELU, then dropout; saves the input and the
                draw and recomputes the GELU derivative in backward.
  silu_dropout  SiLU (x sigmoid(x)), then dropout, as gelu_dropout (the
                conformer's FFNs; port-only, no JAX counterpart).

Both take the quantized uint8 draw of `ops/dropout.py` (same n/256
threshold, same survivor scale, rounded to the tensor's dtype) and run as
one fused op (`ops/kernels/dropout_fused.py`), which holds the GELU and its
derivative.  Rate 0 or no generator means the plain activation.  In bf16
the GELU and its derivative are computed in float32 and rounded to bf16,
as the JAX `_gelu_exact` / `_gelu_grad` do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from av_separation_torch.ops.dropout import (keep_bits, keep_scale,
                                             quantized_rate)
from av_separation_torch.ops.kernels.dropout_fused import (fused_dropout,
                                                           gelu, silu)


def _fused(kind: str, x: torch.Tensor, rate: float,
           generator: torch.Generator,
           part: Tuple[int, int]) -> torch.Tensor:
    n = quantized_rate(rate)
    return fused_dropout(kind, x, keep_bits(x.shape, generator, x.device,
                                            part), n, keep_scale(n, x.dtype))


def relu_dropout(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator],
                 part: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """relu -> dropout(rate); rate 0 or no generator means plain relu.
    `part` (i, n): x is column block i of n of the full width (a TP rank's
    FFN hidden), whose bits are those block's of the full-width draw."""
    if rate == 0.0 or generator is None:
        return torch.relu(x)
    return _fused("relu_dropout", x, rate, generator, part)


def gelu_dropout(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator],
                 part: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """exact gelu -> dropout(rate); rate 0 or no generator means plain
    gelu.  `part` as in `relu_dropout`."""
    if rate == 0.0 or generator is None:
        return gelu(x)
    return _fused("gelu_dropout", x, rate, generator, part)


def silu_dropout(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """silu -> dropout(rate); rate 0 or no generator means plain silu."""
    if rate == 0.0 or generator is None:
        return silu(x)
    return _fused("silu_dropout", x, rate, generator, (0, 1))
