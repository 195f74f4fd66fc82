"""Fused activation + dropout (port of `av_separation_tpu/ops/activations.py`).

  relu_dropout  saves only its output: out = keep * scale * max(x, 0) is
                positive exactly where the gradient passes, so
                dx = g * scale * (out > 0) reproduces mask and sign in one
                test, as the JAX package's backward reads the sign of the
                saved output.
  gelu_dropout  exact (erf) GELU, then dropout; saves the input and the
                mask and recomputes the GELU derivative in backward.

Both take the quantized uint8 mask of `ops/dropout.py` (same n/256
threshold, same survivor scale, rounded to the tensor's dtype).  Rate 0 or
no generator means the plain activation.  In bf16 the GELU and its
derivative are computed in float32 and rounded to bf16, as the JAX
`_gelu_exact` / `_gelu_grad` do.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from av_separation_torch.ops import upcast
from av_separation_torch.ops.dropout import (keep_bits, keep_scale,
                                             quantized_rate)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU computed in float32 (or wider), in x's dtype."""
    return F.gelu(upcast(x)).to(x.dtype)


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx [x Phi(x)] = Phi(x) + x phi(x), exact (erf) GELU."""
    cdf = 0.5 * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))
    pdf = torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))
    return cdf + x * pdf


class _ReluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep, scale: float):
        out = torch.where(keep, torch.relu(x) * scale, 0.0)
        ctx.save_for_backward(out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return torch.where(out > 0, g * ctx.scale, 0.0), None, None


class _GeluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep, scale: float):
        ctx.save_for_backward(x, keep)
        ctx.scale = scale
        return torch.where(keep, gelu(x) * scale, 0.0)

    @staticmethod
    def backward(ctx, g):
        x, keep = ctx.saved_tensors
        dgelu = gelu_grad(upcast(x)).to(x.dtype)
        return (torch.where(keep, g * dgelu * ctx.scale, 0.0), None, None)


def relu_dropout(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator],
                 part: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """relu -> dropout(rate); rate 0 or no generator means plain relu.
    `part` (i, n): x is column block i of n of the full width (a TP rank's
    FFN hidden), whose bits are those block's of the full-width draw."""
    if rate == 0.0 or generator is None:
        return torch.relu(x)
    n = quantized_rate(rate)
    return _ReluDropout.apply(x, keep_bits(x.shape, n, generator, x.device,
                                           part), keep_scale(n, x.dtype))


def gelu_dropout(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator],
                 part: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """exact gelu -> dropout(rate); rate 0 or no generator means plain
    gelu.  `part` as in `relu_dropout`."""
    if rate == 0.0 or generator is None:
        return gelu(x)
    n = quantized_rate(rate)
    return _GeluDropout.apply(x, keep_bits(x.shape, n, generator, x.device,
                                           part), keep_scale(n, x.dtype))
