"""Residual dropout with a uint8 keep mask (port of
`av_separation_tpu/ops/dropout.py`).

The keep probability is quantized to 1/256: n = clamp(round(rate * 256), 1,
255), an element is kept when its random uint8 is >= n, and survivors are
scaled by 1 / (1 - n/256), so the output stays exactly mean-unbiased (0.1 ->
26/256).  The scale is rounded to the tensor's dtype first, as the JAX
`_keep_scale(n, x.dtype)` does (1.109375 in bf16).  The bits come from the
caller's `torch.Generator` on the tensor's device; they match the JAX
package's in distribution only.  The backward
applies the forward's mask, saved as a bool tensor (the JAX package redraws
the bits from the saved key instead).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn


def quantized_rate(rate: float) -> int:
    """n of the n/256 drop probability."""
    return min(max(int(round(rate * 256.0)), 1), 255)


def keep_scale(n: int, dtype: torch.dtype = torch.float32) -> float:
    """The survivor scale 1 / (1 - n/256), rounded to `dtype`: x * scale
    then rounds once to x's dtype, as a product in that dtype does."""
    return float(torch.tensor(1.0 / (1.0 - n / 256.0), dtype=dtype))


def keep_bits(shape, n: int, generator: torch.Generator,
              device: torch.device,
              part: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Bool keep mask: uniform uint8 bits >= n.  `part` (i, count): the
    mask of column block i of a tensor `count` times as wide in its last
    dim, cut from that tensor's draw (a TP rank's share of a full-width
    draw that every rank of the 'model' axis makes alike)."""
    i, count = part
    full = tuple(shape[:-1]) + (shape[-1] * count,)
    bits = torch.randint(0, 256, full, dtype=torch.uint8, device=device,
                         generator=generator)
    if count > 1:
        bits = bits.narrow(-1, i * shape[-1], shape[-1])
    return bits >= n


class _MaskedScale(torch.autograd.Function):
    """x * scale where keep, 0 elsewhere; the gradient takes the same mask."""

    @staticmethod
    def forward(ctx, x, keep, scale: float):
        ctx.save_for_backward(keep)
        ctx.scale = scale
        return torch.where(keep, x * scale, 0.0)

    @staticmethod
    def backward(ctx, g):
        (keep,) = ctx.saved_tensors
        return torch.where(keep, g * ctx.scale, 0.0), None, None


def fast_dropout(x: torch.Tensor, rate: float,
                 generator: torch.Generator) -> torch.Tensor:
    """Dropout at `rate`, quantized to n/256, bits from `generator`."""
    n = quantized_rate(rate)
    keep = keep_bits(x.shape, n, generator, x.device)
    return _MaskedScale.apply(x, keep, keep_scale(n, x.dtype))


class Dropout(nn.Module):
    """The port's residual dropout: identity in eval mode or at rate 0,
    `fast_dropout` in training.  Holds no parameters, so it may sit in a
    reference `nn.Sequential` slot without changing the state dict."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError(f"{type(self).__name__}({self.rate}) in "
                             f"training mode needs a dropout generator")
        return fast_dropout(x, self.rate, generator)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
