"""Residual dropout with a uint8 keep mask (port of
`av_separation_tpu/ops/dropout.py`).

The keep probability is quantized to 1/256: n = clamp(round(rate * 256), 1,
255), an element is kept when its random uint8 is >= n, and survivors are
scaled by 1 / (1 - n/256), so the output stays exactly mean-unbiased (0.1 ->
26/256).  The scale is rounded to the tensor's dtype first, as the JAX
`_keep_scale(n, x.dtype)` does (1.109375 in bf16).  The bits come from the
caller's `torch.Generator` on the tensor's device; they match the JAX
package's in distribution only.  Each site's draw goes as drawn to one
fused op (`ops/kernels/dropout_fused.py`: a kernel forward and one backward
on the card), which also adds the residual where there is one; the
backward reads the draw it saved (the JAX package redraws the bits from
the saved key instead).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from av_separation_torch.ops.kernels.dropout_fused import fused_dropout


def quantized_rate(rate: float) -> int:
    """n of the n/256 drop probability."""
    return min(max(int(round(rate * 256.0)), 1), 255)


def keep_scale(n: int, dtype: torch.dtype = torch.float32) -> float:
    """The survivor scale 1 / (1 - n/256), rounded to `dtype`: x * scale
    then rounds once to x's dtype, as a product in that dtype does."""
    return float(torch.tensor(1.0 / (1.0 - n / 256.0), dtype=dtype))


def keep_bits(shape, generator: torch.Generator, device: torch.device,
              part: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """A site's draw: uniform uint8 bits of `shape`, kept where >= n.
    `part` (i, count): the bits of column block i of a tensor `count`
    times as wide in its last dim, a view of that tensor's draw (a TP
    rank's share of a full-width draw that every rank of the 'model' axis
    makes alike)."""
    i, count = part
    full = tuple(shape[:-1]) + (shape[-1] * count,)
    bits = torch.randint(0, 256, full, dtype=torch.uint8, device=device,
                         generator=generator)
    if count > 1:
        bits = bits.narrow(-1, i * shape[-1], shape[-1])
    return bits


def fast_dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dropout at `rate`, quantized to n/256, bits from `generator`; with
    `residual`, residual + dropout(x) in the same op."""
    n = quantized_rate(rate)
    bits = keep_bits(x.shape, generator, x.device)
    kind = "dropout" if residual is None else "dropout_add"
    return fused_dropout(kind, x, bits, n, keep_scale(n, x.dtype), residual)


class Dropout(nn.Module):
    """The port's residual dropout: identity in eval mode or at rate 0,
    `fast_dropout` in training; given a `residual`, residual + dropout(x).
    Holds no parameters, so it may sit in a reference `nn.Sequential` slot
    without changing the state dict."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x if residual is None else residual + x
        if generator is None:
            raise ValueError(f"{type(self).__name__}({self.rate}) in "
                             f"training mode needs a dropout generator")
        return fast_dropout(x, self.rate, generator, residual)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
