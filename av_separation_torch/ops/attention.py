"""Multi-head attention over projected Q/K/V (port of
`av_separation_tpu/ops/attention.py`).

Q/K/V arrive packed as (B, T, H*dh), usually as column slices of one fused
projection, and go to the flash kernels as (B, H, T, dh) stride views: no
head transpose is copied in either direction, forward or backward.  The
kernel wrappers pick the CUDA kernels for a CUDA tensor and the plain
versions for a CPU tensor.  The sharded and sequence-parallel routes of the
JAX dispatcher come with the parallel tier.
"""

from __future__ import annotations

from typing import Optional

import torch

from av_separation_torch.ops.kernels.attention import flash_attention


def split_heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    """(B, T, H*dh) -> (B, H, T, dh) view."""
    return x.unflatten(-1, (nhead, x.shape[-1] // nhead)).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, dh) -> (B, T, H*dh); a view when x lies in packed memory."""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def draw_seed(generator: torch.Generator) -> int:
    """One int32 attention-dropout seed per call, as the JAX dispatcher's
    `jax.random.bits(rng, (1,), "uint32").astype(int32)` draws one.  The
    generator lives on the CPU, so no device-to-host copy is needed; the
    seed reaches the kernel as a launch argument."""
    bits = int(torch.randint(0, 1 << 32, (1,), dtype=torch.int64,
                             generator=generator))
    return bits - (1 << 32) if bits >= 1 << 31 else bits


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         nhead: int, dropout_rate: float = 0.0,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Packed (B, Tq, d), (B, Tk, d), (B, Tk, d) -> (B, Tq, d).

    Attention-probability dropout at `dropout_rate` runs in the kernels,
    seeded from the CPU `generator`; without a generator there is no
    dropout (as the JAX dispatcher does without a dropout key).
    """
    rate, seed = 0.0, 0
    if dropout_rate > 0.0 and generator is not None:
        rate, seed = float(dropout_rate), draw_seed(generator)
    out = flash_attention(split_heads(q, nhead), split_heads(k, nhead),
                          split_heads(v, nhead), rate, seed)
    return merge_heads(out)
