"""Multi-head attention over projected Q/K/V (port of
`av_separation_tpu/ops/attention.py`).

Q/K/V arrive packed as (B, T, H*dh), usually as column slices of one fused
projection, and go to the flash kernel as (B, H, T, dh) stride views: no
head transpose is copied in either direction.  The kernel wrapper picks the
CUDA kernel for a CUDA tensor and the plain version for a CPU tensor.  The
sharded and sequence-parallel routes of the JAX dispatcher come with the
parallel tier.
"""

from __future__ import annotations

import torch

from av_separation_torch.ops.kernels.attention import flash_attn_fwd


def split_heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    """(B, T, H*dh) -> (B, H, T, dh) view."""
    return x.unflatten(-1, (nhead, x.shape[-1] // nhead)).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, dh) -> (B, T, H*dh); a view when x lies in packed memory."""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         nhead: int) -> torch.Tensor:
    """Packed (B, Tq, d), (B, Tk, d), (B, Tk, d) -> (B, Tq, d)."""
    out, _ = flash_attn_fwd(split_heads(q, nhead), split_heads(k, nhead),
                            split_heads(v, nhead))
    return merge_heads(out)
