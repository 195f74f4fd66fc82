"""Shared building blocks (port of `av_separation_tpu/models/layers.py`):
positional encoding, torch-semantics BatchNorm, multi-head attention and the
pre-norm transformer encoder stack.

Module and parameter names are the reference's torch names, so reference
state dicts load with `load_state_dict`.  Every module runs in eval mode
(serving) and in training mode.  Training draws its randomness from the
`Generators` passed down the forward: a CPU generator for the attention
kernels' dropout seeds and a generator on the model's device for the
residual and FFN dropout bits.  The draw sites are the JAX package's: PE
dropout, attention dropout, `drop1`, the fused ReLU + dropout of the FFN and
`drop2`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from av_separation_torch.ops.activations import relu_dropout
from av_separation_torch.ops.attention import multi_head_attention
from av_separation_torch.ops.dropout import Dropout


class Generators(NamedTuple):
    """The random streams of a training forward."""

    seeds: torch.Generator  # CPU: one int32 seed per attention call
    bits: torch.Generator   # model's device: residual / FFN dropout bits


def seeds(gens: Optional[Generators]) -> Optional[torch.Generator]:
    return None if gens is None else gens.seeds


def bits(gens: Optional[Generators]) -> Optional[torch.Generator]:
    return None if gens is None else gens.bits


def train_rate(module: nn.Module, rate: float,
               gens: Optional[Generators]) -> float:
    """The dropout rate a module applies: 0 in eval mode; in training a
    rate > 0 needs the generators."""
    if not module.training or rate == 0.0:
        return 0.0
    if gens is None:
        raise ValueError(f"{type(module).__name__} in training mode with "
                         f"dropout {rate} needs Generators")
    return rate


def sinusoidal_pe(seq_len: int, d_model: int,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """Interleaved sin/cos PE table (seq_len, d_model), float32.

    Computed in float64 NumPy like the reference's table
    (reference model.py:290-298), with no max_len cap.
    """
    position = np.arange(seq_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * (-math.log(10000.0) / d_model))
    pe = np.zeros((seq_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.as_tensor(pe.astype(np.float32), device=device)


class PositionalEncoding(nn.Module):
    """Adds the sinusoidal PE, computed for the input's length, then
    dropout.  The reference's `pe` buffer (a 5000-row table) has no
    counterpart here; `utils.transplant.load_reference_state_dict` checks
    and drops it."""

    def __init__(self, d_model: int, dropout: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        x = x + sinusoidal_pe(x.shape[-2], self.d_model, x.device)
        return self.dropout(x, bits(gens))


class TorchBatchNorm(nn.Module):
    """BatchNorm over channel axis 1 with `nn.BatchNorm2d`'s parameters,
    buffers and semantics (reference model.py:83-90), as the JAX
    `TorchBatchNorm`: y = (x - mean) * (rsqrt(var + eps) * weight) + bias.
    In training, mean and the biased variance of the batch normalise, and
    the running stats move by momentum 0.1 towards the mean and the
    unbiased variance; in eval, the running stats normalise."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            axes = (0,) + tuple(range(2, x.dim()))
            mean = x.mean(dim=axes)
            var = (x - mean.view(shape)).square().mean(dim=axes)  # biased
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(
                    m * var * (n / max(n - 1, 1)))
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)


class MultiHeadAttention(nn.Module):
    """Projected MHA with `nn.MultiheadAttention`'s parameter layout
    (`in_proj_weight` (3d, d), `in_proj_bias`, `out_proj`), computed by the
    port's own attention op with in-kernel probability dropout.
    Self-attention (q_in is kv_in) projects Q, K and V in one matmul; the
    kernel reads the three column slices in place."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        self.dropout = dropout
        bound = 1.0 / math.sqrt(d_model)  # the JAX q/k/v Dense init
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * d_model, d_model).uniform_(-bound, bound))
        self.in_proj_bias = nn.Parameter(
            torch.empty(3 * d_model).uniform_(-bound, bound))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        d = self.d_model
        w, b = self.in_proj_weight, self.in_proj_bias
        if q_in is kv_in:
            q, k, v = F.linear(q_in, w, b).split(d, dim=-1)
        else:
            q = F.linear(q_in, w[:d], b[:d])
            k, v = F.linear(kv_in, w[d:], b[d:]).split(d, dim=-1)
        rate = train_rate(self, self.dropout, gens)
        out = multi_head_attention(q, k, v, self.nhead, rate, seeds(gens))
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm self-attention block: torch `nn.TransformerEncoderLayer`
    (norm_first=True, ffn 4d, ReLU) semantics (reference model.py:48-52),
    with the JAX layer's dropout sites."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, 4 * d_model)
        self.linear2 = nn.Linear(4 * d_model, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)

    def forward(self, x: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.drop1(self.self_attn(h, h, gens), bits(gens))
        h = self.linear1(self.norm2(x))
        h = relu_dropout(h, train_rate(self, self.dropout, gens), bits(gens))
        return x + self.drop2(self.linear2(h), bits(gens))


class TransformerEncoder(nn.Module):
    """Stack of pre-norm encoder layers with no final norm."""

    def __init__(self, d_model: int, nhead: int, num_layers: int,
                 dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dropout)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, gens)
        return x
