"""Shared building blocks (port of `av_separation_tpu/models/layers.py`):
positional encoding, torch-semantics BatchNorm, multi-head attention and the
pre-norm transformer encoder stack.

Module and parameter names are the reference's torch names, so reference
state dicts load with `load_state_dict`.  This slice serves: every module
runs in eval mode only and raises in training mode (dropout, batch
statistics and the attention backward come with the training slice).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from av_separation_torch.ops.attention import multi_head_attention


def require_eval(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__} runs in eval mode only; call .eval() "
            f"(training is not ported yet)")


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
    """Adds the sinusoidal PE, computed for the input's length.  The
    reference's `pe` buffer (a 5000-row table) has no counterpart here;
    `utils.transplant.load_reference_state_dict` checks and drops it."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        require_eval(self)
        return x + sinusoidal_pe(x.shape[-2], self.d_model, x.device)


class TorchBatchNorm(nn.Module):
    """Eval-mode BatchNorm over channel axis 1, with `nn.BatchNorm2d`'s
    parameters and buffers: y = (x - mean) * (rsqrt(var + eps) * weight)
    + bias, the arithmetic of the JAX `TorchBatchNorm` with running stats."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        require_eval(self)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean.view(shape)) * inv.view(shape)
                + self.bias.view(shape))


class MultiHeadAttention(nn.Module):
    """Projected MHA with `nn.MultiheadAttention`'s parameter layout
    (`in_proj_weight` (3d, d), `in_proj_bias`, `out_proj`), computed by the
    port's own attention op.  Self-attention (q_in is kv_in) projects Q, K
    and V in one matmul; the kernel reads the three column slices in place.
    """

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        bound = 1.0 / math.sqrt(d_model)  # the JAX q/k/v Dense init
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * d_model, d_model).uniform_(-bound, bound))
        self.in_proj_bias = nn.Parameter(
            torch.empty(3 * d_model).uniform_(-bound, bound))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        require_eval(self)
        d = self.d_model
        w, b = self.in_proj_weight, self.in_proj_bias
        if q_in is kv_in:
            q, k, v = F.linear(q_in, w, b).split(d, dim=-1)
        else:
            q = F.linear(q_in, w[:d], b[:d])
            k, v = F.linear(kv_in, w[d:], b[d:]).split(d, dim=-1)
        return self.out_proj(multi_head_attention(q, k, v, self.nhead))


class TransformerEncoderLayer(nn.Module):
    """Pre-norm self-attention block: torch `nn.TransformerEncoderLayer`
    (norm_first=True, ffn 4d, ReLU) semantics (reference model.py:48-52)."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, 4 * d_model)
        self.linear2 = nn.Linear(4 * d_model, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.self_attn(h, h)
        return x + self.linear2(torch.relu(self.linear1(self.norm2(x))))


class TransformerEncoder(nn.Module):
    """Stack of pre-norm encoder layers with no final norm."""

    def __init__(self, d_model: int, nhead: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead) for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
