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

Compute dtype (`ModelConfig.compute_dtype`): modules take the flax
`dtype` argument, None for float32 (tensors pass as they come, so a
float64 reference run stays float64) or torch.bfloat16.  Parameters stay
float32 and are cast at use: `Linear` computes x.bf16 @ w.bf16 + b.bf16,
as a flax Dense with dtype does; `LayerNorm` computes in float32 and
rounds its output to the dtype; the PE table is added in x's dtype.  With
`remat`, `TransformerEncoder` recomputes each layer in the backward
(`remat_layer`), replaying the layer's own dropout draws.

Under a mesh (`parallel/shard.py` sets each module's `mesh`) a module
computes the rank's part: `MultiHeadAttention` its head group (the rank's
rows of q, k and v), a 'column' `Linear` its output columns from an input
taken through Megatron's f, a 'row' `Linear` its partial product summed
over 'model' (the bias added once, by model rank 0), the FFN dropout its
column block of the full-width draw, `PositionalEncoding` the rows of its
time block, `TorchBatchNorm` the statistics of the global batch (means
over 'data' and 'fsdp').
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from av_separation_torch.ops.activations import relu_dropout
from av_separation_torch.ops.attention import multi_head_attention
from av_separation_torch.ops.dropout import Dropout
from av_separation_torch.parallel import comm


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


def tp_part(mesh) -> Tuple[int, int]:
    """(this rank's index, count) along 'model'; (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank("model"), mesh.size(
        mesh.mesh_dim_names.index("model"))


def at(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """t in a module's compute dtype: cast where one is set, as it is."""
    return t if dtype is None else t.to(dtype)


def remat_layer(layer: nn.Module, gens: Optional[Generators],
                *xs: torch.Tensor) -> torch.Tensor:
    """layer(*xs, gens) under `torch.utils.checkpoint`: its activations are
    recomputed in the backward instead of kept, as `nn.remat` does.

    A recompute must see the dropout draws of the first run, and
    `checkpoint` restores only the global RNG states.  So the states of
    both explicit generators are taken before the first run, which
    advances them as an unchecked call would, and the recompute draws from
    copies of those states: the same seeds and bits, hence the same
    masks, and `gens` is not advanced twice."""
    if gens is None:
        return checkpoint(layer, *xs, None, use_reentrant=False,
                          preserve_rng_state=False)
    snap = (gens.seeds.get_state(), gens.bits.get_state())
    ran = []

    def run(*inner: torch.Tensor) -> torch.Tensor:
        if not ran:
            ran.append(True)
            return layer(*inner, gens)
        replay = Generators(
            torch.Generator().set_state(snap[0]),
            torch.Generator(device=gens.bits.device).set_state(snap[1]))
        return layer(*inner, replay)

    return checkpoint(run, *xs, use_reentrant=False,
                      preserve_rng_state=False)


def call_layers(layers, remat: bool, gens: Optional[Generators],
                x: torch.Tensor, *rest: torch.Tensor) -> torch.Tensor:
    """x through `layers` in turn, each as layer(x, *rest, gens); with
    `remat`, each layer of a training forward that builds a graph is
    recomputed in the backward (`remat_layer`)."""
    for layer in layers:
        if remat and layer.training and torch.is_grad_enabled():
            x = remat_layer(layer, gens, x, *rest)
        else:
            x = layer(x, *rest, gens)
    return x


class Linear(nn.Linear):
    """nn.Linear (its parameters and state-dict names) computed in `dtype`:
    input, weight and bias cast at use, as a flax Dense with dtype does.
    `tp` ('column' or 'row') is its tensor-parallel role under a mesh."""

    mesh = None

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None,
                 tp: Optional[str] = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        self.tp = tp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd, mesh = self.compute_dtype, self.mesh
        w, b = at(self.weight, cd), at(self.bias, cd)
        if mesh is None or self.tp is None:
            return F.linear(at(x, cd), w, b)
        if self.tp == "column":
            return F.linear(at(comm.copy_to_model(x, mesh), cd), w, b)
        first = mesh.get_local_rank("model") == 0
        return comm.reduce_from_model(
            F.linear(at(x, cd), w, b if first else None), mesh)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computed in `dtype`, as a flax Conv with dtype."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return self._conv_forward(at(x, cd), at(self.weight, cd),
                                  at(self.bias, cd))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm as a flax LayerNorm with `dtype`: statistics and the
    affine map in float32 (or wider), the output in `dtype`, else in the
    promoted input dtype (a bf16 input gives float32, as flax's
    LayerNorm without a dtype does)."""

    def __init__(self, d: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(d, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wide = torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.to(wide), self.normalized_shape,
                         self.weight.to(wide), self.bias.to(wide), self.eps)
        return at(y, self.compute_dtype)


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

    mesh = None

    def __init__(self, d_model: int, dropout: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        t = x.shape[-2]
        # Under 'seq' x is the rank's time block: the table's rows from its
        # global offset on.
        start = 0 if self.mesh is None \
            else self.mesh.get_local_rank("seq") * t
        pe = sinusoidal_pe(start + t, self.d_model, x.device)[start:]
        x = x + pe.to(x.dtype)  # in x's dtype, as the JAX table is made
        return self.dropout(x, bits(gens))


class TorchBatchNorm(nn.Module):
    """BatchNorm over channel axis 1 with `nn.BatchNorm2d`'s parameters,
    buffers and semantics (reference model.py:83-90), as the JAX
    `TorchBatchNorm`: y = (x - mean) * (rsqrt(var + eps) * weight) + bias.
    In training, mean and the biased variance of the batch normalise, and
    the running stats move by momentum 0.1 towards the mean and the
    unbiased variance; in eval, the running stats normalise.  Statistics
    and the map run in float32 (or wider) and the output is in x's dtype,
    as the JAX module computes a bf16 x."""

    mesh = None

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

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        x = x_in.to(torch.promote_types(x_in.dtype, torch.float32))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            axes = (0,) + tuple(range(2, x.dim()))
            mean = x.mean(dim=axes)
            n = x.numel() // x.shape[1]
            if self.mesh is not None:
                # The global batch's statistics, as the one JAX program
                # computes them: every rank holds as many rows.
                mean = comm.mean_over_rows(mean, self.mesh)
                var = comm.mean_over_rows(
                    (x - mean.view(shape)).square().mean(dim=axes),
                    self.mesh)
                n *= comm.rows_size(self.mesh)
            else:
                var = (x - mean.view(shape)).square().mean(dim=axes)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(
                    m * var * (n / max(n - 1, 1)))
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)
        return y.to(x_in.dtype)


class MultiHeadAttention(nn.Module):
    """Projected MHA with `nn.MultiheadAttention`'s parameter layout
    (`in_proj_weight` (3d, d), `in_proj_bias`, `out_proj`), computed by the
    port's own attention op with in-kernel probability dropout.
    Self-attention (q_in is kv_in) projects Q, K and V in one matmul; the
    kernel reads the three column slices in place.  `dtype` is the compute
    dtype of the projections and the attention (None: float32).  Under a
    mesh `in_proj_weight` holds the rank's rows of each of q, k and v
    (whole heads) and `out_proj` is row-parallel."""

    mesh = None

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        self.dropout = dropout
        self.compute_dtype = dtype
        bound = 1.0 / math.sqrt(d_model)  # the JAX q/k/v Dense init
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * d_model, d_model).uniform_(-bound, bound))
        self.in_proj_bias = nn.Parameter(
            torch.empty(3 * d_model).uniform_(-bound, bound))
        self.out_proj = Linear(d_model, d_model, dtype, tp="row")

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        cd, mesh = self.compute_dtype, self.mesh
        w, b = at(self.in_proj_weight, cd), at(self.in_proj_bias, cd)
        d = w.shape[0] // 3  # the rank's width under 'model'
        nhead = self.nhead * d // self.d_model
        if mesh is not None:
            same = q_in is kv_in
            q_in = comm.copy_to_model(q_in, mesh)
            kv_in = q_in if same else comm.copy_to_model(kv_in, mesh)
        if q_in is kv_in:
            q, k, v = F.linear(at(q_in, cd), w, b).split(d, dim=-1)
        else:
            q = F.linear(at(q_in, cd), w[:d], b[:d])
            k, v = F.linear(at(kv_in, cd), w[d:], b[d:]).split(d, dim=-1)
        rate = train_rate(self, self.dropout, gens)
        out = multi_head_attention(q, k, v, nhead, rate, seeds(gens), mesh)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm self-attention block: torch `nn.TransformerEncoderLayer`
    (norm_first=True, ffn 4d, ReLU) semantics (reference model.py:48-52),
    with the JAX layer's dropout sites."""

    mesh = None

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout, dtype)
        self.linear1 = Linear(d_model, 4 * d_model, dtype, tp="column")
        self.linear2 = Linear(4 * d_model, d_model, dtype, tp="row")
        self.norm1 = LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.norm2 = LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)

    def forward(self, x: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        h = self.norm1(x)
        x = self.drop1(self.self_attn(h, h, gens), bits(gens), residual=x)
        h = self.linear1(self.norm2(x))
        h = relu_dropout(h, train_rate(self, self.dropout, gens), bits(gens),
                         tp_part(self.mesh))
        return self.drop2(self.linear2(h), bits(gens), residual=x)


class TransformerEncoder(nn.Module):
    """Stack of pre-norm encoder layers with no final norm; with `remat`,
    each layer is recomputed in the backward (`nn.remat` in the JAX
    package, layers.py:259-272)."""

    def __init__(self, d_model: int, nhead: int, num_layers: int,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dropout, dtype)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        return call_layers(self.layers, self.remat, gens, x)
