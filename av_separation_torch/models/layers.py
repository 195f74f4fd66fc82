"""Shared building blocks (port of `av_separation_tpu/models/layers.py`):
positional encoding, torch-semantics BatchNorm, multi-head attention, the
pre-norm transformer encoder stack and, port-only, the conformer stack.

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
(`remat_layer`), replaying the layer's own dropout draws; a recompute
leaves BatchNorm's running statistics as the first run moved them.

`ConformerLayer` (port-only; Gulati et al. 2020, arXiv:2005.08100) is
the macaron block: x + FFN/2, + MHSA, + convolution module, + FFN/2, then
a LayerNorm.  Its FFNs use SiLU (`silu_dropout`), the convolution module
is LayerNorm, Linear(d, 2d), GLU and a depthwise convolution over time in
one kernel (`ops/kernels/glu_dwconv.py`), BatchNorm over (batch, time),
SiLU and Linear(d, d).  MHSA is `MultiHeadAttention` without a relative
position term (as `torchaudio.models.Conformer`).  Its draws, in forward
order: FFN1's SiLU and residual, attention, its residual, the convolution
module's residual, FFN2's SiLU and residual.  The halved residuals are
`dropout_add` with the survivor scale halved (halving is exact, so
x + (y s)/2 rounds as x + y (s/2)).

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

import contextlib
import functools
import math
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from av_separation_torch.ops.activations import relu_dropout, silu_dropout
from av_separation_torch.ops.attention import multi_head_attention
from av_separation_torch.ops.dropout import (Dropout, keep_bits, keep_scale,
                                             quantized_rate)
from av_separation_torch.ops.kernels.dropout_fused import fused_dropout
from av_separation_torch.ops.kernels.glu_dwconv import glu_dwconv
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


class _Casts(threading.local):
    """The parameters cast once for a forward (`cast_once`), by id."""

    table: dict = {}


_CASTS = _Casts()


def at(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """t in a module's compute dtype: cast where one is set (a parameter
    taken from the forward's casts, `cast_once`), as it is."""
    if dtype is None:
        return t
    cast = _CASTS.table.get(id(t))
    return t.to(dtype) if cast is None or cast.dtype != dtype else cast


class _CastAll(torch.autograd.Function):
    """The tensors of a list in `dtype`, as views of one cast of their
    concatenation: a few launches, not one a tensor.  The gradients come
    back the same way, each in its tensor's dtype, as a cast at each use
    would give them (a cast is exact or rounds each element alone)."""

    @staticmethod
    def forward(ctx, dtype, *params):
        ctx.set_materialize_grads(False)
        ctx.shapes = [p.shape for p in params]
        ctx.sizes = [p.numel() for p in params]
        ctx.dtype = params[0].dtype
        flat = torch.cat([p.reshape(-1) for p in params]).to(dtype)
        return tuple(t.view(shape) for t, shape in
                     zip(flat.split(ctx.sizes), ctx.shapes))

    @staticmethod
    def backward(ctx, *grads):
        like = next(g for g in grads if g is not None)
        flat = torch.cat([
            like.new_zeros(n) if g is None else g.reshape(-1)
            for g, n in zip(grads, ctx.sizes)]).to(ctx.dtype)
        return (None, *(t.view(shape) for t, shape in
                        zip(flat.split(ctx.sizes), ctx.shapes)))


@contextlib.contextmanager
def cast_once(params: Sequence[torch.Tensor],
              dtype: Optional[torch.dtype]):
    """Within the block, `at(p, dtype)` of each of `params` returns one
    cast made on entry, so that a forward casts its parameters in a few
    launches and one autograd node, not one of each a use.  `params` share
    one dtype, and each is used once a forward (a second use would sum
    its gradients in `dtype`).  A remat recompute runs in the backward,
    outside the block, and casts at each use again: the same values."""
    if dtype is None or not params:
        yield
        return
    outer = _CASTS.table
    _CASTS.table = dict(zip(map(id, params), _CastAll.apply(dtype, *params)))
    try:
        yield
    finally:
        _CASTS.table = outer


class _Recompute(threading.local):
    """Set on the thread that recomputes a layer holding a BatchNorm, for
    that recompute: `TorchBatchNorm` then leaves its running statistics."""

    active = False


_RECOMPUTE = _Recompute()


def holds_batch_norm(layer: nn.Module) -> bool:
    """Whether a layer holds a `TorchBatchNorm`; looked up once a layer."""
    held = layer.__dict__.get("_holds_batch_norm")
    if held is None:
        held = any(isinstance(m, TorchBatchNorm) for m in layer.modules())
        layer.__dict__["_holds_batch_norm"] = held
    return held


def remat_layer(layer: nn.Module, gens: Optional[Generators],
                *xs: torch.Tensor) -> torch.Tensor:
    """layer(*xs, gens) under `torch.utils.checkpoint`: its activations are
    recomputed in the backward instead of kept, as `nn.remat` does.

    A recompute must see the dropout draws of the first run, and
    `checkpoint` restores only the global RNG states.  So the states of
    both explicit generators are taken before the first run, which
    advances them as an unchecked call would, and the recompute draws from
    copies of those states: the same seeds and bits, hence the same
    masks, and `gens` is not advanced twice.  A layer holding a BatchNorm
    is recomputed with its running statistics left as the first run moved
    them (the batch statistics it normalises with are recomputed alike)."""
    if gens is None and not holds_batch_norm(layer):
        return checkpoint(layer, *xs, None, use_reentrant=False,
                          preserve_rng_state=False)
    snap = None if gens is None \
        else (gens.seeds.get_state(), gens.bits.get_state())
    ran = []

    def run(*inner: torch.Tensor) -> torch.Tensor:
        if not ran:
            ran.append(True)
            return layer(*inner, gens)
        replay = None if snap is None else Generators(
            torch.Generator().set_state(snap[0]),
            torch.Generator(device=gens.bits.device).set_state(snap[1]))
        if not holds_batch_norm(layer):
            return layer(*inner, replay)
        _RECOMPUTE.active = True
        try:
            return layer(*inner, replay)
        finally:
            _RECOMPUTE.active = False

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


@functools.lru_cache(maxsize=64)
def _pe_on(seq_len: int, d_model: int, device: torch.device) -> torch.Tensor:
    """`sinusoidal_pe` made once a shape and device, for every forward
    after: a table copied from the host waits for the device's queue to
    drain (a pageable copy synchronises), so the host could not run ahead
    of the card.  Read only; made outside inference mode, so that training
    may use it after a served call."""
    with torch.inference_mode(False):
        return sinusoidal_pe(seq_len, d_model, device)


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
        pe = _pe_on(start + t, self.d_model, x.device)[start:]
        x = x + pe.to(x.dtype)  # in x's dtype, as the JAX table is made
        return self.dropout(x, bits(gens))


class TorchBatchNorm(nn.Module):
    """BatchNorm over channel axis 1 with `nn.BatchNorm2d`'s parameters,
    buffers and semantics (reference model.py:83-90), as the JAX
    `TorchBatchNorm`: y = (x - mean) * (rsqrt(var + eps) * weight) + bias.
    In training, mean and the biased variance of the batch normalise, and
    the running stats move by momentum 0.1 towards the mean and the
    unbiased variance (not again in a remat recompute, `remat_layer`); in
    eval, the running stats normalise.  Statistics and the map run in
    float32 (or wider) and the output is in x's dtype, as the JAX module
    computes a bf16 x.

    The default is that float32 chain, op by op, which the JAX package and
    the benchmark's reference compute for the visual stem: `F.batch_norm`
    sums in another order, and moved the stem's gradients several times
    further from theirs (PERF.md).  `one_op` (the conformer's convolution
    module, which has no mesh route) takes one `F.batch_norm` op each way
    instead, for its ~20 ops a block; there a remat recompute moves copies
    of the running stats, so that it saves what the first run saved."""

    mesh = None

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1, one_op: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.one_op = one_op
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        if self.one_op and self.mesh is None:
            return self._one_op(x_in)
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
            if not _RECOMPUTE.active:
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

    def _one_op(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.running_mean, self.running_var
        if self.training and _RECOMPUTE.active:
            mean, var = mean.clone(), var.clone()
        elif self.training:
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, mean, var, self.weight, self.bias,
                            self.training, self.momentum, self.eps)


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


def half_residual(module: nn.Module, y: torch.Tensor, x: torch.Tensor,
                  gens: Optional[Generators]) -> torch.Tensor:
    """x + Drop(y) / 2, the macaron FFN's residual: `dropout_add` with the
    survivor scale halved (one draw, one launch); x + y / 2 in eval mode
    or at rate 0."""
    rate = train_rate(module, module.dropout, gens)
    if rate == 0.0:
        return x + 0.5 * y
    n = quantized_rate(rate)
    return fused_dropout("dropout_add", y,
                         keep_bits(y.shape, gens.bits, y.device), n,
                         0.5 * keep_scale(n, y.dtype), x)


class ConformerFeedForward(nn.Module):
    """One macaron half: LayerNorm, Linear(d, 4d), SiLU + dropout,
    Linear(4d, d).  The dropout after it and the halved residual are the
    layer's (`half_residual`)."""

    def __init__(self, d_model: int, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.norm = LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.linear1 = Linear(d_model, 4 * d_model, dtype)
        self.linear2 = Linear(4 * d_model, d_model, dtype)

    def forward(self, x: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        h = silu_dropout(self.linear1(self.norm(x)),
                         train_rate(self, self.dropout, gens), bits(gens))
        return self.linear2(h)


class ConformerConvModule(nn.Module):
    """LayerNorm, Linear(d, 2d), GLU and the depthwise convolution over
    time (kernel K, centred zero padding; one kernel,
    `ops/kernels/glu_dwconv.py`), BatchNorm over (batch, time) with batch
    statistics in training (one op each way), SiLU,
    Linear(d, d).  The depthwise weight is
    an `nn.Conv1d(d, d, K, groups=d)`'s, (d, 1, K), drawn at fan-in K."""

    def __init__(self, d_model: int, kernel: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.norm = LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.pointwise1 = Linear(d_model, 2 * d_model, dtype)
        self.depthwise = nn.Conv1d(d_model, d_model, kernel,
                                   padding=(kernel - 1) // 2, groups=d_model)
        self.batch_norm = TorchBatchNorm(d_model, one_op=True)
        self.pointwise2 = Linear(d_model, d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        h = glu_dwconv(self.pointwise1(self.norm(x)),
                       at(self.depthwise.weight, cd),
                       at(self.depthwise.bias, cd))
        b, t, d = h.shape
        h = self.batch_norm(h.reshape(b * t, d)).view(b, t, d)
        # F.silu computes in float32 and rounds once to h's dtype.
        return self.pointwise2(F.silu(h))


class ConformerLayer(nn.Module):
    """The conformer block (Gulati et al. 2020; no relative-position term
    in MHSA, as torchaudio's):

        x = x + Drop(FFN1(x)) / 2
        x = x + Drop(MHSA(LN(x)))
        x = x + Drop(Conv(x))
        x = x + Drop(FFN2(x)) / 2
        y = LN(x)
    """

    def __init__(self, d_model: int, nhead: int, kernel: int,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.ffn1 = ConformerFeedForward(d_model, dropout, dtype)
        self.norm_attn = LayerNorm(d_model, eps=1e-5, dtype=dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout, dtype)
        self.drop_attn = Dropout(dropout)
        self.conv = ConformerConvModule(d_model, kernel, dtype)
        self.drop_conv = Dropout(dropout)
        self.ffn2 = ConformerFeedForward(d_model, dropout, dtype)
        self.norm_out = LayerNorm(d_model, eps=1e-5, dtype=dtype)

    def forward(self, x: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        x = half_residual(self, self.ffn1(x, gens), x, gens)
        h = self.norm_attn(x)
        x = self.drop_attn(self.self_attn(h, h, gens), bits(gens),
                           residual=x)
        x = self.drop_conv(self.conv(x), bits(gens), residual=x)
        x = half_residual(self, self.ffn2(x, gens), x, gens)
        return self.norm_out(x)


class ConformerEncoder(nn.Module):
    """Stack of conformer layers (each ends in its own LayerNorm); with
    `remat`, each layer is recomputed in the backward."""

    def __init__(self, d_model: int, nhead: int, num_layers: int,
                 kernel: int, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            ConformerLayer(d_model, nhead, kernel, dropout, dtype)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        return call_layers(self.layers, self.remat, gens, x)


def cast_parameters(model: nn.Module) -> List[nn.Parameter]:
    """The parameters that `model`'s modules cast to a compute dtype
    through `at`: every `Linear` and `Conv2d`'s, `MultiHeadAttention`'s
    input projection and the conformer's depthwise filter."""
    out = []
    for m in model.modules():
        if getattr(m, "compute_dtype", None) is None:
            continue
        if isinstance(m, (Linear, Conv2d)):
            out += [m.weight, m.bias]
        elif isinstance(m, MultiHeadAttention):
            out += [m.in_proj_weight, m.in_proj_bias]
        elif isinstance(m, ConformerConvModule):
            out += [m.depthwise.weight, m.depthwise.bias]
    return out
