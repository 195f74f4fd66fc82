"""The model's dropout sites, fused: the CUDA kernels `csrc/dropout_fused.cu`
(one launch forward, one backward, a site), their plain PyTorch version,
and the autograd function around them.

A site draws its uint8 bits (`ops/dropout.py:keep_bits`) and hands them
here as drawn; an element is kept where its bits are >= n, and survivors
are scaled by `keep_scale(n, dtype)`.  Five epilogues:

  dropout       keep ? x*s : 0                 (positional encoding)
  dropout_add   res + (keep ? x*s : 0)         (drop1 / drop2 and the add)
  relu_dropout  keep ? relu(x)*s : 0           (the encoder FFN)
  gelu_dropout  keep ? gelu(x)*s : 0           (the fusion FFN, the decoder)
  silu_dropout  keep ? silu(x)*s : 0           (the conformer's FFNs)

The backward of dropout and dropout_add is keep ? g*s : 0 (the residual's
gradient is g itself); relu_dropout's reads its saved output, out > 0 ?
g*s : 0; gelu_dropout's and silu_dropout's recompute the activation's
derivative from x.
The saved mask is the uint8 draw itself.  The plain version is the chain
of PyTorch ops the model ran before the kernels, kept bit for bit; the
kernels round where it rounds.

Replaces no Pallas kernel: the JAX package leaves this chain to XLA's
fusion (`av_separation_tpu/ops/dropout.py`, `ops/activations.py`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from av_separation_torch.ops import kernels, upcast
from av_separation_torch.ops.kernels import _build

EPILOGUES = ("dropout", "dropout_add", "relu_dropout", "gelu_dropout",
             "silu_dropout")
# The epilogues whose backward recomputes the activation's derivative from
# the saved x.
_SAVES_X = ("gelu_dropout", "silu_dropout")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU computed in float32 (or wider), in x's dtype."""
    return F.gelu(upcast(x)).to(x.dtype)


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx [x Phi(x)] = Phi(x) + x phi(x), exact (erf) GELU."""
    cdf = 0.5 * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))
    pdf = torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))
    return cdf + x * pdf


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU computed in float32 (or wider), in x's dtype."""
    return F.silu(upcast(x)).to(x.dtype)


def silu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx [x sigmoid(x)] = s (1 + x (1 - s)), s = 1 / (1 + exp(-x)),
    one float32 op at a time (the kernel repeats the sequence)."""
    sig = 1.0 / (1.0 + torch.exp(-x))
    return sig * (1.0 + x * (1.0 - sig))


def dropout_fwd_torch(kind: str, x: torch.Tensor, bits: torch.Tensor,
                      n: int, scale: float,
                      res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the forward of epilogue `kind`."""
    keep = bits >= n
    if kind == "relu_dropout":
        x = torch.relu(x)
    elif kind == "gelu_dropout":
        x = gelu(x)
    elif kind == "silu_dropout":
        x = silu(x)
    out = torch.where(keep, x * scale, 0.0)
    return res + out if kind == "dropout_add" else out


def dropout_bwd_torch(kind: str, g: torch.Tensor,
                      saved: Optional[torch.Tensor],
                      bits: Optional[torch.Tensor], n: int,
                      scale: float) -> torch.Tensor:
    """Plain version of the backward: dx from g.  `saved` is the forward's
    output (relu_dropout) or its x (gelu_dropout, silu_dropout), unused
    otherwise."""
    if kind == "relu_dropout":
        return torch.where(saved > 0, g * scale, 0.0)
    keep = bits >= n
    if kind == "gelu_dropout":
        g = g * gelu_grad(upcast(saved)).to(saved.dtype)
    elif kind == "silu_dropout":
        g = g * silu_grad(upcast(saved)).to(saved.dtype)
    return torch.where(keep, g * scale, 0.0)


@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.load("dropout_fused")
    fns = (lib.avsep_dropout_fwd, lib.avsep_dropout_bwd)
    for fn in fns:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                       + [ctypes.c_longlong] * 3
                       + [ctypes.c_int, ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fns


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_stride(bits: torch.Tensor) -> int:
    """Bytes between the rows of a draw whose last dim is contiguous and
    whose leading dims are one run of rows (a full draw, or a column block
    of a wider one); raises for any other layout."""
    if bits.dim() < 2:
        return bits.shape[-1] if bits.dim() else 1
    shape, stride = bits.shape, bits.stride()
    rows_ok = all(stride[i] == stride[i + 1] * shape[i + 1]
                  for i in range(bits.dim() - 2))
    if stride[-1] != 1 or not rows_ok or stride[-2] < shape[-1]:
        raise ValueError(f"dropout bits of shape {tuple(shape)} and strides "
                         f"{stride}: rows of a contiguous draw expected")
    return stride[-2]


def _launch(bwd: bool, kind: str, a: torch.Tensor,
            other: Optional[torch.Tensor], bits: Optional[torch.Tensor],
            n: int, scale: float) -> torch.Tensor:
    """One launch: `a` is x (forward) or g, `other` res or the saved
    tensor, `bits` the draw (None for relu_dropout's backward)."""
    if a.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"dropout kernels take float32 or bfloat16, not "
                         f"{a.dtype}")
    if bits is not None and (bits.dtype != torch.uint8
                             or bits.shape != a.shape):
        raise ValueError(f"bits must be uint8 of shape {tuple(a.shape)}")
    a = a.contiguous()
    if other is not None:
        if other.shape != a.shape or other.dtype != a.dtype:
            raise ValueError(f"{'saved' if bwd else 'res'} must match x: "
                             f"{tuple(a.shape)} {a.dtype}")
        other = other.contiguous()
    for t in (other, bits):
        if t is not None and t.device != a.device:
            raise ValueError(f"dropout tensors must be on {a.device}")
    out = torch.empty_like(a)
    numel = a.numel()
    if numel == 0:
        return out
    cols = a.shape[-1] if a.dim() else 1
    ld = cols if bits is None else row_stride(bits)
    # 16-byte vectors of `per` elements, their draws `per` bytes.
    per = 16 // a.element_size()
    vec = cols % per == 0 and ld % per == 0 \
        and all(t.data_ptr() % 16 == 0 for t in (a, other, out)
                if t is not None) \
        and (bits is None or bits.data_ptr() % per == 0)
    index = a.device.index
    lib, fns = _entries()
    rc = fns[bwd](kernels.DTYPE_CODES[a.dtype], EPILOGUES.index(kind),
                  a.data_ptr(), 0 if other is None else other.data_ptr(),
                  0 if bits is None else bits.data_ptr(), out.data_ptr(),
                  numel, cols, ld, n, scale, int(vec), _sms(index), index,
                  kernels.stream(a.device))
    name = "dropout_bwd" if bwd else "dropout_fwd"
    _build.check(lib, rc, name)
    kernels.count_launch(name, a.dtype)
    return out


def dropout_fwd(kind: str, x: torch.Tensor, bits: torch.Tensor, n: int,
                scale: float,
                res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward of epilogue `kind` (`res` for dropout_add alone).  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return dropout_fwd_torch(kind, x, bits, n, scale, res)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(False, kind, x, res, bits, n, scale)


def dropout_bwd(kind: str, g: torch.Tensor, saved: Optional[torch.Tensor],
                bits: Optional[torch.Tensor], n: int,
                scale: float) -> torch.Tensor:
    """dx from g for epilogue `kind`, dispatched as `dropout_fwd`."""
    if g.device.type == "cpu":
        return dropout_bwd_torch(kind, g, saved, bits, n, scale)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    return _launch(True, kind, g, saved, bits, n, scale)


class FusedDropout(torch.autograd.Function):
    """out = dropout_fwd(kind, x, bits, n, scale, res); saves the draw (and
    x for GELU and SiLU), or relu_dropout's output alone."""

    @staticmethod
    def forward(ctx, x, res, bits, kind: str, n: int, scale: float):
        out = dropout_fwd(kind, x, bits, n, scale, res)
        if kind == "relu_dropout":
            ctx.save_for_backward(out, None)
        else:
            ctx.save_for_backward(x if kind in _SAVES_X else None, bits)
        ctx.kind, ctx.n, ctx.scale = kind, n, scale
        return out

    @staticmethod
    def backward(ctx, g):
        saved, bits = ctx.saved_tensors
        dx = dropout_bwd(ctx.kind, g, saved, bits, ctx.n, ctx.scale)
        g_res = g if ctx.kind == "dropout_add" else None
        return dx, g_res, None, None, None, None


def fused_dropout(kind: str, x: torch.Tensor, bits: torch.Tensor, n: int,
                  scale: float,
                  res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable epilogue `kind` over the draw `bits`."""
    return FusedDropout.apply(x, res, bits, kind, n, scale)
