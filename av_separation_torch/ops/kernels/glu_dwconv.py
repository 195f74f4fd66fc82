"""The conformer's GLU + depthwise convolution over time: the CUDA kernels
`csrc/glu_dwconv.cu` (one launch forward; the backward's data-and-weight
kernel and the weight gradient's fixed-order reduction), their plain
PyTorch version, and the autograd function around them.

  y = depthwise_conv_K(glu(u)) + bias      u (B, T, 2d) -> y (B, T, d)

glu(a || b) = a * sigmoid(b) over the last axis (`F.glu`); the convolution
runs over time, one K-tap filter a channel (weight (d, 1, K), as
`nn.Conv1d(d, d, K, groups=d)` holds it), centred zero padding (K odd).
The kernel widens its inputs, keeps glu(u) and every sum in float32 and
rounds y once to u's dtype; the plain version does the same (F.glu and the
grouped conv1d in float32 on the widened inputs), so in bf16 both differ
from a bf16 `F.glu` followed by a bf16 conv1d by glu(u) not being rounded.

Replaces no Pallas kernel: the JAX package has no conformer block.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from av_separation_torch.config import CONV_KERNELS
from av_separation_torch.ops import kernels, upcast
from av_separation_torch.ops.kernels import _build


def glu_dwconv_torch(u: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """Plain version, differentiable: u (B, T, 2d), w (d, 1, K) or (d, K),
    bias (d,) -> y (B, T, d) in u's dtype, computed in float32."""
    d = u.shape[-1] // 2
    k = w.shape[-1]
    g = F.glu(upcast(u), dim=-1)
    y = F.conv1d(g.transpose(1, 2), upcast(w).reshape(d, 1, k),
                 upcast(bias), padding=(k - 1) // 2, groups=d)
    return y.transpose(1, 2).to(u.dtype)


@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.load("glu_dwconv")
    fwd, groups, bwd = (lib.avsep_glu_dwconv_fwd, lib.avsep_glu_dwconv_groups,
                        lib.avsep_glu_dwconv_bwd)
    fwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    groups.argtypes = [ctypes.c_int] * 7
    bwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    for fn in (fwd, groups, bwd):
        fn.restype = ctypes.c_int
    return lib, fwd, groups, bwd


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def backward_groups(dtype_code: int, k: int, b: int, t: int, d: int,
                    index: int) -> int:
    """The backward's blocks along the (batch row, tile) items: its dw and
    dbias partials a slab of channels (the kernel's occupancy on this
    card)."""
    _, _, groups, _ = _entries()
    g = groups(dtype_code, k, b, t, d, _sms(index), index)
    if g < 1:
        raise RuntimeError(f"glu_dwconv: no backward plan for K {k}, "
                           f"B {b}, T {t}, d {d}")
    return g


def _check(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
           ) -> Tuple[int, int, int, int]:
    if u.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"glu_dwconv takes float32 or bfloat16, not "
                         f"{u.dtype}")
    if u.dim() != 3 or u.shape[-1] % 4 != 0:
        raise ValueError(f"u must be (B, T, 2d) with d even, not "
                         f"{tuple(u.shape)}")
    b, t, two_d = u.shape
    d, k = two_d // 2, w.shape[-1]
    if k not in CONV_KERNELS:
        raise ValueError(f"glu_dwconv's kernels are built for K in "
                         f"{CONV_KERNELS}, not {k}")
    if w.numel() != d * k or bias.shape != (d,):
        raise ValueError(f"w must hold (d, K) = ({d}, {k}) and bias (d,)")
    for x in (w, bias):
        if x.dtype != u.dtype or x.device != u.device:
            raise ValueError(f"w and bias must be {u.dtype} on {u.device}")
    if not 1 <= b <= 65535:
        raise ValueError(f"glu_dwconv takes 1 to 65,535 rows, not {b}")
    return b, t, d, k


def glu_dwconv_fwd_cuda(u: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """One forward launch on the card."""
    b, t, d, k = _check(u, w, bias)
    u, w, bias = u.contiguous(), w.contiguous(), bias.contiguous()
    y = torch.empty((b, t, d), dtype=u.dtype, device=u.device)
    index = u.device.index
    lib, fwd, _, _ = _entries()
    rc = fwd(kernels.DTYPE_CODES[u.dtype], k, u.data_ptr(), w.data_ptr(),
             bias.data_ptr(), y.data_ptr(), b, t, d, index,
             kernels.stream(u.device))
    _build.check(lib, rc, "glu_dwconv_fwd")
    kernels.count_launch("glu_dwconv_fwd", u.dtype)
    return y


def glu_dwconv_bwd_cuda(u: torch.Tensor, w: torch.Tensor,
                        dy: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """du, dw (d, K) and dbias from dy on the card: the data-and-weight
    kernel, then the partials' reduction."""
    b, t, d, k = _check(u, w, w.new_empty(u.shape[-1] // 2))
    if dy.shape != (b, t, d) or dy.dtype != u.dtype:
        raise ValueError(f"dy must be ({b}, {t}, {d}) of {u.dtype}")
    u, w, dy = u.contiguous(), w.contiguous(), dy.contiguous()
    index = u.device.index
    code = kernels.DTYPE_CODES[u.dtype]
    groups = backward_groups(code, k, b, t, d, index)
    du = torch.empty_like(u)
    partial = torch.empty((groups, k + 1, d), dtype=torch.float32,
                          device=u.device)
    dw = torch.empty((d, k), dtype=u.dtype, device=u.device)
    dbias = torch.empty((d,), dtype=u.dtype, device=u.device)
    lib, _, _, bwd = _entries()
    rc = bwd(code, k, u.data_ptr(), w.data_ptr(), dy.data_ptr(),
             du.data_ptr(), partial.data_ptr(), dw.data_ptr(),
             dbias.data_ptr(), b, t, d, groups, index,
             kernels.stream(u.device))
    _build.check(lib, rc, "glu_dwconv_bwd")
    kernels.count_launch("glu_dwconv_bwd", u.dtype)
    return du, dw, dbias


class GluDwConv(torch.autograd.Function):
    """y = glu_dwconv(u, w, bias) on the card; saves u and w."""

    @staticmethod
    def forward(ctx, u, w, bias):
        ctx.save_for_backward(u, w)
        return glu_dwconv_fwd_cuda(u, w, bias)

    @staticmethod
    def backward(ctx, dy):
        u, w = ctx.saved_tensors
        du, dw, dbias = glu_dwconv_bwd_cuda(u, w, dy)
        return du, dw.view_as(w), dbias


def glu_dwconv(u: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Differentiable GLU + depthwise convolution over time.  CPU tensors
    take the plain version; CUDA tensors launch the kernels."""
    if u.device.type == "cpu":
        return glu_dwconv_torch(u, w, bias)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    return GluDwConv.apply(u, w, bias)
