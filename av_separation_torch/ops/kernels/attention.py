"""Flash attention forward: the CUDA kernel `csrc/flash_attn_fwd.cu` and its
plain PyTorch version.

Port of the forward kernels of `av_separation_tpu/ops/pallas/attention.py`
(`_fwd_hpacked_kernel` on the packed (B, T, H*dh) layout, `_fwd_packed_kernel`
on the split (B*H, T, dh) layout).  Both layouts reach the one kernel as
(B, H, T, dh) views whose strides say where each (batch, head, time) row
lies; the head dim must be contiguous.  The output is written into packed
(B, Tq, H, dh) memory and returned as its (B, H, Tq, dh) view, so the packed
caller gets (B, Tq, H*dh) back without a copy.  No dropout: serving is
deterministic (the Philox dropout comes with the backward kernel).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from av_separation_torch.ops import kernels
from av_separation_torch.ops.kernels import _build

HEAD_DIMS = (32, 128)  # demo (128 / 4 heads) and every wider config


def _as_packed(o: torch.Tensor) -> torch.Tensor:
    """(B, H, T, dh) -> the same values in (B, T, H, dh) memory."""
    return o.transpose(1, 2).contiguous().transpose(1, 2)


def flash_attn_fwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (B, H, Tq, dh), (B, H, Tk, dh) -> (o, lse (B, H, Tq)).

    The Pallas kernel's arithmetic: s = q k^T * scale, p = exp(s - max),
    o = (p v) / sum(p), lse = max + log(sum(p)).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v) / l
    return _as_packed(o), (m + torch.log(l)).squeeze(-1)


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("flash_attn_fwd")
    fn = lib.avsep_flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attn_fwd takes (B, H, T, dh) views")
    b, h, tq, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if tq == 0 or k.shape[2] == 0:
        raise ValueError("empty sequence")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} head dim must be contiguous")
        if any(t.stride(i) % 4 for i in range(3) if t.shape[i] > 1) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} rows must be 16-byte aligned")


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T / sqrt(dh)) v over (B, H, T, dh) views.

    Returns (o, lse): o (B, H, Tq, dh) as a view of packed (B, Tq, H, dh)
    memory, lse (B, H, Tq) float32.  CPU tensors take the plain version;
    CUDA tensors launch the kernel.
    """
    if q.device.type == "cpu":
        return flash_attn_fwd_torch(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v)
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    o = torch.empty((b, tq, h, dh), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib, fn = _entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], 1.0 / math.sqrt(dh), q.device.index, stream)
    _build.check(lib, rc, "flash_attn_fwd")
    kernels.LAUNCHES["flash_attn_fwd"] += 1
    return o, lse
