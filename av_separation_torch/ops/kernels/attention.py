"""Flash attention: the CUDA kernels `csrc/flash_attn_fwd.cu` and
`csrc/flash_attn_bwd.cu`, their plain PyTorch versions, and the autograd
function that joins them.

Port of `av_separation_tpu/ops/pallas/attention.py`: the forward kernels
(`_fwd_hpacked_kernel` on the packed (B, T, H*dh) layout, `_fwd_packed_kernel`
on the split (B*H, T, dh) layout, the multi-block `_fwd_kernel`) and the
backward kernels (`_bwd_hpacked_kernel`, `_bwd_packed_kernel` and the
multi-block `_delta_kernel` / `_dq_kernel` / `_dkv_kernel`).  Every layout
reaches the kernels as (B, H, T, dh) views whose strides say where each
(batch, head, time) row lies; the head dim must be contiguous.  Outputs and
gradients are written into packed (B, T, H, dh) memory and returned as
(B, H, T, dh) views, so a packed caller gets (B, T, H*dh) back without a copy.

Attention dropout is the JAX package's stateless murmur3-finalizer hash
(`_keep_mask`, attention.py:147-160, the path its kernels take under the
interpreter) over the tile coordinates of the Pallas grid: tile
(b*H + h, row // BQ, col // BK) and in-tile (row % BQ, col % BK), with
BQ = min(512, ceil16(Tq)) and BK = min(512, ceil128(Tk)).  So the keep masks
of the forward, of both backward passes, of the plain versions and of the
JAX kernels in interpret mode are the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from av_separation_torch.ops import kernels
from av_separation_torch.ops.kernels import _build

HEAD_DIMS = (32, 128)  # demo (128 / 4 heads) and every wider config
MAX_HASH_BLOCK = 512   # the Pallas kernels' DEFAULT_BLOCK_Q / _K
_M32 = 0xFFFFFFFF


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def hash_tiles(tq: int, tk: int) -> Tuple[int, int]:
    """(BQ, BK): the Pallas grid's block sizes, which key the dropout hash."""
    return (min(MAX_HASH_BLOCK, _cdiv(tq, 16) * 16),
            min(MAX_HASH_BLOCK, _cdiv(tk, 128) * 128))


def keep_threshold(rate: float) -> int:
    """uint32 threshold: an element is kept when its hash is >= it (exact
    rate, not quantized like the residual dropout)."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 a in [0, 2**32): split in 16-bit halves
    so no int64 product overflows (torch has no uint32 arithmetic on the
    CPU)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def keep_mask(seed: int, b: int, h: int, tq: int, tk: int, rate: float,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """The (B, H, Tq, Tk) bool keep mask of one attention call.

    Bit for bit the Pallas `_keep_mask` hash (attention.py:147-160) with the
    Pallas grid's tile coordinates; the CUDA kernels compute the same hash
    per element.
    """
    bq, bk = hash_tiles(tq, tk)
    kw = dict(dtype=torch.int64, device=device)
    rows = torch.arange(tq, **kw)
    cols = torch.arange(tk, **kw)
    bh = torch.arange(b * h, **kw).view(b, h, 1, 1)
    tile = (((seed & _M32) * 0x9E3779B9) & _M32) ^ _mul32(bh, 0x85EBCA6B) \
        ^ _mul32(rows // bq, 0xC2B2AE35).view(tq, 1) \
        ^ _mul32(cols // bk, 0x27D4EB2F).view(1, tk)
    x = (_mul32(rows % bq, 0x01000193).view(tq, 1)
         + _mul32(cols % bk, 0x61C88647).view(1, tk) + tile) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= keep_threshold(rate)


def _as_packed(o: torch.Tensor) -> torch.Tensor:
    """(B, H, T, dh) -> the same values in (B, T, H, dh) memory."""
    return o.transpose(1, 2).contiguous().transpose(1, 2)


def _packed_empty(like: torch.Tensor) -> torch.Tensor:
    """An uninitialised (B, H, T, dh) view of packed (B, T, H, dh) memory."""
    b, h, t, dh = like.shape
    return torch.empty((b, t, h, dh), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def flash_attn_fwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rate: float = 0.0, seed: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (B, H, Tq, dh), (B, H, Tk, dh) -> (o, lse (B, H, Tq)).

    The Pallas kernel's arithmetic: s = q k^T * scale, p = exp(s - max),
    l = sum(p) over the undropped p, dropped p zeroed before PV,
    o = (p v) / (l * (1 - rate)), lse = max + log(l).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        b, h, tq, _ = q.shape
        keep = keep_mask(seed, b, h, tq, k.shape[2], rate, q.device)
        p = torch.where(keep, p, 0.0)
    o = torch.matmul(p, v) / (l * (1.0 - rate))
    return _as_packed(o), (m + torch.log(l)).squeeze(-1)


def flash_attn_bwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                         rate: float = 0.0, seed: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward: -> (dq, dk, dv), shaped like q, k, v.

    The Pallas arithmetic (`_bwd_hpacked_kernel`): delta = rowsum(dO * O),
    p = exp(s - lse), dp = dO V^T masked and divided by (1 - rate) where
    kept, dV = pd^T dO with pd = keep ? p / (1 - rate) : 0,
    ds = p (dp - delta) scale, dQ = ds K, dK = ds^T Q.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    delta = (do * o).sum(dim=-1, keepdim=True)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.matmul(do, v.transpose(-1, -2))
    pd = p
    if rate > 0.0:
        b, h, tq, _ = q.shape
        keep = keep_mask(seed, b, h, tq, k.shape[2], rate, q.device)
        pd = torch.where(keep, p / (1.0 - rate), 0.0)
        dp = torch.where(keep, dp / (1.0 - rate), 0.0)
    dv = torch.matmul(pd.transpose(-1, -2), do)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return _as_packed(dq), _as_packed(dk), _as_packed(dv)


@functools.lru_cache(maxsize=None)
def _fwd_entry():
    lib = _build.load("flash_attn_fwd")
    fn = lib.avsep_flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_uint,
                      ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    lib = _build.load("flash_attn_bwd")
    fn = lib.avsep_flash_attn_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_uint,
                      ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _rows_ok(t: torch.Tensor) -> bool:
    """Head dim contiguous and every (batch, head, time) row 16-byte
    aligned, as the kernels' float4 loads need."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and not any(
        t.stride(i) % 4 for i in range(3) if t.shape[i] > 1)


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {like.device}")
    if not _rows_ok(t):
        raise ValueError(f"{name} rows must have a contiguous head dim and "
                         f"be 16-byte aligned")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, H, T, dh) views")
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
        _check_rows(name, t, q)


def _dropout_args(rate: float, seed: int, tq: int, tk: int):
    """(keep, threshold, seed as uint32, BQ, BK, on) for the C entry points."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    hq, hk = hash_tiles(tq, tk)
    return (1.0 - rate, keep_threshold(rate), seed & _M32, hq, hk,
            int(rate > 0.0))


def _device(q: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return True


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   rate: float = 0.0, seed: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T / sqrt(dh)) v over (B, H, T, dh) views, with attention
    dropout at `rate` keyed by the int32 `seed`.

    Returns (o, lse): o (B, H, Tq, dh) as a view of packed (B, Tq, H, dh)
    memory, lse (B, H, Tq) float32.  CPU tensors take the plain version;
    CUDA tensors launch the kernel.
    """
    if not _device(q):
        return flash_attn_fwd_torch(q, k, v, rate, seed)
    _check(q, k, v)
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    o = _packed_empty(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib, fn = _fwd_entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], 1.0 / math.sqrt(dh),
            *_dropout_args(rate, seed, tq, tk), q.device.index, stream)
    _build.check(lib, rc, "flash_attn_fwd")
    kernels.LAUNCHES["flash_attn_fwd"] += 1
    return o, lse


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                   rate: float = 0.0, seed: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of `flash_attn_fwd` for the output cotangent
    `do`, from the forward's o and lse; each a (B, H, T, dh) view of packed
    (B, T, H, dh) memory.  The dropout mask is regenerated from `seed`.

    CPU tensors take the plain version; CUDA tensors launch the three
    kernels of `csrc/flash_attn_bwd.cu` (delta, dK/dV, dQ): no atomics, so
    two runs give bit-identical gradients.
    """
    if not _device(q):
        return flash_attn_bwd_torch(q, k, v, o, do, lse, rate, seed)
    _check(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(q.shape)}")
        _check_rows(name, t, q)
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    if lse.shape != (b, h, tq) or not lse.is_contiguous() \
            or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError("lse must be a contiguous float32 (B, H, Tq) tensor")
    dq, dk, dv = _packed_empty(q), _packed_empty(k), _packed_empty(v)
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]]
    lib, fn = _bwd_entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, tq, tk, dh,
            (ctypes.c_longlong * len(strides))(*strides),
            1.0 / math.sqrt(dh), *_dropout_args(rate, seed, tq, tk),
            q.device.index, stream)
    _build.check(lib, rc, "flash_attn_bwd")
    kernels.LAUNCHES["flash_attn_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward kernel: the forward saves
    q, k, v, o and lse (and the seed), the backward recomputes p tile by
    tile, as `_flash_hpacked_fwd_rule` / `_flash_hpacked_bwd_rule` do."""

    @staticmethod
    def forward(ctx, q, k, v, rate: float, seed: int):
        o, lse = flash_attn_fwd(q, k, v, rate, seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.rate, ctx.seed = rate, seed
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type == "cuda" and not _rows_ok(do):
            do = _as_packed(do)
        dq, dk, dv = flash_attn_bwd(q, k, v, o, do, lse, ctx.rate, ctx.seed)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rate: float = 0.0, seed: Optional[int] = None
                    ) -> torch.Tensor:
    """Differentiable flash attention over (B, H, T, dh) views."""
    if rate > 0.0 and seed is None:
        raise ValueError("dropout rate > 0 needs a seed")
    return FlashAttention.apply(q, k, v, float(rate), seed or 0)
