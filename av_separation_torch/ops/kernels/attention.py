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

The kernels are built for head dims 32, 64, 128 and 256, and for every
multiple of 128 above 256.  bfloat16 at 32-256 runs on the Hopper kernels
of `csrc/flash_fwd_wgmma.cu` and `csrc/flash_bwd_wgmma.cu` (`wgmma`, TMA,
mbarriers); float32 at 32-256 on the 3xTF32 `mma.sync` kernels (256 on
8-warp blocks, two warps to each 16 rows, one 128-column half each, that
add their partial q k^T (and dO v^T) through shared memory, so no product
is computed twice).  Above 256 a thread-block cluster
shares each tile of rows, each block owning 128-column chunks of the head
dim (`csrc/cluster.cuh`): one chunk a block up to dh 2048 (a cluster of
dh / 128 blocks), ceil(dh / 2048) above, where the accumulators of a
block's chunks after its first live in a scratch buffer.  Each block
computes its chunks' partial q k^T (and dO v^T), the cluster sums the
partials in block order through distributed shared memory, and each block
takes its own columns of p v and of the gradients, so no product is
computed twice.
The bf16 forward runs there on `wgmma` (`flash_fwd_wgmma.cu`), the float32
forward and both backwards on `mma.sync` (`flash_attn_fwd.cu`,
`flash_attn_bwd.cu`).  Any other head dim is zero-padded to the next built
one (`padded_fwd`, `padded_bwd`) and run at the softmax scale of its true
width: zero columns change neither q k^T nor the kept columns of p v, and
the gradients are sliced back.

In bfloat16 (q, k, v and the cotangent bf16; lse float32) the kernels and
the plain versions round where the Pallas kernels do: products of bf16
operands summed in float32, p rounded to bf16 before p v, pd and ds
rounded to bf16 before their products, and o, dq, dk, dv stored in bf16.

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
import torch.nn.functional as F

from av_separation_torch.ops import kernels, upcast
from av_separation_torch.ops.kernels import _build

# demo (d 128, 4 heads), ModelConfig() (d 256, 4 heads), every wider config,
# and ModelConfig(d_model=512, nhead=2) (dh 256); above 256 every multiple
# of WIDE_CHUNK (ModelConfig(d_model=1024, nhead=2): dh 512)
HEAD_DIMS = (32, 64, 128, 256)
WIDE_CHUNK = 128
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


def padded_head_dim(dh: int) -> int:
    """The built head dim a head dim of `dh` runs at: the next of
    HEAD_DIMS up to 256, the next multiple of 128 above.  Above 256 the
    full-width q and k tiles no longer fit a block's shared memory, so a
    thread-block cluster shares the rows, each block owning 128-column
    chunks of every operand (one up to dh 2048; `csrc/cluster.cuh`)."""
    for built in HEAD_DIMS:
        if dh <= built:
            return built
    return _cdiv(dh, WIDE_CHUNK) * WIDE_CHUNK


def wgmma_route(dtype: torch.dtype, dh: int) -> bool:
    """True where a CUDA call runs on the `wgmma` kernels of both passes:
    bfloat16 at a built head dim up to 256.  (Above 256 the bf16 forward
    runs on `flash_fwd_wgmma.cu`'s cluster kernel, the backward on
    `flash_attn_bwd.cu`'s.)"""
    return dtype == torch.bfloat16 and dh in HEAD_DIMS


def _pad_dh(t: torch.Tensor, width: int) -> torch.Tensor:
    return F.pad(t, (0, width - t.shape[-1]))


def padded_fwd(fwd, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               rate: float = 0.0, seed: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`fwd` (a flash forward taking `scale`) at any head dim: q, k
    and v zero-padded along dh to `padded_head_dim`, the softmax scale of
    the true dh, o sliced back.  The dropout hash does not read dh, so the
    keep masks are those of the unpadded call."""
    dh = q.shape[-1]
    width = padded_head_dim(dh)
    if width == dh:
        return fwd(q, k, v, rate, seed)
    o, lse = fwd(_pad_dh(q, width), _pad_dh(k, width), _pad_dh(v, width),
                 rate, seed, scale=1.0 / math.sqrt(dh))
    return o[..., :dh], lse


def padded_bwd(bwd, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
               rate: float = 0.0, seed: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`bwd` (a flash backward taking `scale`) at any head dim, as
    `padded_fwd`: the padded columns of o and dO are zero, so delta is
    unchanged, and dq, dk, dv are sliced back."""
    dh = q.shape[-1]
    width = padded_head_dim(dh)
    if width == dh:
        return bwd(q, k, v, o, do, lse, rate, seed)
    grads = bwd(*(_pad_dh(t, width) for t in (q, k, v, o, do)), lse, rate,
                seed, scale=1.0 / math.sqrt(dh))
    return tuple(g[..., :dh] for g in grads)


def flash_attn_fwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rate: float = 0.0, seed: int = 0,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (B, H, Tq, dh), (B, H, Tk, dh) -> (o, lse (B, H, Tq)).

    The Pallas kernel's arithmetic: s = q k^T * scale, p = exp(s - max),
    l = sum(p) over the undropped p, dropped p zeroed before PV,
    o = (p v) / (l * (1 - rate)), lse = max + log(l).  `scale` defaults to
    1 / sqrt(dh).  In bf16 the products take bf16 operands (exact in
    float32) and sum in float32, p is rounded to bf16 before PV, and o is
    returned in bf16; lse is float32.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = upcast(q), upcast(k), upcast(v)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        b, h, tq, _ = q.shape
        keep = keep_mask(seed, b, h, tq, k.shape[2], rate, q.device)
        p = torch.where(keep, p, 0.0)
    o = torch.matmul(_rounded(p, v.dtype), vf) / (l * (1.0 - rate))
    return _as_packed(o.to(q.dtype)), (m + torch.log(l)).squeeze(-1)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 x rounded to bf16 (nearest even) and back, the operand a
    bf16 product reads; x itself at float32 and float64."""
    return x.to(dtype).float() if dtype == torch.bfloat16 else x


def flash_attn_bwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                         rate: float = 0.0, seed: int = 0,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward: -> (dq, dk, dv), shaped like q, k, v.

    The Pallas arithmetic (`_bwd_hpacked_kernel`): delta = rowsum(dO * O),
    p = exp(s - lse), dp = dO V^T masked and divided by (1 - rate) where
    kept, dV = pd^T dO with pd = keep ? p / (1 - rate) : 0,
    ds = p (dp - delta) scale, dQ = ds K, dK = ds^T Q.  In bf16, delta and
    every product sum in float32, pd and ds are rounded to bf16 before
    their products, and dq, dk, dv are returned in bf16.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dt = q.dtype
    qf, kf, vf, of, dof = (upcast(t) for t in (q, k, v, o, do))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    pd = p
    if rate > 0.0:
        b, h, tq, _ = q.shape
        keep = keep_mask(seed, b, h, tq, k.shape[2], rate, q.device)
        pd = torch.where(keep, p / (1.0 - rate), 0.0)
        dp = torch.where(keep, dp / (1.0 - rate), 0.0)
    dv = torch.matmul(_rounded(pd, dt).transpose(-1, -2), dof)
    ds = _rounded(p * (dp - delta) * scale, dt)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return tuple(_as_packed(g.to(dt)) for g in (dq, dk, dv))


@functools.lru_cache(maxsize=None)
def _fwd_entry():
    lib = _build.load("flash_attn_fwd")
    fn = lib.avsep_flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_uint,
                      ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _wgmma_fwd_entry():
    lib = _build.load("flash_fwd_wgmma")
    fn = lib.avsep_flash_fwd_wgmma
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_uint,
                      ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _wgmma_bwd_entry():
    lib = _build.load("flash_bwd_wgmma")
    fn = lib.avsep_flash_bwd_wgmma
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_uint,
                      ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def tma_encode_us(t: torch.Tensor, iters: int = 1000) -> float:
    """Host microseconds of one TMA tensor-map encode over the (B, H, T,
    dh) bf16 view `t`, as the `wgmma` forward encodes q, k and v on every
    call (a measurement; no kernel launches)."""
    lib = _build.load("flash_fwd_wgmma")
    fn = lib.avsep_tma_encode_us
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int])
    fn.restype = ctypes.c_double
    b, h, tt, dh = t.shape
    return fn(t.data_ptr(), dh, h, tt, b, t.stride(1), t.stride(2),
              t.stride(0), iters)


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    lib = _build.load("flash_attn_bwd")
    fn = lib.avsep_flash_attn_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_uint,
                      ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _scratch_entry(source: str, symbol: str, n_sizes: int):
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = [ctypes.c_int] * n_sizes
    fn.restype = ctypes.c_longlong
    return fn


def _scratch(source: str, symbol: str, device: torch.device,
             *sizes: int) -> Optional[torch.Tensor]:
    """The scratch buffer of a cluster launch above head dim 128 * 16,
    whose blocks own several column chunks and keep the accumulators of
    all but the first there (csrc/cluster.cuh): as many bytes as the
    library's `symbol` says for these sizes; None (a null pointer) where it
    takes none."""
    nbytes = _scratch_entry(source, symbol, len(sizes))(*sizes)
    if not nbytes:
        return None
    return torch.empty(nbytes // 4, dtype=torch.float32, device=device)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


DELTA_ROWS = 4  # query rows a delta block (one warp a row)


def _rows_ok(t: torch.Tensor) -> bool:
    """Head dim contiguous and every (batch, head, time) row 16-byte
    aligned, as the kernels' 16-byte copies need."""
    vec = 16 // t.element_size()
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and not any(
        t.stride(i) % vec for i in range(3) if t.shape[i] > 1)


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device or t.dtype != like.dtype \
            or t.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"{name} must be float32 or bfloat16, as q, on "
                         f"{like.device}")
    if not _rows_ok(t):
        raise ValueError(f"{name} rows must have a contiguous head dim and "
                         f"be 16-byte aligned")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           backward: bool = False) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, H, T, dh) views")
    b, h, tq, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if dh not in HEAD_DIMS and (dh < HEAD_DIMS[-1] or dh % WIDE_CHUNK):
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS} nor a multiple "
                         f"of {WIDE_CHUNK} above {HEAD_DIMS[-1]}")
    if tq == 0 or k.shape[2] == 0:
        raise ValueError("empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t, q)
    # Every launch puts B*H in grid x beside its row tiles (grid_fold.cuh):
    # the most blocks are the delta kernel's (4 query rows a block) or the
    # dK/dV kernel's (64 keys) in a backward, the forward's (64 rows a
    # block at least) otherwise.
    tiles = max(_cdiv(tq, DELTA_ROWS), _cdiv(k.shape[2], 64)) if backward \
        else _cdiv(tq, 64)
    blocks = tiles * b * h
    if blocks > kernels.GRID_X_MAX:
        raise ValueError(f"B*H = {b * h} at T {tq}: {blocks} blocks in "
                         f"grid x, above its {kernels.GRID_X_MAX}")


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

    Returns (o, lse): o (B, H, Tq, dh) in q's dtype (float32 or bfloat16)
    as a view of packed (B, Tq, H, dh) memory, lse (B, H, Tq) float32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (in
    bfloat16 one of `flash_fwd_wgmma.cu`), at a head dim that is not built
    through `padded_fwd` (and then o is a slice of the padded memory).
    """
    if not _device(q):
        return flash_attn_fwd_torch(q, k, v, rate, seed)
    return padded_fwd(_launch_fwd, q, k, v, rate, seed)


def fwd_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rate: float,
             seed: int, scale: Optional[float] = None):
    """(o, lse, scratch, args): the outputs of one forward launch at a
    built head dim, its scratch buffer (None up to dh 2048; to be held
    until the launch) and the arguments of a C forward entry point up to
    the device (both entry points take them; `avsep_flash_attn_fwd` the
    dtype code after them; both the device, the stream and the scratch
    pointer last)."""
    _check(q, k, v)
    b, h, tq, dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    tk = k.shape[2]
    o = _packed_empty(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], scale, *_dropout_args(rate, seed, tq, tk))
    if q.dtype == torch.bfloat16:
        scratch = _scratch("flash_fwd_wgmma", "avsep_flash_fwd_wgmma_scratch",
                           q.device, b, h, tq, dh)
    else:
        scratch = _scratch("flash_attn_fwd", "avsep_flash_attn_fwd_scratch",
                           q.device, b, h, tq, dh)
    return o, lse, scratch, args


def _launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                rate: float, seed: int, scale: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    o, lse, scratch, args = fwd_call(q, k, v, rate, seed, scale)
    stream = kernels.stream(q.device)
    if q.dtype == torch.bfloat16:   # up to 256 and the cluster kernel
        lib, fn = _wgmma_fwd_entry()
        rc = fn(*args, q.device.index, stream, _ptr(scratch))
    else:
        lib, fn = _fwd_entry()
        rc = fn(*args, kernels.DTYPE_CODES[q.dtype], q.device.index, stream,
                _ptr(scratch))
    _build.check(lib, rc, "flash_attn_fwd")
    kernels.count_launch("flash_attn_fwd", q.dtype)
    return o, lse


@functools.lru_cache(maxsize=None)
def _probe_entry():
    lib = _build.load("flash_attn_fwd")
    fn = lib.avsep_mma_3xtf32_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def mma_3xtf32_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (16, 8) @ b (8, 8) as one m16n8k8 tensor-core product in 3xTF32,
    through the fragment code of `csrc/flash_attn_fwd.cu`: a check of the
    fragment layouts the flash forward builds on.  CPU tensors take a @ b;
    no launch is counted (the probe is not on any path)."""
    if a.shape != (16, 8) or b.shape != (8, 8):
        raise ValueError(f"the probe takes (16, 8) @ (8, 8), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if not _device(a):
        return a @ b
    a, b = a.float().contiguous(), b.float().contiguous()
    c = torch.empty(16, 8, dtype=torch.float32, device=a.device)
    lib, fn = _probe_entry()
    rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), a.device.index,
            kernels.stream(a.device))
    _build.check(lib, rc, "mma_3xtf32_probe")
    return c


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                   rate: float = 0.0, seed: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of `flash_attn_fwd` for the output cotangent
    `do`, from the forward's o and lse; each a (B, H, T, dh) view of packed
    (B, T, H, dh) memory.  The dropout mask is regenerated from `seed`.

    CPU tensors take the plain version; CUDA tensors launch three kernels
    (delta, dK/dV, dQ) of `csrc/flash_bwd_wgmma.cu` (bfloat16 up to dh
    256) or `csrc/flash_attn_bwd.cu`: no atomics, so two runs give
    bit-identical gradients.  Head dims that are not built go through
    `padded_bwd`.  The gradients come back in q's dtype.
    """
    if not _device(q):
        return flash_attn_bwd_torch(q, k, v, o, do, lse, rate, seed)
    return padded_bwd(_launch_bwd, q, k, v, o, do, lse, rate, seed)


def bwd_call(q, k, v, o, do, lse, rate: float, seed: int,
             scale: Optional[float] = None):
    """(dq, dk, dv, delta, scratch, args): the gradients of one backward
    launch at a built head dim, its delta and scratch buffers (scratch None
    up to dh 2048 and on the wgmma route; both to be held until the
    launch) and the arguments of a C backward entry point up to the device
    (`avsep_flash_attn_bwd` takes the dtype code after them, then the
    device, the stream and the scratch pointer)."""
    _check(q, k, v, backward=True)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(q.shape)}")
        _check_rows(name, t, q)
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if lse.shape != (b, h, tq) or not lse.is_contiguous() \
            or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError("lse must be a contiguous float32 (B, H, Tq) tensor")
    dq, dk, dv = _packed_empty(q), _packed_empty(k), _packed_empty(v)
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, tq, tk, dh,
            (ctypes.c_longlong * len(strides))(*strides),
            scale, *_dropout_args(rate, seed, tq, tk))
    scratch = None if wgmma_route(q.dtype, dh) else _scratch(
        "flash_attn_bwd", "avsep_flash_attn_bwd_scratch", q.device, b, h, tq,
        tk, dh)
    return dq, dk, dv, delta, scratch, args


def _launch_bwd(q, k, v, o, do, lse, rate: float, seed: int,
                scale: Optional[float] = None):
    # The delta and scratch buffers are held until the launch.
    dq, dk, dv, _delta, scratch, args = bwd_call(q, k, v, o, do, lse, rate,
                                                 seed, scale)
    stream = kernels.stream(q.device)
    if wgmma_route(q.dtype, q.shape[-1]):
        lib, fn = _wgmma_bwd_entry()
        rc = fn(*args, q.device.index, stream)
    else:
        lib, fn = _bwd_entry()
        rc = fn(*args, kernels.DTYPE_CODES[q.dtype], q.device.index, stream,
                _ptr(scratch))
    _build.check(lib, rc, "flash_attn_bwd")
    kernels.count_launch("flash_attn_bwd", q.dtype)
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
