"""Audio input projection: the CUDA forward kernel (`csrc/audio_proj.cu`, a
weight-split pre-pass and one launch a conv), its plain PyTorch version,
and the autograd function around it.

Port of `av_separation_tpu/ops/pallas/audio_proj.py` (`_proj_kernel`): two
k=3 conv1d layers with ReLU in channels-last layout, torch zero padding on
both, emitting the output y and the hidden activation h.  Weights are in the
flax layout (3, C_in, C_out); `models/model.py` permutes the torch Conv1d
weights into it (the kernel's k-major weight tiles read that layout
directly; the Conv1d layout (out, in, k) would put the taps innermost).
The backward is the JAX package's framed-einsum rule
(`audio_proj.py:126-158`, XLA there), as plain matmuls on either device.
The kernel takes widths D that are multiples of 8 from 64 up; any other D
runs zero-padded to the next (`padded_proj`): ReLU(0) = 0, so the padded
channels of h are zero, add nothing to conv2, and are sliced off.

x may be float32 or bfloat16; the weights are float32.  The math is
float32 at either dtype, as the Pallas kernel's (`x.astype(float32)`,
audio_proj.py:39-58): y and h are stored in x's dtype, and conv2 reads the
float32 h (at bf16 the bf16 h is only the backward's residual).  The
kernel runs on bf16 tensor cores (`wgmma`): a pre-pass (`audio_proj_split`,
its own launch, counted as `audio_proj_split` beside `audio_proj_fwd`)
writes each weight as three bf16 parts whose sum is the float32 weight,
and the convs sum the products of those parts with x (a bf16 x is exact
in bf16) or with the three parts of a float32 operand, in float32.  Its
TMA copies need rows whose stride is a multiple of 16 bytes, so an x of
F 257 channels comes as a view of rows padded to 260 (float32) or 264
(bf16) (`proj_input`, which the model uses); other layouts are copied
into one.  The backward rounds where the JAX rule does: its cotangents
come back in the inputs' dtypes (dx bf16, the weight and bias gradients
float32).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from av_separation_torch.ops import kernels, upcast
from av_separation_torch.ops.kernels import _build


def audio_proj_fwd_torch(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x (B, T, F) -> (y, h), each (B, T, D) in x's dtype,
    computed in float32."""
    def conv_relu(src, w, bias):
        t = src.shape[1]
        padded = F.pad(src, (0, 0, 1, 1))  # zero frame on each side of T
        acc = bias
        for tap in range(3):
            acc = acc + torch.matmul(padded[:, tap:tap + t], w[tap])
        return torch.relu(acc)

    h = conv_relu(upcast(x), w1, b1)
    return conv_relu(h, w2, b2).to(x.dtype), h.to(x.dtype)


BLOCK_FRAMES = 128  # frames a block (audio_proj.cu kBM)


def proj_plan(b: int, t: int, d: int, sms: int) -> dict:
    """The kernel's grid, one dimension: `blocks` = B x `tiles` x
    `slabs`, block i owning channel slab i % slabs, frame tile
    (i // slabs) % tiles and utterance i // (slabs tiles); a block is 128
    frames x `bn` channels, bn 128, or 64 at D 64 and where 128-channel
    blocks would leave half the SMs idle."""
    tiles = -(-t // BLOCK_FRAMES)
    bn = 128 if d > 64 and b * tiles * -(-d // 128) >= sms / 2 else 64
    slabs = -(-d // bn)
    return {"bn": bn, "tiles": tiles, "slabs": slabs,
            "blocks": b * tiles * slabs}


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("audio_proj")
    fn = lib.avsep_audio_proj_fwd
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _split_entry():
    lib = _build.load("audio_proj")
    fn = lib.avsep_audio_proj_split
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def tma_rows_ok(x: torch.Tensor) -> bool:
    """True where the kernel's TMA copies can read x (B, T, F) as it lies:
    channels contiguous, the base and the row and batch strides multiples
    of 16 bytes."""
    vec = 16 // x.element_size()
    return (x.stride(2) == 1 and x.data_ptr() % 16 == 0
            and x.stride(1) % vec == 0 and x.stride(0) % vec == 0)


def proj_input(x_bft: torch.Tensor) -> torch.Tensor:
    """(B, F, T) -> the projection's (B, T, F) input, laid out for its
    kernel: a view of rows padded to a multiple of 16 bytes (as TMA
    needs), written by the one transposing copy.  The pad is left as it
    is: the kernel never reads it."""
    b, f, t = x_bft.shape
    vec = 16 // x_bft.element_size()
    x = x_bft.new_empty((b, t, -(-f // vec) * vec))[..., :f]
    x.copy_(x_bft.transpose(1, 2))
    return x


def _check(x, w1, b1, w2, b2) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, F), got {tuple(x.shape)}")
    b, t, f = x.shape
    d = w1.shape[-1]
    want = {"w1": (3, f, d), "b1": (d,), "w2": (3, d, d), "b2": (d,)}
    for name, v in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2),
                    ("b2", b2)):
        if name != "x" and tuple(v.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(v.shape)}, "
                             f"expected {want[name]}")
        dtypes = kernels.DTYPE_CODES if name == "x" else (torch.float32,)
        if v.device != x.device or v.dtype not in dtypes:
            raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))}"
                             f" on {x.device}")
        if not (tma_rows_ok(v) if name == "x" else
                v.is_contiguous() and v.data_ptr() % 16 == 0):
            raise ValueError(
                f"{name} must be contiguous and 16-byte aligned" + (
                    " (x: channels contiguous, row and batch strides "
                    "multiples of 16 bytes)" if name == "x" else ""))
    if d != kernels.kernel_width(d):
        raise ValueError(f"channel count {d} must be a multiple of 8 "
                         f"from 64 up")
    blocks = b * -(-t // BLOCK_FRAMES) * -(-d // 64)
    if blocks > kernels.GRID_X_MAX:
        raise ValueError(f"B = {b} at T {t}: {blocks} blocks in grid x, "
                         f"above its {kernels.GRID_X_MAX}")


def padded_proj(fwd, x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`fwd` (a projection forward) at any width D: the D channels of w1,
    both of w2, b1 and b2 zero-padded to `kernels.kernel_width(D)`, y and h
    sliced back."""
    f, d = w1.shape[1:]
    width = kernels.kernel_width(d)
    if width == d:
        return fwd(x, w1, b1, w2, b2)
    pad = kernels.zero_padded
    y, h = fwd(x, pad(w1, (3, f, width)), pad(b1, (width,)),
               pad(w2, (3, width, width)), pad(b2, (width,)))
    return y[..., :d], h[..., :d]


def audio_proj_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """relu(conv3(relu(conv3(x, w1) + b1), w2) + b2) -> (y, h).

    CPU tensors take the plain version; CUDA tensors launch the kernel, at
    a width it is not built for through `padded_proj`.
    """
    if x.device.type == "cpu":
        return audio_proj_fwd_torch(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return padded_proj(_launch, x, w1, b1, w2, b2)


def weight_parts_torch(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the split: float32 w -> (3, *w.shape) bf16 parts,
    p1 = bf16(w), p2 = bf16(w - p1), p3 = bf16(w - p1 - p2), each rounded
    to nearest even; p1 + p2 + p3 == w exactly (in float32)."""
    p1 = w.to(torch.bfloat16)
    r = w - p1.float()
    p2 = r.to(torch.bfloat16)
    return torch.stack([p1, p2, (r - p2.float()).to(torch.bfloat16)])


def audio_proj_split(w1: torch.Tensor, w2: torch.Tensor,
                     dtype: torch.dtype = torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's pre-pass: each weight's three bf16 parts,
    (3, 3, C_in, D), in one launch (`weight_parts_torch` on the CPU),
    counted under the instance of the projection it serves (`dtype`, the
    dtype of x)."""
    if w1.device.type == "cpu":
        return weight_parts_torch(w1), weight_parts_torch(w2)
    if w1.device.type != "cuda":
        raise ValueError(f"unsupported device {w1.device}")
    for name, w in (("w1", w1), ("w2", w2)):
        if w.dtype != torch.float32 or not w.is_contiguous() \
                or w.device != w1.device:
            raise ValueError(f"{name} must be contiguous float32 on "
                             f"{w1.device}")
    p1 = torch.empty((3, *w1.shape), dtype=torch.bfloat16, device=w1.device)
    p2 = torch.empty((3, *w2.shape), dtype=torch.bfloat16, device=w1.device)
    lib, fn = _split_entry()
    rc = fn(w1.data_ptr(), w2.data_ptr(), p1.data_ptr(), p2.data_ptr(),
            w1.numel(), w2.numel(), w1.device.index,
            torch.cuda.current_stream(w1.device).cuda_stream)
    _build.check(lib, rc, "audio_proj_split")
    kernels.count_launch("audio_proj_split", dtype)
    return p1, p2


def _launch(x, w1, b1, w2, b2, keep_h32=False):
    """(y, h), and with `keep_h32` at bf16 the float32 h that conv1 wrote
    for conv2 (a check of the products' accuracy on the card)."""
    if x.dim() == 3 and x.dtype in kernels.DTYPE_CODES \
            and not tma_rows_ok(x):
        x = proj_input(x.transpose(1, 2))
    _check(x, w1, b1, w2, b2)
    b, t, f = x.shape
    d = w1.shape[-1]
    y = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
    h = torch.empty_like(y)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    stream = torch.cuda.current_stream(x.device).cuda_stream
    p1, p2 = audio_proj_split(w1, w2, x.dtype)
    # At bf16 conv1 also writes the float32 h that conv2 reads; at float32
    # conv2 reads h itself.
    h32 = torch.empty((b, t, d), dtype=torch.float32, device=x.device) \
        if x.dtype == torch.bfloat16 else h
    lib, fn = _entry()
    rc = fn(x.data_ptr(), x.stride(1), x.stride(0),
            kernels.DTYPE_CODES[x.dtype], p1.data_ptr(), b1.data_ptr(),
            p2.data_ptr(), b2.data_ptr(), y.data_ptr(), h.data_ptr(),
            h32.data_ptr(), b, t, f, d, proj_plan(b, t, d, sms)["bn"],
            x.device.index, stream)
    _build.check(lib, rc, "audio_proj_fwd")
    kernels.count_launch("audio_proj_fwd", x.dtype)
    return (y, h, h32) if keep_h32 else (y, h)


def _frames3(t: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B, T, 3, C): tap k of row t reads t_pad[t + k] under
    zero padding of one frame on each side."""
    padded = F.pad(t, (0, 0, 1, 1))
    n = t.shape[1]
    return torch.stack([padded[:, k:k + n] for k in range(3)], dim=2)


class AudioProjection(torch.autograd.Function):
    """y = audio_proj_fwd(x, w1, b1, w2, b2)[0]; the backward reads the
    ReLU masks from the saved h and y and does each conv's dgrad and wgrad
    as one einsum over a 3-tap framed view (`_bwd_rule`, audio_proj.py).
    At bf16 it rounds where that rule does: the pre-activation cotangents
    and the weights of the dgrads to bf16, every product summed in
    float32 (bf16 operands are exact in float32), dx rounded to bf16."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        y, h = audio_proj_fwd(x, w1, b1, w2, b2)
        ctx.save_for_backward(x, h, y, w1, w2)
        return y

    @staticmethod
    def backward(ctx, g):
        x, h, y, w1, w2 = ctx.saved_tensors
        dt = g.dtype
        rnd = (lambda t: t.to(dt).float()) if dt == torch.bfloat16 \
            else (lambda t: t)
        gp = rnd(upcast(g) * (y > 0))                      # d_preact2
        db2 = gp.sum(dim=(0, 1))
        dw2 = torch.einsum("btkf,btd->kfd", _frames3(upcast(h)), gp)
        dh = torch.einsum("btkd,kfd->btf", _frames3(gp).flip(2), rnd(w2))
        gp1 = rnd(dh * (h > 0))                            # d_preact1
        db1 = gp1.sum(dim=(0, 1))
        dw1 = torch.einsum("btkf,btd->kfd", _frames3(upcast(x)), gp1)
        dx = torch.einsum("btkd,kfd->btf", _frames3(gp1).flip(2), rnd(w1))
        return dx.to(x.dtype), dw1, db1, dw2, db2


def audio_projection(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Differentiable fused projection: x (B, T, F) -> y (B, T, D)."""
    return AudioProjection.apply(x, w1, b1, w2, b2)
