"""Audio input projection: the CUDA forward kernels `csrc/audio_proj.cu` (one
implicit-GEMM launch a conv), its plain PyTorch version, and the autograd
function around it.

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

x may be float32 or bfloat16; the weights are float32.  At bf16 the math
stays float32, as the Pallas kernel's (`x.astype(float32)`,
audio_proj.py:39-58): y and h are stored in bf16, and conv2 reads the
float32 h (the bf16 h is only the backward's residual).  The backward
rounds where the JAX rule does: its cotangents come back in the inputs'
dtypes (dx bf16, the weight and bias gradients float32).
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


BLOCK_COLS = 128  # output channels a block (audio_proj.cu kBN)


def proj_rows(b: int, t: int, d: int, sms: int) -> int:
    """Frames a block computes: (ceil(T / rows), ceil(D / 128), B) blocks
    a conv."""
    return kernels.gemm_rows(
        lambda rows: -(-t // rows) * -(-d // BLOCK_COLS) * b, sms)


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("audio_proj")
    fn = lib.avsep_audio_proj_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _check(x, w1, b1, w2, b2) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, F), got {tuple(x.shape)}")
    _, _, f = x.shape
    d = w1.shape[-1]
    want = {"w1": (3, f, d), "b1": (d,), "w2": (3, d, d), "b2": (d,)}
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2),
                    ("b2", b2)):
        if name != "x" and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        dtypes = kernels.DTYPE_CODES if name == "x" else (torch.float32,)
        if t.device != x.device or t.dtype not in dtypes:
            raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))}"
                             f" on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if d != kernels.kernel_width(d):
        raise ValueError(f"channel count {d} must be a multiple of 8 "
                         f"from 64 up")


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


def _launch(x, w1, b1, w2, b2) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x, w1, b1, w2, b2)
    b, t, f = x.shape
    d = w1.shape[-1]
    y = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
    h = torch.empty_like(y)
    # At bf16, conv1 also writes the float32 h conv2 reads.
    h32 = None if x.dtype == torch.float32 else torch.empty(
        (b, t, d), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    lib, fn = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), y.data_ptr(), h.data_ptr(),
            None if h32 is None else h32.data_ptr(), b, t, f, d,
            proj_rows(b, t, d, sms), kernels.DTYPE_CODES[x.dtype],
            x.device.index, stream)
    _build.check(lib, rc, "audio_proj_fwd")
    kernels.count_launch("audio_proj_fwd", x.dtype)
    return y, h


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
