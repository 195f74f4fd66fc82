"""Fused audio input projection forward: the CUDA kernel `csrc/audio_proj.cu`
and its plain PyTorch version.

Port of `av_separation_tpu/ops/pallas/audio_proj.py` (`_proj_kernel`): two
k=3 conv1d layers with ReLU in channels-last layout, torch zero padding on
both, emitting the output y and the hidden activation h.  Weights are in the
flax layout (3, C_in, C_out); `models/model.py` permutes the torch Conv1d
weights into it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from av_separation_torch.ops import kernels
from av_separation_torch.ops.kernels import _build


def audio_proj_fwd_torch(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x (B, T, F) -> (y, h), each (B, T, D)."""
    def conv_relu(src, w, bias):
        t = src.shape[1]
        padded = F.pad(src, (0, 0, 1, 1))  # zero frame on each side of T
        acc = bias
        for tap in range(3):
            acc = acc + torch.matmul(padded[:, tap:tap + t], w[tap])
        return torch.relu(acc)

    h = conv_relu(x, w1, b1)
    return conv_relu(h, w2, b2), h


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("audio_proj")
    fn = lib.avsep_audio_proj_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
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
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if d % 8 or not 64 <= d <= 1024:
        raise ValueError(f"channel count {d} must be a multiple of 8 in "
                         f"[64, 1024]")


def audio_proj_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """relu(conv3(relu(conv3(x, w1) + b1), w2) + b2) -> (y, h).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if x.device.type == "cpu":
        return audio_proj_fwd_torch(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, w1, b1, w2, b2)
    b, t, f = x.shape
    d = w1.shape[-1]
    y = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
    h = torch.empty_like(y)
    lib, fn = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), y.data_ptr(), h.data_ptr(), b, t, f, d,
            x.device.index, stream)
    _build.check(lib, rc, "audio_proj_fwd")
    kernels.LAUNCHES["audio_proj_fwd"] += 1
    return y, h
