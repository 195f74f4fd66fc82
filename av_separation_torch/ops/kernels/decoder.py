"""Fused separation mask decoder forward: the CUDA kernel
`csrc/mask_decoder.cu` and its plain PyTorch version.

Port of `av_separation_tpu/ops/pallas/decoder.py` (`_decoder_kernel`):
Linear(d -> 2d) + exact GELU + Linear(2d -> S*F) + sigmoid + mask x mixed,
returning (separated, masks) in the reference layout (B, S, F, T).  Weights
are in the (in, out) layout of the JAX package; `models/model.py` transposes
the torch Linear weights into it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from av_separation_torch.ops import kernels
from av_separation_torch.ops.kernels import _build


def mask_decoder_fwd_torch(x: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, w2: torch.Tensor,
                           b2: torch.Tensor, mixed: torch.Tensor,
                           num_speakers: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x (B, T, d), mixed (B, F, T) -> (separated, masks)."""
    b, t, _ = x.shape
    f = mixed.shape[1]
    a = F.gelu(torch.matmul(x, w1) + b1)
    logits = torch.matmul(a, w2) + b2
    masks = torch.sigmoid(logits).reshape(b, t, num_speakers, f)
    masks = masks.permute(0, 2, 3, 1).contiguous()
    return masks * mixed[:, None], masks


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("mask_decoder")
    fn = lib.avsep_mask_decoder_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _check(x, w1, b1, w2, b2, mixed, num_speakers) -> None:
    if x.dim() != 3 or mixed.dim() != 3:
        raise ValueError("x must be (B, T, d) and mixed (B, F, T)")
    b, t, d = x.shape
    f = mixed.shape[1]
    want = {"w1": (d, 2 * d), "b1": (2 * d,), "w2": (2 * d, num_speakers * f),
            "b2": (num_speakers * f,), "mixed": (b, f, t)}
    for name, ten in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2),
                      ("b2", b2), ("mixed", mixed)):
        if name != "x" and tuple(ten.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(ten.shape)}, "
                             f"expected {want[name]}")
        if ten.device != x.device or ten.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}")
        if not ten.is_contiguous() or ten.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if d % 8 or not 64 <= d <= 1024:
        raise ValueError(f"model width {d} must be a multiple of 8 in "
                         f"[64, 1024]")


def mask_decoder_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor, mixed: torch.Tensor,
                     num_speakers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused mask head -> (separated, masks), each (B, S, F, T).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if x.device.type == "cpu":
        return mask_decoder_fwd_torch(x, w1, b1, w2, b2, mixed, num_speakers)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, w1, b1, w2, b2, mixed, num_speakers)
    b, t, d = x.shape
    f = mixed.shape[1]
    masks = torch.empty((b, num_speakers, f, t), dtype=x.dtype,
                        device=x.device)
    sep = torch.empty_like(masks)
    lib, fn = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), mixed.data_ptr(), masks.data_ptr(),
            sep.data_ptr(), b, t, d, num_speakers, f, x.device.index, stream)
    _build.check(lib, rc, "mask_decoder_fwd")
    kernels.LAUNCHES["mask_decoder_fwd"] += 1
    return sep, masks
