"""Separation mask decoder: the CUDA forward kernels `csrc/mask_decoder.cu`
(two tiled GEMM launches), its plain PyTorch version, and the autograd
function around it.

Port of `av_separation_tpu/ops/pallas/decoder.py` (`_decoder_kernel`):
Linear(d -> 2d) + exact GELU + Linear(2d -> S*F) + sigmoid + mask x mixed,
returning (separated, masks) in the reference layout (B, S, F, T).  Weights
are the torch Linear weights as they are, (out, in): w1 (2d, d), w2
(S*F, 2d), so the model copies none per forward (the JAX package's are
(in, out)).  The backward is the JAX package's rule (`decoder.py:159-187`,
XLA matmuls there), as plain matmuls on either device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from av_separation_torch.ops import kernels
from av_separation_torch.ops.kernels import _build
from av_separation_torch.ops.kernels.dropout_fused import gelu_grad


def mask_decoder_fwd_torch(x: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, w2: torch.Tensor,
                           b2: torch.Tensor, mixed: torch.Tensor,
                           num_speakers: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x (B, T, d), mixed (B, F, T) -> (separated, masks)."""
    b, t, _ = x.shape
    f = mixed.shape[1]
    a = F.gelu(F.linear(x, w1, b1))
    logits = F.linear(a, w2, b2)
    masks = torch.sigmoid(logits).reshape(b, t, num_speakers, f)
    masks = masks.permute(0, 2, 3, 1).contiguous()
    return masks * mixed[:, None], masks


BLOCK_COLS = 128  # output columns a block (mask_decoder.cu kBN)


def decoder_rows(m: int, n: int, sms: int) -> int:
    """Block rows of one of the kernel's two GEMMs over m rows and n
    output columns."""
    return kernels.gemm_rows(
        lambda rows: -(-m // rows) * -(-n // BLOCK_COLS), sms)


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("mask_decoder")
    fn = lib.avsep_mask_decoder_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _check(x, w1, b1, w2, b2, mixed, num_speakers) -> None:
    if x.dim() != 3 or mixed.dim() != 3:
        raise ValueError("x must be (B, T, d) and mixed (B, F, T)")
    b, t, d = x.shape
    f = mixed.shape[1]
    want = {"w1": (2 * d, d), "b1": (2 * d,), "w2": (num_speakers * f, 2 * d),
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
    if d != kernels.kernel_width(d):
        raise ValueError(f"model width {d} must be a multiple of 8 from 64 "
                         f"up")


def padded_decoder(fwd, x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, mixed: torch.Tensor,
                   num_speakers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`fwd` (a decoder forward) at any width d, padded to
    `kernels.kernel_width(d)`; the outputs need no slicing."""
    d = x.shape[-1]
    width = kernels.kernel_width(d)
    if width == d:
        return fwd(x, w1, b1, w2, b2, mixed, num_speakers)
    pad = kernels.zero_padded
    return fwd(F.pad(x, (0, width - d)), pad(w1, (2 * width, width)),
               pad(b1, (2 * width,)), pad(w2, (w2.shape[0], 2 * width)), b2,
               mixed, num_speakers)


def mask_decoder_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor, mixed: torch.Tensor,
                     num_speakers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused mask head -> (separated, masks), each (B, S, F, T).

    CPU tensors take the plain version; CUDA tensors launch the kernel, at
    a width it is not built for through `padded_decoder`.
    """
    if x.device.type == "cpu":
        return mask_decoder_fwd_torch(x, w1, b1, w2, b2, mixed, num_speakers)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return padded_decoder(_launch, x, w1, b1, w2, b2, mixed, num_speakers)


def _launch(x, w1, b1, w2, b2, mixed, num_speakers: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x, w1, b1, w2, b2, mixed, num_speakers)
    b, t, d = x.shape
    f = mixed.shape[1]
    masks = torch.empty((b, num_speakers, f, t), dtype=x.dtype,
                        device=x.device)
    sep = torch.empty_like(masks)
    # The GELU activation between the kernel's two GEMMs (16 MB at the
    # scaled shape: it stays in the L2).
    hidden = torch.empty((b * t, 2 * d), dtype=x.dtype, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    lib, fn = _entry()
    stream = kernels.stream(x.device)
    rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), mixed.data_ptr(), hidden.data_ptr(),
            masks.data_ptr(), sep.data_ptr(), b, t, d, num_speakers, f,
            decoder_rows(b * t, 2 * d, sms),
            decoder_rows(b * t, num_speakers * f, sms), x.device.index,
            stream)
    _build.check(lib, rc, "mask_decoder_fwd")
    kernels.LAUNCHES["mask_decoder_fwd"] += 1
    return sep, masks


class MaskDecoder(torch.autograd.Function):
    """(separated, masks) = mask_decoder_fwd(...); the backward folds the
    separated cotangent into the masks', goes through the sigmoid, and
    recomputes the first Linear + GELU (`_bwd_rule`, decoder.py)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, mixed, num_speakers: int):
        sep, masks = mask_decoder_fwd(x, w1, b1, w2, b2, mixed, num_speakers)
        ctx.save_for_backward(x, w1, b1, w2, mixed, masks)
        return sep, masks

    @staticmethod
    def backward(ctx, g_sep, g_mask):
        x, w1, b1, w2, mixed, masks = ctx.saved_tensors
        g_masks = g_mask + g_sep * mixed[:, None]
        g_mixed = (g_sep * masks).sum(dim=1)
        # masks = sigmoid(logits), logits laid out (B, T, S, F) pre-permute.
        d_logits = (g_masks * masks * (1.0 - masks)).permute(0, 3, 1, 2)
        b, t, s, f = d_logits.shape
        d_logits = d_logits.reshape(b, t, s * f)
        pre = F.linear(x, w1, b1)
        a = F.gelu(pre)
        g_a = torch.matmul(d_logits, w2)
        g_w2 = torch.einsum("bth,bto->oh", a, d_logits)
        g_b2 = d_logits.sum(dim=(0, 1))
        g_pre = g_a * gelu_grad(pre)
        g_x = torch.matmul(g_pre, w1)
        g_w1 = torch.einsum("btd,bth->hd", x, g_pre)
        g_b1 = g_pre.sum(dim=(0, 1))
        return g_x, g_w1, g_b1, g_w2, g_b2, g_mixed, None


def mask_decoder(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, mixed: torch.Tensor,
                 num_speakers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused mask head -> (separated, masks)."""
    return MaskDecoder.apply(x, w1, b1, w2, b2, mixed, num_speakers)
