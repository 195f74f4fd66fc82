"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper dispatches on the device of the tensors it is given: a CUDA
tensor launches the kernel (or the call raises), a CPU tensor runs the plain
PyTorch version.  `LAUNCHES` counts kernel launches per wrapper and dtype
(the bfloat16 instances under `name[bf16]`; the projection's weight
split, its own launch, under `audio_proj_split` and
`audio_proj_split[bf16]` by the dtype of x; the STFT's four-step FFT once
a call under `stft_mag_4step_fwd`, whatever its passes and chunks; a
dropout site's forward and backward under `dropout_fwd` and
`dropout_bwd`; the conformer's GLU + depthwise convolution under
`glu_dwconv_fwd` and `glu_dwconv_bwd`, its backward's two kernels one
call), and only those: plain-version calls never touch it.
"""

from typing import Callable, Sequence

import torch

# The C entry points' dtype argument (flash attention, the projection).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Blocks a launch may have in grid x (y and z take 65,535): the flash
# kernels fold B*H into x, the projection's grid is x alone.
GRID_X_MAX = 2 ** 31 - 1

LAUNCHES = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "audio_proj_fwd": 0,
            "mask_decoder_fwd": 0, "stft_mag_fwd": 0, "stft_mag_4step_fwd": 0,
            "flash_attn_fwd[bf16]": 0, "flash_attn_bwd[bf16]": 0,
            "audio_proj_fwd[bf16]": 0, "audio_proj_split": 0,
            "audio_proj_split[bf16]": 0, "dropout_fwd": 0, "dropout_bwd": 0,
            "dropout_fwd[bf16]": 0, "dropout_bwd[bf16]": 0,
            "glu_dwconv_fwd": 0, "glu_dwconv_bwd": 0,
            "glu_dwconv_fwd[bf16]": 0, "glu_dwconv_bwd[bf16]": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def stream(device: torch.device) -> int:
    """The raw handle of `device`'s current CUDA stream, for a launch (the
    `torch.cuda.Stream` object costs the host a few us a call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def count_launch(name: str, dtype: torch.dtype) -> None:
    """One launch of wrapper `name`'s kernel instance for `dtype`."""
    LAUNCHES[name + ("[bf16]" if dtype == torch.bfloat16 else "")] += 1


def gemm_rows(blocks: Callable[[int], int], sms: int,
              options: Sequence[int] = (128, 64, 32)) -> int:
    """The rows of a block tile, for the tiled 3xTF32 kernels: the largest
    option (the most reuse of each staged tile) whose grid, `blocks(rows)`
    blocks, still gives every SM one; the smallest where none does."""
    for rows in sorted(options, reverse=True):
        if blocks(rows) >= sms:
            return rows
    return min(options)


def kernel_width(d: int) -> int:
    """The channel count the projection and decoder kernels run a width of
    `d` at: d rounded up to a multiple of 8, and at least 64."""
    return max(64, -(-d // 8) * 8)


def zero_padded(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`t` zero-padded at the end of each dim to `shape`.  The copy is kept
    on `t` for its current version, so a weight is padded once until it is
    updated in place (an inference tensor, which has no version, is padded
    each call)."""
    shape = tuple(shape)
    key = None if t.is_inference() else (shape, t._version)
    cached = getattr(t, "_avsep_zero_padded", None)
    if key is not None and cached is not None and cached[0] == key:
        return cached[1]
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    if key is not None:
        t._avsep_zero_padded = (key, out)
    return out
