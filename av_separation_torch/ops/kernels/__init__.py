"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper dispatches on the device of the tensors it is given: a CUDA
tensor launches the kernel (or the call raises), a CPU tensor runs the plain
PyTorch version.  `LAUNCHES` counts kernel launches per wrapper, and only
those: plain-version calls never touch it.
"""

from typing import Callable, Sequence

LAUNCHES = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "audio_proj_fwd": 0,
            "mask_decoder_fwd": 0, "stft_mag_fwd": 0, "stft_mag_dft_fwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def gemm_rows(blocks: Callable[[int], int], sms: int,
              options: Sequence[int] = (128, 64, 32)) -> int:
    """The rows of a block tile, for the tiled 3xTF32 kernels: the largest
    option (the most reuse of each staged tile) whose grid, `blocks(rows)`
    blocks, still gives every SM one; the smallest where none does."""
    for rows in sorted(options, reverse=True):
        if blocks(rows) >= sms:
            return rows
    return min(options)
