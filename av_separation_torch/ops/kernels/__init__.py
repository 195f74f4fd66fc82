"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper dispatches on the device of the tensors it is given: a CUDA
tensor launches the kernel (or the call raises), a CPU tensor runs the plain
PyTorch version.  `LAUNCHES` counts kernel launches per wrapper, and only
those: plain-version calls never touch it.
"""

LAUNCHES = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "audio_proj_fwd": 0,
            "mask_decoder_fwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
