"""The flash-attention forward calls' share of their roofline in the traced training steps; from the device trace."""

from avbench import readers


def read(ctx):
    return readers.flash_roofline(ctx, "fwd")
