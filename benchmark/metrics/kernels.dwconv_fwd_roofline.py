"""The GLU + depthwise-convolution forward calls' share of their roofline in the traced training steps; from the device trace."""

from avbench import conformer_work


def read(ctx):
    return conformer_work.dwconv_roofline(ctx, "fwd")
