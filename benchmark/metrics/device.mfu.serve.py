"""Model FLOPs of the window's answered requests (one forward each) over its wall time, as a share of the bf16 peak."""

from avbench import readers


def read(ctx):
    return readers.mfu(ctx, ctx.window.completed, 1.0)
