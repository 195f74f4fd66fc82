"""Model FLOPs of the window's training steps (three forwards a sample, remat not counted) over its wall time, as a share of the bf16 peak."""

from avbench import readers


def read(ctx):
    return readers.mfu(ctx, ctx.window["steps"] * int(ctx.traffic["batch_size"]), 3.0)
