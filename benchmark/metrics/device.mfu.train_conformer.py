"""Model FLOPs of the window's training steps of a conformer configuration (three forwards a sample) over its wall time, as a share of the bf16 peak."""

from avbench import conformer_work


def read(ctx):
    return conformer_work.mfu(ctx)
