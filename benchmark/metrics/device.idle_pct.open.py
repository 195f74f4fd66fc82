"""The device's idle share of the traced window: one minus the union of its kernels, copies and sets over the window."""

from avbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
