"""Requests a batch over the window: the difference of the server's ServerStats counters (serving.py)."""

from avbench import readers


def read(ctx):
    return readers.mean_batch(ctx)
