"""Device operations launched under the benchmark's step span (trainer: train.py, losses.py), a traced step; from the device trace."""

from avbench import readers


def read(ctx):
    return readers.launches_per_step(ctx, "step")
