"""Device ms of what the data span launched (data/device_synthetic.py and its STFT kernel), a traced step; from the device trace."""

from avbench import readers


def read(ctx):
    return readers.device_ms_per_step(ctx, "data")
