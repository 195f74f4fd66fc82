"""Device ms of host-to-device and device-to-host copies a served batch in the traced window (inference.py); from the device trace."""

from avbench import readers


def read(ctx):
    return readers.copy_ms_per_batch(ctx)
