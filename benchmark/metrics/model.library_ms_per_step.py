"""Device ms a traced step of the kernels under the step span that are not the port's own (cuBLAS, cuDNN, PyTorch's); from the device trace."""

from avbench import readers


def read(ctx):
    return readers.library_ms_per_step(ctx)
