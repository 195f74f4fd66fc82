"""PyTorch port of av_separation_tpu for NVIDIA Hopper (H100).

The serving path (STFT -> AVSeparationTransformer -> masked iSTFT, behind a
micro-batching scheduler), the training path (over host batches or batches
generated on the device, with checkpoints) and the `cli` that drives it,
with hand-written CUDA kernels for flash attention forward and backward, the
fused audio projection, the fused mask decoder and the fused STFT magnitude
(`ops/kernels/`, sources in `csrc/`).  Importing the package imports neither
JAX nor the JAX package, and builds no kernel.
"""
