"""PyTorch port of av_separation_tpu for NVIDIA Hopper (H100).

The serving path (STFT -> AVSeparationTransformer -> masked iSTFT, behind a
micro-batching scheduler) with hand-written CUDA kernels for flash
attention, the fused audio projection and the fused mask decoder
(`ops/kernels/`, sources in `csrc/`).  Importing the package imports neither
JAX nor the JAX package, and builds no kernel.
"""
