#!/usr/bin/env python3
"""Drive the PyTorch port (`av_separation_torch`) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each; any failed phase makes the exit code nonzero:
  env      card name and power limit (nvidia-smi); TF32 off for matmuls and
           cuDNN convolutions, so every float32 product is a float32 product.
  build    nvcc builds every kernel of `av_separation_torch/csrc/` (in
           parallel) into build/torch_kernels/; prints the build seconds,
           each kernel instance's registers and spills (for example
           flash_bwd_dkv_kernel_pair, flash_bwd_dkv_kernel<128,1>,
           flash_fwd_kernel_wgmma<128,2>) and the instances that spill;
           fails if an STFT instance (13 one-block, four four-step
           passes), a bf16 `wgmma` flash or projection instance, a
           float32 flash instance at dh 256 (the three `_pair` kernels)
           or a flash instance above dh 256, or one of the 28 fused
           dropout instances, spills or is missing.
  kernels  first one m16n8k8 3xTF32 tensor-core product against float64
           (the fragment layouts of the flash kernels).  Then each kernel
           against its plain PyTorch version on the card, at the shapes the
           serving and training paths give it (plus the demo shapes and one
           T > 512 attention): max abs error with its tolerance; kernel /
           plain / library times on the host's view (CUDA events around
           back-to-back calls: `ms`, host-inclusive) and on the device's
           (`device_ms`, `library_device_ms`: torch.profiler kernel
           durations, the kernel's own per launch, every device kernel of
           one library call); the bound with the rate it used (matrix
           products at 3xTF32's 165 TFLOP/s, a bf16 x times float32
           weights at three bf16 products' 330, the FFT at float32's 67)
           and a failure if any time reads below it, the library's
           included.  Flash attention at
           dropout 0 and 0.1, forward and backward (both on the tensor
           cores in 3xTF32; the backward's bound counts its 5 least
           products), at dh 128, 32 and 64 (the reference's default
           model) and dh 49 (zero-padded to 64 by the wrapper), dh 256
           and dh 200 (padded to 256: 8-warp blocks, two warps to each 16
           rows, one 128-column half each); each backward is run twice
           and must give bit-identical gradients.
           Head dims above 256: dh 512, dh 320 (padded to 384), dh 1152
           (B 2, H 1: a cluster of 9 blocks, the non-portable size) and
           dh 2048 (B 1, H 1: 16 blocks, the largest cluster), each on a
           thread-block cluster of dh / 128 blocks, one 128-column chunk
           a block; dh 2176 (B 1, H 1: 17 chunks on 9 blocks, which own
           two each but the last).  The same in bfloat16 ([bf16]
           rows, the `wgmma` kernels up to dh 256, the forward's `wgmma`
           cluster kernel above) at the scaled audio self-attention (dh
           128), the default model's dh 64, T 1024, dh 256, dh 512, 320,
           1152, 2048 and 2176, and the bench's demo batch (B 128, H 4,
           dh 32: self 63 x 63, cross 63 x 50): o and the gradients
           within 2 bf16 ulps of the plain version at their peak, lse
           1e-4, the bound at bf16's 989 TFLOP/s, SDPA in bf16 as the
           yardstick; the host cost of one TMA tensor-map encode.
           The audio projection (float32 math on bf16 `wgmma` products of
           three-part weights, x in the model's padded rows) and the mask
           decoder (3xTF32) at the scaled, demo, three_speaker and
           multihost shapes, and at d 196 (padded to 200) and d 1536;
           their library yardsticks are two cuDNN conv1d and F.linear /
           F.gelu / F.linear / sigmoid (cuBLAS).  The projection with a
           bf16 input (float32 math, bf16 y and h within 2 bf16 ulps, the
           float32 h that conv1 writes for conv2 within 1e-4) at the
           scaled, bench (B 128, T 63, D 128), three_speaker and
           multihost shapes; its held yardstick is cuDNN conv1d in
           float32 on the upcast x (the same function), cuDNN in bf16
           (bf16 products of rounded weights: another function) beside
           it, timed only.  Each projection row has a row of its weight
           split (three bf16 parts a weight, bit for bit against the
           plain split).  The STFT magnitude's FFT at every kind of
           length (radix 2-8, prime radices 11-31, Rader, Bluestein
           over a 7-smooth P, odd n_fft, odd hops) on the
           scaled, 44.1 kHz and demo device batches, an odd shape and
           70,000 signals (more than 65,535); above n_fft 4096 at one
           frame a block (8192 / 1024 and 16384 / 4096 scaled, 4410 / 441
           at 44.1 kHz, 4098 / 4098 over 66,000 one-frame signals under
           Bluestein) and by the four-step FFT (8194 / 2048 under
           Bluestein and odd 10125 / 2205 at 44.1 kHz, 32768 / 8192 over
           8 x 441,000 samples); each row names its transform; every
           row is held against its plain version (above n_fft 4096 at
           the tolerance plus the plain version's own error against
           float64, and against float64 at the tolerance); its library
           yardstick is torch.stft (cuFFT).  Last, past
           grid y's 65,535: flash at B*H 65,536 (B 16,384, H 4, T 16,
           dh 32, both dtypes; dh 128 in bf16) at dropout 0 and 0.1,
           the projection at B 65,536 (T 8, D 64) at both dtypes.  A
           projection launch is counted with its split (audio_proj_split,
           audio_proj_split[bf16]): every run launches as many splits as
           projections of each dtype.  The fused dropout sites (port-only
           kernels: dropout, dropout_add, relu_dropout, gelu_dropout,
           forward and backward) at the cells' shapes (scaled B 128 x T
           501 x 512 / 2048, the decoder's float32 x 1024; multihost B 48
           x 501 x 1024 / 4096), a TP rank's column block of a full-width
           draw, NaN at the dropped positions, and float32 at the
           scaled shapes: bit for bit against the plain version but the
           GELU forward (within 1 ulp of its dtype, the share of elements
           that differ printed); the plain chain's device time as the
           yardstick.  Every row also checks that the
           current CUDA device is the one before the kernel's call (each
           C entry point restores the caller's device; with one card only
           that much can be seen).
  golden   demo config with the reference weights (tests/golden/) through
           the kernels, against the reference's outputs at the tolerances of
           tests/test_parity.py.
  configs  the reference's default model (ModelConfig(), dh 64), the
           named configs three_speaker, lrs2 and multihost, odd_width
           (ModelConfig() at d 196, 4 heads: dh 49), wide_head
           (ModelConfig(d_model=512, nhead=2): dh 256) and wide_d1024
           (ModelConfig(d_model=1024, nhead=2): dh 512) at full width and
           depth (seeded random weights): one eval forward at batch 2
           each against the same model on the CPU, launches counted; one
           train step of the default model, wide_head and wide_d1024 at
           dropout 0 against float64 on the CPU; one train step each of
           three_speaker, lrs2 and multihost at their own batch and
           dropout 0.1, multihost with remat (its config) and without:
           loss and grad norm within 1e-6 relative, peak memory of each.
  serve    the scaled config at full width and depth (seeded random
           weights): a Separator on the card behind a
           BatchingSeparatorServer(max_batch=8) answers 16 waveform requests
           (4 s at 16 kHz, 200 lip frames) from 4 threads.  The launch counts
           are zeroed just before and read just after; every forward must
           launch 16 attention, 1 projection and 1 decoder kernel.  One
           batch is checked against the same model on the CPU.  No
           backward kernel may launch.
  stream   the scaled config at full width and depth (seeded weights):
           2 mixtures of 60 s with 2 x 1,500 lip frames each through
           Separator.separate_waveform_streaming on the card (chunk 4 s,
           overlap 1 s: 20 chunks); 16 attention, 1 projection and 1
           decoder launch a chunk; the output against a numpy overlap-add
           of the card's own per-chunk separate_waveform and its
           single-chunk regions against the isolated chunks (1e-6 x
           peak); a 10 s mixture (3 chunks) against the CPU (first chunk's
           masks 1e-4, waves 1e-3 x peak); wall s and audio-s/s.
  serve_http  `python3 -m av_separation_torch.cli serve --config scaled`
           as a process (max batch 8, warm-up 1, 2, 4, 8, a bearer token):
           16 POST /separate_waveform of 4 s and 4 POST /separate from 4
           client threads, all 200; /stats shows coalescing; 401 without
           the token, 413 over the size cap, 400 on Content-Length -1; 8
           responses against a CPU Separator on the same seeded weights
           (masks 1e-4, waves 1e-3 x peak); SIGINT stops it within 30 s;
           over-the-wire audio-s/s and latency p50 / p95.
  profile  where the time of one served batch of 8 goes: host-clock batch
           time, then a torch.profiler trace summed per kernel name and
           group, and the device's busy share.
  train    the scaled config at full width and depth (seeded random
           weights), dropout 0.1, batches of 8 from the port's synthetic
           dataset, through create_train_state -> make_train_step: loss
           and grad norm per step (finite), ms per step, training audio-s/s
           and launches per step (16 flash forward, 16 flash backward,
           1 projection, 0 decoder, 51 dropout forward and 51 backward:
           one each a dropout site; counts zeroed just before, read just
           after).  Then one step at dropout 0 and batch 2 on the card,
           against the same weights and batch in float64 on the CPU: loss,
           grad norm and the largest gradient error against stated
           tolerances (the CPU's float32 errors are printed beside them).
  train_profile  where the time of one train step goes (torch.profiler).
  device_data  batches generated on the card (data/device_synthetic.py
           generate_batch, batch 8) at the scaled config and two
           DataConfigs derived from it (44.1 kHz: n_fft 882, hop 441;
           n_fft 514, Rader): exactly one STFT launch per batch on the
           FFT route, shapes, finite values, lips in [0, 1]; the same
           variates through `synthesize` on the CPU (spectra atol 1e-3 +
           rtol 1e-5, lips 1e-5); ms per generated batch (CUDA events),
           for scaled beside the host batch_iterator's ms per batch of 8.
  train_device  `python -m av_separation_torch.cli train` in process on
           the scaled config at full width and depth, dropout 0.1, batch 8,
           --data device: --fused --steps 20, then --steps 6; the final
           JSON lines (finite loss, audio-s/s) and launches per step (16
           flash forward, 16 flash backward, 1 projection, 0 decoder,
           1 STFT; counts zeroed before each run, read after).  Then a
           4-step run with --checkpoint-every 2 against a run to step 2
           resumed to step 4: final losses within 1e-5 relative.
  train_device_profile  host-data steps against fused device-data steps
           in turns (host clock), then where the time of a fused step goes
           (torch.profiler over two fused steps).
  data_tiers  the file-corpus and native tiers feeding scaled training
           (full width and depth, batch 8, dropout 0.1): 24 scaled
           samples written as a corpus; the PrefetchIterator's first 6
           batches bit for bit the host batch_iterator's over the same
           samples, and 6 steps fed by each within 1e-5 relative; `cli
           train --data files` (static, --dynamic-mix) and `--data native`,
           6 steps each: launches per step 16/16/1/0 (no STFT: host
           spectrograms), finite loss and audio-s/s, 4 steps straight
           against 2 + resumed 2 within 1e-5; a bf16 files run on the bf16
           instances only; --debug-nans: the clean loss unchanged (1e-5),
           a NaN in mixed_spec named at audio_encoder.projection and one
           in lip_frames at visual_encoder.conv.0, its cost a step; host
           ms a batch of each pipeline, the step's ms fed by each in turns
           and the device's busy share.
  bf16     bfloat16 compute: a scaled serving batch of 8 through a bf16
           Separator (against the port's bf16 forward on the CPU and the
           card's float32 output), a scaled bf16 train step at dropout
           0.1 (within 2e-3 relative of the float32 step's loss and grad
           norm; two faulted steps must fall outside), the device time
           of the batch and of the step with the flash kernels' share
           (torch.profiler), the 100-step demo at bf16 (+35 dB gate);
           each run launches only the [bf16] instances of the flash pair
           and the projection.
  bench    `python -m av_separation_torch.cli bench` in process at the
           JAX bench's defaults (demo, batch 128, bf16, fused, 250
           steps), per_step and float32 at 50 steps: each JSON line.
  demo     `av_separation_torch.demo`: 100 steps of the demo config on the
           card; fails below +35 dB or with masks outside [0, 1].
  parallel the parallel tier (`av_separation_torch/parallel/`) on the card.
           (1) One rank over NCCL through a tcp://127.0.0.1 store:
           multihost at full width and depth (d 1024, 8 heads of 128,
           12 + 8 layers, 4 speakers, remat, batch 16, dropout 0.1)
           through create_train_state(mesh 1x1x1x1) and
           make_train_step(cfg, mesh): the placement rules, the 'fsdp'
           gathers, the sharded clip and BatchNorm's all-reduce on a
           group of one; loss and grad norm within 1e-6 relative of the
           same step without a mesh; launches (64 flash forwards under
           remat, 32 backwards, 1 projection and its split, no decoder);
           a full checkpoint read back into a one-device Separator (its
           weights the mesh state's, bit for bit, and a finite forward);
           peak memory and the first (cold) step's ms of each side, then
           warm step ms of both in turns (one untimed step each first).
           (2) The kernels at the shard shapes of multihost's own mesh,
           data 2 x model 4: each of the 8
           ranks' flash calls (B 8, H 2 of 8, T 501, dh 128; q, k, v as
           column slices of the rank's TP-packed (8, 501, 768)
           projection), float32 and bf16, forward and backward, with the
           seeds folded by position: assembled against the plain
           version's shard loop at dropout 0.1 and against one unsharded
           call at dropout 0; then the seq route at the scaled width
           (T 1024, seq 4: Tq 256 against Tk 1024); rank 0's blocks timed
           as the kernels phase times a row (bound, SDPA); the projection
           and the decoder on 8-row local batches.  (3) Two ranks on the
           one card over gloo (NCCL refuses two ranks on one device), one
           process each: a train step of a demo-width model (T 64) on each
           route of `PARALLEL_ROUTES_ON_CARD`, two steps against two
           one-process steps (both losses atol 1e-4 + rtol 1e-5, the
           first step's grad norm rtol 1e-5); `routes_on_card` and
           `routes_cpu_only` with the reason for each.
Then the kernel summary line, the card line, and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits nonzero, printing no result, without a CUDA device or outside a
checkout.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
# Operations rates, H100 SXM data sheet (dense): float32 matrix products at
# float32 accuracy run on the tensor cores in 3xTF32 (three TF32 products
# each, CUTLASS's OpMultiplyAddFastF32, as SDPA's float32 kernel does), so
# their least time is at 495 / 3 TFLOP/s; other float32 work (the FFT) at
# the 67 TFLOP/s outside the tensor cores.  A bf16 operand is exact in
# bf16, so its product with a float32 one at float32 accuracy takes three
# bf16 products, one a part of the float32 operand (3xbf16, the bf16
# projection's conv1).
RATES = {"3xTF32": 495e12 / 3, "3xbf16": 989e12 / 3, "float32": 67e12,
         "bf16": 989e12}

PALLAS = "av_separation_tpu/ops/pallas/"
KERNELS = {
    "flash_attn_fwd": {
        "source": "av_separation_torch/csrc/flash_attn_fwd.cu",
        "replaces": PALLAS + "attention.py:462",
        "also_replaces": [PALLAS + "attention.py:269",
                          PALLAS + "attention.py:677"],
    },
    "flash_attn_bwd": {
        "source": "av_separation_torch/csrc/flash_attn_bwd.cu",
        "replaces": PALLAS + "attention.py:502",
        "head_rate": 0.1,
        "also_replaces": [PALLAS + "attention.py:320",
                          PALLAS + "attention.py:828",
                          PALLAS + "attention.py:842",
                          PALLAS + "attention.py:870"],
    },
    "audio_proj_fwd": {
        "source": "av_separation_torch/csrc/audio_proj.cu",
        "replaces": PALLAS + "audio_proj.py:75",
        "also_replaces": [],
        "note": "device_ms includes the weight split (audio_proj_split)",
    },
    "mask_decoder_fwd": {
        "source": "av_separation_torch/csrc/mask_decoder.cu",
        "replaces": PALLAS + "decoder.py:82",
        "also_replaces": [],
    },
    "stft_mag_fwd": {
        "source": "av_separation_torch/csrc/stft_fft.cu",
        "replaces": PALLAS + "stft.py:95",
        "also_replaces": [],
    },
    "stft_mag_4step_fwd": {
        "source": "av_separation_torch/csrc/stft_fft.cu",
        "replaces": PALLAS + "stft.py:95",
        "also_replaces": [],
        "note": "the four-step FFT: n_fft whose one-frame block does not "
                "fit shared memory; counted once a call",
    },
}
# The bfloat16 instances of three kernels: the same sources and wrappers
# (`wrapper` names the profiler's kernels); their rows apart, and their
# launches, which each wrapper counts under `name[bf16]`.
for _name in ("flash_attn_fwd", "flash_attn_bwd", "audio_proj_fwd"):
    KERNELS[_name + "[bf16]"] = dict(KERNELS[_name], wrapper=_name,
                                     dtype="bfloat16")
# The bf16 flash pair up to dh 256 runs on its Hopper kernels (wgmma, TMA,
# mbarriers); above 256 on thread-block clusters of dh / 128 blocks: the
# forward on flash_fwd_wgmma.cu's `wgmma` cluster kernel, the backward on
# flash_attn_bwd.cu's (mma.sync), as float32's.
for _name, _src, _note in (
        ("flash_attn_fwd", "flash_fwd_wgmma.cu",
         "dh above 256: flash_fwd_kernel_wgmma_cluster, the same source"),
        ("flash_attn_bwd", "flash_bwd_wgmma.cu",
         "dh above 256: flash_bwd_dkv_kernel_cluster / "
         "flash_bwd_dq_kernel_cluster<bf16> in "
         "av_separation_torch/csrc/flash_attn_bwd.cu")):
    KERNELS[_name + "[bf16]"].update(
        source="av_separation_torch/csrc/" + _src, note=_note)
for _name in ("flash_attn_fwd", "flash_attn_bwd"):
    KERNELS[_name]["note"] = (
        "dh 129-256: 8-warp blocks, two warps to each 16 rows, one "
        "128-column half each, "
        + ("flash_fwd_kernel_pair" if _name.endswith("fwd") else
           "flash_bwd_dkv_kernel_pair / flash_bwd_dq_kernel_pair")
        + "; dh above 256: a thread-block cluster of dh / 128 blocks, "
        + ("flash_fwd_kernel_cluster" if _name.endswith("fwd") else
           "flash_bwd_dkv_kernel_cluster / flash_bwd_dq_kernel_cluster"))
# The fused dropout sites: port-only kernels, since the JAX package leaves
# this chain to XLA's fusion; one forward and one backward launch a site.
for _name in ("dropout_fwd", "dropout_bwd"):
    KERNELS[_name] = {
        "source": "av_separation_torch/csrc/dropout_fused.cu",
        "replaces": None, "also_replaces": [],
        "note": "port-only: the JAX package leaves the dropout sites' "
                "mask, scale, activation and residual add to XLA's fusion "
                "(av_separation_tpu/ops/dropout.py, ops/activations.py)"}
    KERNELS[_name + "[bf16]"] = dict(KERNELS[_name], wrapper=_name,
                                     dtype="bfloat16")
# The conformer's GLU + depthwise convolution: port-only, since the JAX
# package has no conformer block; one launch forward, the backward's two
# kernels one call.
for _name in ("glu_dwconv_fwd", "glu_dwconv_bwd"):
    KERNELS[_name] = {
        "source": "av_separation_torch/csrc/glu_dwconv.cu",
        "replaces": None, "also_replaces": [],
        "note": "port-only: the conformer block (encoder_block "
                "'conformer'), which the JAX package does not have"}
    KERNELS[_name + "[bf16]"] = dict(KERNELS[_name], wrapper=_name,
                                     dtype="bfloat16")
# The device kernels of the wide route (above dh 256), by entry: listed in
# the summary line, and held by the build phase to no spill.
CLUSTER_INSTANCES = {
    "flash_attn_fwd": ["flash_fwd_kernel_cluster<0>",
                       "flash_fwd_kernel_cluster<1>"],
    "flash_attn_fwd[bf16]": ["flash_fwd_kernel_wgmma_cluster<0>",
                             "flash_fwd_kernel_wgmma_cluster<1>"],
    "flash_attn_bwd": ["flash_bwd_dkv_kernel_cluster<float,0>",
                       "flash_bwd_dq_kernel_cluster<float,0>",
                       "flash_bwd_dkv_kernel_cluster<float,1>",
                       "flash_bwd_dq_kernel_cluster<float,1>"],
    "flash_attn_bwd[bf16]": ["flash_bwd_dkv_kernel_cluster<bf16,0>",
                             "flash_bwd_dq_kernel_cluster<bf16,0>",
                             "flash_bwd_dkv_kernel_cluster<bf16,1>",
                             "flash_bwd_dq_kernel_cluster<bf16,1>"],
}
# The float32 device kernels at dh 256 (any dh in (128, 256], padded), by
# entry: listed in the summary line, and held by the build phase to no
# spill.
PAIR_INSTANCES = {
    "flash_attn_fwd": ["flash_fwd_kernel_pair"],
    "flash_attn_bwd": ["flash_bwd_dkv_kernel_pair",
                       "flash_bwd_dq_kernel_pair"],
}
# The projection's pre-pass, its own launch, splits each weight into three
# bf16 parts; it is counted under the instance it serves.
KERNELS["audio_proj_fwd[bf16]"]["note"] = (
    "device_ms includes the weight split (audio_proj_split[bf16])")
for _name in ("audio_proj_split", "audio_proj_split[bf16]"):
    KERNELS[_name] = dict(
        KERNELS[_name.replace("split", "fwd")], wrapper="audio_proj_split",
        note="the projection's pre-pass: each float32 weight as three bf16 "
             "parts, one launch a projection")
# The device kernels each wrapper launches, by name (torch.profiler).
KERNEL_NAMES = {
    "flash_attn_fwd": ("flash_fwd_kernel",),
    "flash_attn_bwd": ("flash_bwd_delta_kernel", "flash_bwd_dkv_kernel",
                       "flash_bwd_dq_kernel"),
    # audio_proj_wgmma_kernel<conv2, float32 x, BN>
    "audio_proj_fwd": ("audio_proj_split_kernel",
                       "audio_proj_wgmma_kernel<false, true",
                       "audio_proj_wgmma_kernel<true, true"),
    "audio_proj_fwd[bf16]": ("audio_proj_split_kernel",
                             "audio_proj_wgmma_kernel<false, false",
                             "audio_proj_wgmma_kernel<true, false"),
    "audio_proj_split": ("audio_proj_split_kernel",),
    "mask_decoder_fwd": ("mask_decoder_hidden_kernel",
                         "mask_decoder_mask_kernel"),
    "stft_mag_fwd": ("stft_fft_kernel",),
    "stft_mag_4step_fwd": ("stft_4step_kernel",),
    "dropout_fwd": ("dropout_fused_fwd_kernel",),
    "dropout_bwd": ("dropout_fused_bwd_kernel",),
    "glu_dwconv_fwd": ("glu_dwconv_fwd_kernel",),
    "glu_dwconv_bwd": ("glu_dwconv_bwd_kernel",
                       "glu_dwconv_bwd_reduce_kernel"),
}
ATTN_SEED = -12345  # an int32 dropout seed with the sign bit set

# Which routes of the parallel tier run with two ranks on one card, over
# gloo (NCCL refuses two ranks on one device: "Duplicate GPU detected"):
# fixed from tools/torch_gloo_cuda_probe.py's run on the card (PERF.md),
# not decided at run time.  gloo carries all-reduce, all-gather,
# reduce-scatter and broadcast on CUDA tensors, which is all that these
# four routes use; it refuses send / recv.  Each route is a mesh of two.
PARALLEL_ROUTES_ON_CARD = {"data": dict(data=2), "model": dict(model=2),
                           "seq": dict(seq=2), "fsdp": dict(fsdp=2)}
PARALLEL_ROUTES_CPU_ONLY = {
    "ring": "ring_attention rotates K/V by batch_isend_irecv, which gloo "
            "refuses on CUDA tensors; not on the main path; held on the "
            "CPU over gloo (tests/test_torch_sequence.py)",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, names=None, per_call=None):
    """Device time of one call of fn() from a torch.profiler trace of
    `iters` calls: the kernels whose names contain one of `names` (a
    wrapper's own kernels, one each per launch, or `per_call` of them in
    all a call), or every kernel and copy of the call (a library call),
    summed and divided by `iters`.

    A trace can come back short of events; one whose counts are not
    `iters` per kernel name (per launch) is taken again, up to three
    times, and then reported as not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us, counts = 0.0, {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA \
                    or getattr(e, "is_user_annotation", False):
                continue
            if names is None or any(n in e.name for n in names):
                us += e.time_range.end - e.time_range.start
                counts[e.name] = counts.get(e.name, 0) + 1
        whole = counts and all(c % iters == 0 for c in counts.values())
        if names is not None:
            whole = whole and sum(counts.values()) == iters * (
                per_call or len(names))
        if whole:
            return us / iters / 1e3
    emit({"device_ms_short_trace": {"iters": iters, "per_call": per_call,
                                    "counts": counts}})
    return "not measured"


def bound(nbytes: float, flops, rate: str):
    """The least time in ms and what sets it.  `flops` is a count at
    `rate`, or a {rate: count} dict whose times add."""
    parts = flops if isinstance(flops, dict) else {rate: flops}
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = sum(n / RATES[r] for r, n in parts.items()) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def want_launches(counts: dict) -> dict:
    """Launch counts with every kernel entry 0 (the [bf16] instances too)
    but those in `counts`, and one weight split a projection of each
    dtype."""
    from av_separation_torch.ops import kernels

    want = {name: 0 for name in kernels.LAUNCHES} | counts
    for dt in ("", "[bf16]"):
        want["audio_proj_split" + dt] = want["audio_proj_fwd" + dt]
    return want


def dropout_launches(m, steps: int = 1) -> dict:
    """The fused dropout sites' launches in `steps` training steps of the
    ModelConfig `m`: one forward and one backward a site (the two PE
    sites; drop1, drop2 and the FFN of every encoder and fusion layer,
    six a conformer layer (two SiLU FFNs, their halved residuals, the
    attention's and the convolution module's residuals), whose forwards
    run twice under remat; the decoder's GELU), the decoder's in float32
    and the others in the compute dtype; none at dropout 0."""
    if m.dropout == 0.0:
        return {}
    per_layer = 6 if m.encoder_block == "conformer" else 3
    sites = 2 * m.num_encoder_layers * per_layer + 3 * m.num_fusion_layers
    dt = "[bf16]" if m.compute_dtype == "bfloat16" else ""
    out = {"dropout_fwd" + dt: 2 + sites * (2 if m.remat else 1),
           "dropout_bwd" + dt: 2 + sites}
    for name in ("dropout_fwd", "dropout_bwd"):
        out[name] = out.get(name, 0) + 1  # the decoder's
    return {name: n * steps for name, n in out.items()}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|, taken in float64 (exact for float32 and bf16)."""
    return float((a.double() - b.double()).abs().max())


def within(a, b, atol: float, rtol: float = 0.0) -> bool:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b)))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env(state):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state["card"] = card_line()
    return {"card": state["card"],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "tf32": "off (cuda.matmul.allow_tf32 = cudnn.allow_tf32 = False)"}


def phase_build(state):
    """Builds every kernel; fails if an instance of the STFT's FFT kernels
    spills or is missing (13 of the one-block kernel: power of two, mixed
    radix and Bluestein, even and odd n_fft, up to and above n_fft 4096,
    and the prime-radix and Rader transforms, even and odd, up to 4096;
    the four passes of the four-step kernel), if an instance of the flash
    pair's `wgmma` kernels, of its float32 pair kernels at dh 256 or of its
    cluster kernels above dh 256 spills, or one of the three pair or
    twelve cluster instances is missing (<..., 1>: a block owning several
    chunks, above dh 2048), or if an instance of the projection's `wgmma`
    kernel spills.  Reports the shared memory a block of each cluster and
    pair kernel takes, as the libraries export it."""
    import re

    from av_separation_torch.ops.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build(ptxas_verbose=True)
    secs = time.perf_counter() - t0
    usage = {name: _ptxas_usage(log) for name, log in logs.items()}
    fft = {k: v for k, v in usage.get("stft_fft", {}).items()
           if k.startswith(("stft_fft_kernel", "stft_4step_kernel"))}
    spills = {k: [int(n) for ln in v
                  for n in re.findall(r"(\d+) bytes spill", ln)]
              for k, v in fft.items()}
    if logs.get("stft_fft") and (len(fft) != 17 or any(
            sum(n) for n in spills.values())):
        raise AssertionError(f"stft_fft_kernel / stft_4step_kernel "
                             f"instances {fft}")
    spilling = {k: n for u in usage.values() for k, v in u.items()
                if (n := sum(int(x) for ln in v
                             for x in re.findall(r"(\d+) bytes spill", ln)))}
    # The flash pair's Hopper instances (bf16 up to dh 256), its float32
    # pair instances at dh 256 and its cluster instances above dh 256
    # must not spill.
    flash = [k for name in ("flash_fwd_wgmma", "flash_bwd_wgmma",
                            "flash_attn_fwd", "flash_attn_bwd")
             for k in usage.get(name, {})
             if "_wgmma" in k or "_cluster" in k or "_pair" in k]
    named = [k for ks in (*CLUSTER_INSTANCES.values(),
                          *PAIR_INSTANCES.values()) for k in ks]
    if logs.get("flash_fwd_wgmma") and (
            len(flash) < 7 or any(k not in flash for k in named)
            or any(k in spilling for k in flash)):
        raise AssertionError(f"flash instances {flash}, spilling "
                             f"{spilling}")
    cluster_smem = _cluster_smem()
    # So must the projection's eight `wgmma` instances (conv1, conv2 at
    # each dtype, at 64 and 128 channels a block).
    proj = [k for k in usage.get("audio_proj", {})
            if k.startswith("audio_proj_wgmma_kernel")]
    if logs.get("audio_proj") and (
            len(proj) != 8 or any(k in spilling for k in proj)):
        raise AssertionError(f"projection instances {proj}, spilling "
                             f"{spilling}")
    # And the fused dropout kernels: two dtypes, five forward and four
    # backward epilogues (dropout_add's backward is dropout's), each with
    # the 16-byte vector and the one-element loop.
    drop = [k for k in usage.get("dropout_fused", {})
            if k.startswith("dropout_fused_")]
    if logs.get("dropout_fused") and (
            len(drop) != 36 or any(k in spilling for k in drop)):
        raise AssertionError(f"dropout instances {drop}, spilling "
                             f"{spilling}")
    # The GLU + depthwise kernels: three kernels, two dtypes, the K of
    # CONV_KERNELS; the conformer_l config's K 31 instances must not spill.
    from av_separation_torch.config import CONV_KERNELS
    glu = [k for k in usage.get("glu_dwconv", {})
           if k.startswith("glu_dwconv_")]
    if logs.get("glu_dwconv") and (
            len(glu) != 6 * len(CONV_KERNELS)
            or any(k in spilling for k in glu if k.endswith(",31>"))):
        raise AssertionError(f"glu_dwconv instances {glu}, spilling "
                             f"{spilling}")
    return {"build_s": round(secs, 2), "spilling_instances": spilling,
            "cluster_smem": cluster_smem, "ptxas": usage}


def _cluster_smem():
    """The shared memory (bytes) of a block of each cluster kernel, and of
    the float32 pair kernels at dh 256, as the built libraries export
    it."""
    import ctypes

    from av_separation_torch.ops.kernels import _build

    fwd_lib = _build.load("flash_attn_fwd")
    bwd_lib = _build.load("flash_attn_bwd")
    fwd = fwd_lib.avsep_flash_attn_fwd_cluster_smem
    wg = _build.load("flash_fwd_wgmma").avsep_flash_fwd_wgmma_cluster_smem
    bwd = bwd_lib.avsep_flash_attn_bwd_cluster_smem
    bwd.argtypes = [ctypes.c_int, ctypes.c_int]
    pair = bwd_lib.avsep_flash_attn_bwd_pair_smem
    pair.argtypes = [ctypes.c_int]
    return {"float32": {"fwd": fwd(), "dkv": bwd(0, 0), "dq": bwd(1, 0)},
            "bfloat16": {"fwd": wg(), "dkv": bwd(0, 1), "dq": bwd(1, 1)},
            "float32_pair_dh256": {
                "fwd": fwd_lib.avsep_flash_attn_fwd_pair_smem(),
                "dkv": pair(0), "dq": pair(1)}}


def _template_args(rest: str) -> list:
    """The template arguments of a mangled name's I...E list: float (f),
    bf16 (a class name holding bfloat16) and integer or bool literals
    (L<type><value>E)."""
    import re
    args, i = [], 1  # past the I
    while i < len(rest) and rest[i] != "E":
        if rest[i] == "f":
            args.append("float")
            i += 1
        elif rest[i] == "L":
            j = rest.index("E", i)
            args.append(re.sub(r"^L[a-z]+", "", rest[i:j]))
            i = j + 1
        elif (m := re.match(r"\d+", rest[i:])):
            n, start = int(m.group()), i + len(m.group())
            cls = rest[start:start + n]
            args.append("bf16" if "bfloat16" in cls else cls)
            i = start + n
        else:
            break
    return args


def _ptxas_usage(log: str) -> dict:
    """Registers and spills per device function from `nvcc -Xptxas -v`,
    keyed by the kernel's name and template arguments as mangled (for
    example flash_bwd_dkv_kernel<bf16,128,128,1>)."""
    import re
    usage, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN([^']+)'", ln)
        if m:
            # Nested names: <length><identifier> ... then I<args>E or E.
            rest, parts = m.group(1), []
            while (k := re.match(r"(\d+)", rest)):
                n = int(k.group(1))
                parts.append(rest[len(k.group(1)):len(k.group(1)) + n])
                rest = rest[len(k.group(1)) + n:]
            name = parts[-1] if parts else m.group(1)
            if rest.startswith("I"):
                name += "<" + ",".join(_template_args(rest)) + ">"
        elif name and ("registers" in ln or "spill" in ln):
            usage.setdefault(name, []).append(
                ln.split("ptxas info    : ")[-1].strip())
    return usage


def _attn_inputs(b, h, tq, tk, dh, kind, gen, dtype=torch.float32):
    """q/k/v as the serving path lays them out: self-attention reads three
    column slices of one fused projection; cross-attention reads q from its
    own projection and k/v from a fused (B, Tk, 2d) one; 'split' is the
    (B*H, T, dh) layout of the JAX `flash_attention` path.  In `dtype`."""
    from av_separation_torch.ops.attention import split_heads
    d = h * dh
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dtype).cuda()
    if kind == "self":
        q, k, v = rnd(b, tq, 3 * d).split(d, dim=-1)
    elif kind == "cross":
        q = rnd(b, tq, d)
        k, v = rnd(b, tk, 2 * d).split(d, dim=-1)
    else:
        q = rnd(b * h, tq, dh).unsqueeze(1)
        k, v = (rnd(b * h, tk, dh).unsqueeze(1) for _ in range(2))
        return q, k, v
    return split_heads(q, h), split_heads(k, h), split_heads(v, h)


def make_record(results, failures):
    """The `kernels` phase's row recorder: appends each row to
    results[name] and each failure to `failures`."""

    def record(name, shape, err, tol, extra_errs, fn_k, fn_p, fn_lib,
               nbytes, flops, iters, op_rate="3xTF32", per_call=None,
               **extra):
        # Each C entry point sets the tensors' device and restores the
        # caller's (csrc/device_guard.cuh); with one card, what can be
        # read back is that the current device is unchanged.
        before = torch.cuda.current_device()
        fn_k()
        torch.cuda.synchronize()
        restored = torch.cuda.current_device() == before
        # Host-inclusive times (CUDA events around back-to-back calls) in
        # turns (kernel, plain, plain, kernel), each the mean of the two;
        # then device times from a profiler trace: the kernel's own device
        # kernels per launch, every device kernel of one library call.
        # A row without a plain version (its bases too large) times the
        # kernel alone.
        times = [cuda_ms(fn, iters) if fn is not None else None
                 for fn in (fn_k, fn_p, fn_p, fn_k)]
        ms = (times[0] + times[3]) / 2
        plain_ms = (times[1] + times[2]) / 2 if fn_p is not None else None
        lib_ms = cuda_ms(fn_lib, iters) if fn_lib is not None else None
        dev_ms = device_ms(fn_k, iters, KERNEL_NAMES.get(name) or
                           KERNEL_NAMES[KERNELS[name].get("wrapper", name)],
                           per_call)
        lib_dev_ms = device_ms(fn_lib, iters) if fn_lib is not None else None
        bound_ms, bound_by = bound(nbytes, flops, op_rate)
        ok = err <= tol and all(e <= t for e, t in extra_errs.values()) \
            and extra.get("bit_identical", True) and restored
        measured = [t for t in (ms, dev_ms, lib_ms, lib_dev_ms)
                    if isinstance(t, float)]
        row = {"shape": shape, "max_abs_err": err, "tol": tol,
               "extra_errs": extra_errs, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "device_ms": dev_ms,
               "library_device_ms": lib_dev_ms, "bound_ms": bound_ms,
               "device_restored": restored,
               "bound_by": bound_by,
               "rate": " + ".join(
                   f"{r} {RATES[r] / 1e12:g} TFLOP/s"
                   for r in (flops if isinstance(flops, dict)
                             else [op_rate])),
               "ok": ok, **extra}
        if isinstance(dev_ms, float) and isinstance(lib_dev_ms, float):
            row["device_vs_library"] = dev_ms / lib_dev_ms
        results[name].append(row)
        emit({"kernel": name, **row})
        if not ok:
            failures.append(f"{name} {shape}")
        if any(t < bound_ms for t in measured):
            failures.append(f"{name} {shape}: a time below its bound "
                            f"{bound_ms} ms, so the bound is wrong")

    return record


def phase_kernels(state):
    from av_separation_torch.ops.kernels.attention import mma_3xtf32_probe

    gen = torch.Generator().manual_seed(0)
    results = {name: [] for name in KERNELS}
    failures = []

    # The m16n8k8 TF32 fragment layouts the flash kernels build on: one
    # 3xTF32 product against float64 on the host.  Sums of 8 products of
    # unit normals: 3xTF32 keeps ~2^-20 relative, so 1e-5 (a wrong layout
    # gives O(1) errors, 1xTF32 ~1e-3).
    a = torch.randn(16, 8, generator=gen)
    b = torch.randn(8, 8, generator=gen)
    c = mma_3xtf32_probe(a.cuda(), b.cuda()).cpu().double()
    probe_err = max_err(c, a.double() @ b.double())
    emit({"mma_3xtf32_probe": "m16n8k8 against float64",
          "max_abs_err": probe_err, "tol": 1e-5})
    if probe_err > 1e-5:
        failures.append(f"mma_3xtf32_probe {probe_err}")

    record = make_record(results, failures)

    # flash attention: the scaled path's three shapes (serving at dropout
    # 0, training at 0.1), demo, split, long; forward, then backward.
    attn_cases = [
        ("scaled audio self", 8, 4, 501, 501, 128, "self"),
        ("scaled visual self", 8, 4, 200, 200, 128, "self"),
        ("scaled fusion cross", 8, 4, 501, 501, 128, "cross"),
        ("demo self", 4, 4, 63, 63, 32, "self"),
        ("demo cross split", 4, 4, 63, 50, 32, "split"),
        ("default self dh64", 8, 4, 501, 501, 64, "self"),
        ("odd width self dh49", 8, 4, 501, 501, 49, "self"),
        ("long self Tk>512", 2, 4, 1024, 1024, 128, "self"),
        ("wide head self dh256", 8, 2, 501, 501, 256, "self"),
        ("wide head self dh200", 8, 2, 501, 501, 200, "self"),
        # above 256: a cluster of dh / 128 blocks (dh 1152: 9, the
        # non-portable size; dh 2048: 16, the largest); above 2048 blocks
        # own several chunks (dh 2176: 17 chunks on 9 blocks)
        ("wide d1024 self dh512", 8, 2, 501, 501, 512, "self"),
        ("wide self dh320", 8, 2, 501, 501, 320, "self"),
        ("wide self dh1152", 2, 1, 501, 501, 1152, "self"),
        ("wide self dh2048", 1, 1, 501, 501, 2048, "self"),
        ("wide self dh2176", 1, 1, 501, 501, 2176, "self"),
    ]
    # bfloat16: the scaled and default-model self-attention, the tiled
    # route at T 1024, the wide heads, and the bench's demo shapes (batch
    # 128: self-attention 63 x 63, cross-attention 63 x 50).
    bf16_cases = [attn_cases[i] for i in (0, 5, 7, 8, 10, 11, 12, 13, 14)] + [
        ("bench demo self", 128, 4, 63, 63, 32, "self"),
        ("bench demo cross", 128, 4, 63, 50, 32, "cross")]
    for rate in (0.0, 0.1):
        for dtype, cases in ((torch.float32, attn_cases),
                             (torch.bfloat16, bf16_cases)):
            for label, b, h, tq, tk, dh, kind in cases:
                q, k, v = _attn_inputs(b, h, tq, tk, dh, kind, gen, dtype)
                _attn_rows(record, label, rate, q, k, v, gen)

    # The host cost of one TMA tensor-map encode (the bf16 forward encodes
    # three a call, the backward four).
    from av_separation_torch.ops.kernels.attention import tma_encode_us
    q, _, _ = _attn_inputs(8, 4, 501, 501, 128, "self", gen, torch.bfloat16)
    encode_us = tma_encode_us(q)

    _proj_rows(record, gen)
    _decoder_rows(record, gen)
    _dropout_rows(record)
    _glu_dwconv_rows(record)
    _stft_rows(record, gen)
    _grid_cap_rows(record, gen)

    state["kernel_rows"] = results
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")
    return {"checked": {n: len(r) for n, r in results.items()},
            "mma_3xtf32_probe_err": probe_err,
            "tma_encode_us_host": encode_us}


def _grid_cap_rows(record, gen):
    """Grids past 65,535 in y: flash at B*H 65,536 (B 16,384, H 4, T 16,
    dh 32 at both dtypes; dh 128 in bf16, the `wgmma` kernels' TMA maps
    too), forward and backward at dropout 0 and 0.1, and the projection
    at B 65,536 (T 8, D 64) at both dtypes.  Last in the phase: their
    profiler traces (of ~1 GB calls) have left later traces short of
    events, so no other row is timed after them."""
    grid_cap = ("grid cap B*H 65536", 16384, 4, 16, 16, 32, "self")
    for rate in (0.0, 0.1):
        for dtype, cases in ((torch.float32, [grid_cap]),
                             (torch.bfloat16, [grid_cap, (
                                 "grid cap B*H 65536 dh128",) + grid_cap[1:5]
                                 + (128, "self")])):
            for label, b, h, tq, tk, dh, kind in cases:
                q, k, v = _attn_inputs(b, h, tq, tk, dh, kind, gen, dtype)
                _attn_rows(record, label, rate, q, k, v, gen)
                del q, k, v
                torch.cuda.empty_cache()
    _proj_rows(record, gen, [("grid cap", 65536, 8, 64, torch.float32),
                             ("grid cap", 65536, 8, 64, torch.bfloat16)])


def bf16_tol(ref: torch.Tensor, ulps: int = 2) -> float:
    """`ulps` bf16 ulps at the binade of ref's peak: the kernel and its
    plain version round at the same points but sum in another order in
    float32, so a value next to a rounding boundary may round the other
    way (one ulp), and an operand rounded the other way (p, pd, ds) moves
    a sum by about as much again."""
    import math
    peak = max(float(ref.float().abs().max()), 2.0 ** -126)
    return ulps * 2.0 ** (math.floor(math.log2(peak)) - 7)


def _attn_rows(record, label, rate, q, k, v, gen):
    """One forward row and one backward row of flash attention at `rate`,
    in q's dtype.

    Float32 on both sides, sums over <= 1024 keys in another order: 2e-5
    on o and on the gradients (O(1) values), 1e-4 on lse; at head dims
    above 128 (q k^T sums 256 products) 3e-5.  bfloat16: o and the
    gradients within `bf16_tol` (2 ulps at their peak), lse (float32 from
    float32 sums of exact bf16 products) 1e-4.  The library yardstick is
    F.scaled_dot_product_attention (in q's dtype, same dropout rate),
    forward alone for the forward row and forward + backward for the
    backward row; the port never calls it.  The bound of a bf16 row is at
    989 TFLOP/s (bf16 products) and 2-byte operands.
    """
    import torch.nn.functional as F

    from av_separation_torch.ops.kernels.attention import (
        flash_attn_bwd, flash_attn_bwd_torch, flash_attn_fwd,
        flash_attn_fwd_torch)

    b, h, tq, dh = q.shape
    tk = k.shape[2]
    seed = ATTN_SEED
    bf16 = q.dtype == torch.bfloat16
    suffix, op_rate, esize = ("[bf16]", "bf16", 2) if bf16 \
        else ("", "3xTF32", 4)
    shape = (f"{label} B={b} H={h} Tq={tq} Tk={tk} dh={dh} "
             f"dropout={rate} {str(q.dtype).split('.')[-1]}")
    o_k, lse_k = flash_attn_fwd(q, k, v, rate, seed)
    o_p, lse_p = flash_attn_fwd_torch(q, k, v, rate, seed)
    do = torch.randn(o_p.shape, generator=gen).to(q.dtype).cuda()
    g_k = flash_attn_bwd(q, k, v, o_k, do, lse_k, rate, seed)
    g_k2 = flash_attn_bwd(q, k, v, o_k, do, lse_k, rate, seed)
    g_p = flash_attn_bwd_torch(q, k, v, o_p, do, lse_p, rate, seed)
    torch.cuda.synchronize()
    bh = b * h
    lib_fwd = lambda: F.scaled_dot_product_attention(q, k, v,
                                                     dropout_p=rate)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def lib_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=rate)
        torch.autograd.grad(out, (qg, kg, vg), do)

    f32_tol = 3e-5 if dh > 128 else 2e-5
    tol = (lambda ref: bf16_tol(ref)) if bf16 else (lambda ref: f32_tol)
    # Forward: 2 products of 2*Tq*Tk*dh against q, k, v in and o, lse out
    # (lse float32).
    record("flash_attn_fwd" + suffix, shape, max_err(o_k, o_p), tol(o_p),
           {"lse": (max_err(lse_k, lse_p), 1e-4)},
           lambda: flash_attn_fwd(q, k, v, rate, seed),
           lambda: flash_attn_fwd_torch(q, k, v, rate, seed), lib_fwd,
           esize * bh * (2 * tq * dh + 2 * tk * dh) + 4 * bh * tq,
           4 * bh * tq * tk * dh, 20, op_rate, dropout=rate,
           dtype=str(q.dtype).split(".")[-1])
    # Backward: the least work is 5 products (QK^T, dO V^T, dV, dQ, dK)
    # against q, k, v, o, dO, lse in and dQ, dK, dV out; what the kernels
    # recompute on top is not counted.
    errs = [max_err(x, y) for x, y in zip(g_k, g_p)]
    tols = [tol(y) for y in g_p]
    record("flash_attn_bwd" + suffix, shape, max(errs), max(tols),
           {"dq": (errs[0], tols[0]), "dk": (errs[1], tols[1]),
            "dv": (errs[2], tols[2])},
           lambda: flash_attn_bwd(q, k, v, o_k, do, lse_k, rate, seed),
           lambda: flash_attn_bwd_torch(q, k, v, o_p, do, lse_p, rate, seed),
           lib_fwd_bwd,
           esize * bh * (3 * tq * dh + 2 * tk * dh
                         + (tq * dh + 2 * tk * dh)) + 4 * bh * tq,
           10 * bh * tq * tk * dh, 10, op_rate, dropout=rate,
           dtype=str(q.dtype).split(".")[-1],
           bit_identical=all(torch.equal(x, y) for x, y in zip(g_k, g_k2)),
           library="F.scaled_dot_product_attention forward + backward")


# The projection's and decoder's shapes: (label, B, T, d, S), F 257.
# d 196 runs zero-padded to 200; d 1536 is above the 1024 the kernels
# once capped.
HEAD_SHAPES = (("scaled", 8, 501, 512, 2), ("demo", 4, 63, 128, 2),
               ("three_speaker", 8, 63, 512, 3),
               ("multihost", 16, 501, 1024, 4),
               ("odd width", 2, 501, 196, 2), ("wide", 2, 501, 1536, 2))


def _proj_rows(record, gen, cases=None):
    """The audio projection against its plain version at the named
    configs' shapes, x in the model's padded rows (`proj_input`): float32
    sums of 3 (F + D) products in another order, 1e-4 on y and h (O(1)
    values).  Library: two cuDNN conv1d with ReLU on the (B, F, T) layout
    with torch Conv1d weights, in float32 (timed only, never called by the
    port).  Then a bf16 x (float32 math: y and h in bf16 within
    `bf16_tol`, and the float32 h that conv1 writes for conv2 within 1e-4,
    which products of bf16-rounded weights would miss) at the scaled,
    bench (demo, batch 128), three_speaker and multihost shapes; the bound
    counts the bf16 bytes, conv1's products at three bf16 products' rate
    (x is exact in bf16) and conv2's at 3xTF32's; the library is the same
    two conv1d in float32 on the upcast x, cast to bf16 (the same
    function), and beside it, timed only, cuDNN in bf16 (bf16 products of
    rounded weights: another function; `library_bf16_*`).  Beside each
    row, the weight split's own row: its parts against the plain split,
    bit for bit.  `cases` replaces the shapes (`_grid_cap_rows`: B
    65,536)."""
    import torch.nn.functional as F

    from av_separation_torch.ops.kernels import kernel_width
    from av_separation_torch.ops.kernels.audio_proj import (
        _launch, audio_proj_fwd, audio_proj_fwd_torch, audio_proj_split,
        proj_input, proj_plan, weight_parts_torch)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = cases or [s[:4] + (torch.float32,) for s in HEAD_SHAPES] + [
        ("scaled", 8, 501, 512, torch.bfloat16),
        ("bench demo", 128, 63, 128, torch.bfloat16),
        ("three_speaker", 8, 63, 512, torch.bfloat16),
        ("multihost", 16, 501, 1024, torch.bfloat16)]
    for label, b, t, d, dtype in cases:
        bf16 = dtype == torch.bfloat16
        dt = str(dtype).split(".")[-1]
        f = 257
        iters = 5 if b > 65535 else 20
        x = torch.randn(b, t, f, generator=gen).abs().to(dtype).cuda()
        # The model hands x over in rows padded to 16 bytes (260 or 264).
        xk = proj_input(x.transpose(1, 2))
        lim1, lim2 = (3 * f) ** -0.5, (3 * d) ** -0.5
        w1 = ((torch.rand(3, f, d, generator=gen) * 2 - 1) * lim1).cuda()
        b1 = ((torch.rand(d, generator=gen) * 2 - 1) * lim1).cuda()
        w2 = ((torch.rand(3, d, d, generator=gen) * 2 - 1) * lim2).cuda()
        b2 = ((torch.rand(d, generator=gen) * 2 - 1) * lim2).cuda()
        x_bft = x.transpose(1, 2).contiguous()
        c1, c2 = (w.permute(2, 1, 0).contiguous() for w in (w1, w2))

        def lib(x_bft=x_bft, c1=c1, b1=b1, c2=c2, b2=b2):
            return torch.relu(F.conv1d(torch.relu(F.conv1d(
                x_bft.float(), c1, b1, padding=1)), c2, b2,
                padding=1)).to(dtype)

        y_k, h_k = audio_proj_fwd(xk, w1, b1, w2, b2)
        y_p, h_p = audio_proj_fwd_torch(x, w1, b1, w2, b2)
        y_lib = lib().transpose(1, 2)
        extra_errs = {"h": (max_err(h_k, h_p),
                            bf16_tol(h_p) if bf16 else 1e-4)}
        extra = {}
        if bf16:
            # conv2's A, the float32 h, against the plain float32 h.
            h32 = _launch(xk, w1, b1, w2, b2, keep_h32=True)[2]
            h32_p = audio_proj_fwd_torch(x.float(), w1, b1, w2, b2)[1]
            extra_errs["h32"] = (max_err(h32, h32_p), 1e-4)
            del h32, h32_p
            lb = tuple(w.to(dtype) for w in (c1, b1, c2, b2))

            def lib_bf16(x_bft=x_bft, c1=lb[0], b1=lb[1], c2=lb[2],
                         b2=lb[3]):
                return torch.relu(F.conv1d(torch.relu(F.conv1d(
                    x_bft, c1, b1, padding=1)), c2, b2, padding=1))

            extra = {"library_bf16_max_abs_err": max_err(
                         lib_bf16().transpose(1, 2), y_p),
                     "library_bf16_device_ms": device_ms(lib_bf16, iters),
                     "library_bf16": "the same two conv1d in bf16 (cuDNN): "
                                     "timed only, another function"}
        torch.cuda.synchronize()
        esize = 2 if bf16 else 4
        nbytes = esize * (b * t * f + 2 * b * t * d) \
            + 4 * (3 * f * d + 3 * d * d + 2 * d)
        # At bf16, conv1's products (a bf16 x) take three bf16 products.
        flops = {"3xbf16": 2 * b * t * 3 * f * d,
                 "3xTF32": 2 * b * t * 3 * d * d} if bf16 \
            else 2 * b * t * 3 * (f + d) * d
        shape = f"{label} B={b} T={t} F={f} D={d} {dt}"
        record("audio_proj_fwd" + ("[bf16]" if bf16 else ""), shape,
               max_err(y_k, y_p), bf16_tol(y_p) if bf16 else 1e-4,
               extra_errs, lambda: audio_proj_fwd(xk, w1, b1, w2, b2),
               lambda: audio_proj_fwd_torch(x, w1, b1, w2, b2), lib,
               nbytes, flops, iters,
               plan=proj_plan(b, t, kernel_width(d), sms),
               library_max_abs_err=max_err(y_lib, y_p), dtype=dt,
               library="relu(conv1d(relu(conv1d(x, W1)), W2)), cuDNN in "
                       "float32" + (" on the upcast x" if bf16 else ""),
               **extra)
        # The split alone: float32 weights in, three bf16 parts out, equal
        # to the plain split bit for bit.
        parts = audio_proj_split(w1, w2, dtype)
        plain = (weight_parts_torch(w1), weight_parts_torch(w2))
        torch.cuda.synchronize()
        n = w1.numel() + w2.numel()
        record("audio_proj_split" + ("[bf16]" if bf16 else ""), shape,
               max(max_err(a, c) for a, c in zip(parts, plain)), 0.0,
               {}, lambda: audio_proj_split(w1, w2, dtype),
               lambda: (weight_parts_torch(w1), weight_parts_torch(w2)),
               None, 4 * n + 6 * n, 0, iters, "bf16", dtype=dt)
        del x, xk, y_k, h_k, y_p, h_p, y_lib
        torch.cuda.empty_cache()


def _decoder_rows(record, gen, shapes=HEAD_SHAPES):
    """The fused mask decoder against its plain version at the named
    configs' shapes: masks 1e-5 (sigmoid outputs of float32 sums of d and
    2d products), separated 1e-5 x the peak of mixed.  Weights in the torch
    Linear layout, as the model passes them.  Library: F.linear, F.gelu,
    F.linear, torch.sigmoid, the permute and the multiply (cuBLAS; timed
    only, never called by the port)."""
    import torch.nn.functional as F

    from av_separation_torch.ops.kernels import kernel_width
    from av_separation_torch.ops.kernels.decoder import (
        decoder_rows, mask_decoder_fwd, mask_decoder_fwd_torch)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, b, t, d, s in shapes:
        f = 257
        x = torch.randn(b, t, d, generator=gen).cuda()
        lim1, lim2 = d ** -0.5, (2 * d) ** -0.5
        w1 = ((torch.rand(2 * d, d, generator=gen) * 2 - 1) * lim1).cuda()
        b1 = ((torch.rand(2 * d, generator=gen) * 2 - 1) * lim1).cuda()
        w2 = ((torch.rand(s * f, 2 * d, generator=gen) * 2 - 1)
              * lim2).cuda()
        b2 = ((torch.rand(s * f, generator=gen) * 2 - 1) * lim2).cuda()
        mixed = (torch.randn(b, f, t, generator=gen).abs() * 10).cuda()

        def lib(x=x, w1=w1, b1=b1, w2=w2, b2=b2, mixed=mixed, b=b, t=t,
                s=s):
            m = torch.sigmoid(F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2))
            m = m.reshape(b, t, s, -1).permute(0, 2, 3, 1)
            return m * mixed[:, None], m

        sep_k, m_k = mask_decoder_fwd(x, w1, b1, w2, b2, mixed, s)
        sep_p, m_p = mask_decoder_fwd_torch(x, w1, b1, w2, b2, mixed, s)
        torch.cuda.synchronize()
        sf = s * f
        nbytes = 4 * (b * t * d + 2 * d * d + 2 * d + 2 * d * sf + sf
                      + b * f * t + 2 * b * sf * t)
        flops = 2 * b * t * (d * 2 * d + 2 * d * sf)
        sep_tol = 1e-5 * float(mixed.abs().max())
        record("mask_decoder_fwd", f"{label} B={b} T={t} d={d} S={s} F={f}",
               max_err(m_k, m_p), 1e-5,
               {"separated": (max_err(sep_k, sep_p), sep_tol)},
               lambda: mask_decoder_fwd(x, w1, b1, w2, b2, mixed, s),
               lambda: mask_decoder_fwd_torch(x, w1, b1, w2, b2, mixed, s),
               lib, nbytes, flops, 20,
               rows=[decoder_rows(b * t, 2 * kernel_width(d), sms),
                     decoder_rows(b * t, s * f, sms)],
               library="F.linear, F.gelu, F.linear, sigmoid, permute, "
                       "* mixed (cuBLAS)")


# The fused dropout rows: (label, epilogue, shape, dtype, part, NaN at the
# dropped positions).  The cells' sites: scaled B 128 and multihost B 48
# at T 501, bf16 but the decoder's float32 GELU; then a TP rank's column
# block of a full-width draw, NaN inputs, and the float32 instances.
DROPOUT_ROWS = (
    ("scaled PE", "dropout", (128, 501, 512), torch.bfloat16, (0, 1), False),
    ("scaled drop1 / drop2", "dropout_add", (128, 501, 512), torch.bfloat16,
     (0, 1), False),
    ("scaled encoder FFN", "relu_dropout", (128, 501, 2048), torch.bfloat16,
     (0, 1), False),
    ("scaled fusion FFN", "gelu_dropout", (128, 501, 2048), torch.bfloat16,
     (0, 1), False),
    ("scaled decoder", "gelu_dropout", (128, 501, 1024), torch.float32,
     (0, 1), False),
    ("multihost PE", "dropout", (48, 501, 1024), torch.bfloat16, (0, 1),
     False),
    ("multihost drop1 / drop2", "dropout_add", (48, 501, 1024),
     torch.bfloat16, (0, 1), False),
    ("multihost encoder FFN", "relu_dropout", (48, 501, 4096),
     torch.bfloat16, (0, 1), False),
    ("multihost fusion FFN", "gelu_dropout", (48, 501, 4096),
     torch.bfloat16, (0, 1), False),
    ("multihost decoder", "gelu_dropout", (48, 501, 2048), torch.float32,
     (0, 1), False),
    ("TP rank block part (1, 2)", "relu_dropout", (48, 501, 2048),
     torch.bfloat16, (1, 2), False),
    ("NaN at the dropped", "gelu_dropout", (128, 501, 2048), torch.bfloat16,
     (0, 1), True),
    ("float32 scaled PE", "dropout", (128, 501, 512), torch.float32, (0, 1),
     False),
    ("conformer_l FFN", "silu_dropout", (64, 501, 2048), torch.bfloat16,
     (0, 1), False),
    ("conformer_l visual FFN", "silu_dropout", (64, 200, 2048),
     torch.bfloat16, (0, 1), False),
    ("float32 conformer_l FFN", "silu_dropout", (64, 501, 2048),
     torch.float32, (0, 1), False),
    ("NaN at the dropped", "silu_dropout", (64, 501, 2048), torch.bfloat16,
     (0, 1), True),
    ("float32 scaled drop1 / drop2", "dropout_add", (128, 501, 512),
     torch.float32, (0, 1), False),
    ("float32 scaled encoder FFN", "relu_dropout", (128, 501, 2048),
     torch.float32, (0, 1), False),
    ("float32 scaled fusion FFN", "gelu_dropout", (128, 501, 2048),
     torch.float32, (0, 1), False),
)


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place of their dtype (float32 or
    bf16), elementwise: the distance of their bit patterns, ordered."""
    def ordered(t):
        if t.dtype == torch.bfloat16:
            i, mag = t.view(torch.int16).to(torch.int32), 0x7FFF
        else:
            i, mag = t.view(torch.int32).to(torch.int64), 0x7FFFFFFF
        return torch.where(i < 0, -(i & mag), i)
    return (ordered(a) - ordered(b)).abs()


def _dropout_rows(record):
    """The fused dropout kernels against their plain versions (the PyTorch
    chain) at `DROPOUT_ROWS`, forward then backward: bit for bit, but the
    GELU and SiLU forwards within 1 ulp of their dtype (F.gelu and F.silu
    are one PyTorch kernel each, whose float32 expression the compiler may
    contract otherwise than the kernel's __f*_rn ops; the share of
    elements that differ printed).  Bound: the bytes each reads and writes at 3.35 TB/s;
    yardstick: the plain chain's device time."""
    from av_separation_torch.ops.dropout import (keep_bits, keep_scale,
                                                 quantized_rate)
    from av_separation_torch.ops.kernels.dropout_fused import (
        dropout_bwd, dropout_bwd_torch, dropout_fwd, dropout_fwd_torch)

    cg = torch.Generator(device="cuda").manual_seed(0)
    n = quantized_rate(0.1)
    for label, kind, shape, dtype, part, nan in DROPOUT_ROWS:
        def draw():
            return (torch.randn(shape, device="cuda", generator=cg) * 2).to(
                dtype)

        x, g = draw(), draw()
        res = draw() if kind == "dropout_add" else None
        bits = keep_bits(shape, cg, "cuda", part)
        if nan:
            x.masked_fill_(bits < n, float("nan"))
            g.masked_fill_(bits < n, float("nan"))
        s = keep_scale(n, dtype)
        size = x.element_size()
        numel = x.numel()
        dt = "[bf16]" if dtype == torch.bfloat16 else ""
        row = f"{label} {'x'.join(map(str, shape))} {kind}"
        tag = {"dtype": str(dtype).split(".")[-1], "epilogue": kind,
               "part": list(part), "nan_at_dropped": nan,
               "library": "the plain chain (PyTorch's kernels)"}

        out_k = dropout_fwd(kind, x, bits, n, s, res)
        out_p = dropout_fwd_torch(kind, x, bits, n, s, res)
        fwd_bytes = numel * (2 * size + 1 + (size if res is not None else 0))
        if kind in ("gelu_dropout", "silu_dropout"):
            d = ulps(out_k, out_p)
            err, tol = float(d.max()), 1.0
            extra = {"unit": "ulp", "differ_share":
                     float((d > 0).double().mean())}
        else:
            err, tol = max_err(out_k, out_p), 0.0
            extra = {"bit_identical": torch.equal(out_k, out_p)}
        record(f"dropout_fwd{dt}", row, err, tol, {},
               lambda: dropout_fwd(kind, x, bits, n, s, res),
               lambda: dropout_fwd_torch(kind, x, bits, n, s, res),
               lambda: dropout_fwd_torch(kind, x, bits, n, s, res),
               fwd_bytes, 0, 10, **tag, **extra)

        saved = {"relu_dropout": out_p, "gelu_dropout": x,
                 "silu_dropout": x}.get(kind)
        bwd_bits = None if kind == "relu_dropout" else bits
        bwd_bytes = numel * ((2 + (saved is not None)) * size
                             + (bwd_bits is not None))
        dx_k = dropout_bwd(kind, g, saved, bwd_bits, n, s)
        dx_p = dropout_bwd_torch(kind, g, saved, bwd_bits, n, s)
        record(f"dropout_bwd{dt}", row, max_err(dx_k, dx_p), 0.0, {},
               lambda: dropout_bwd(kind, g, saved, bwd_bits, n, s),
               lambda: dropout_bwd_torch(kind, g, saved, bwd_bits, n, s),
               lambda: dropout_bwd_torch(kind, g, saved, bwd_bits, n, s),
               bwd_bytes, 0, 10, **tag,
               bit_identical=torch.equal(dx_k, dx_p))
        del x, g, res, bits, out_k, out_p, dx_k, dx_p, saved
        torch.cuda.empty_cache()


# (label, B, T, d, K, dtype) of the GLU + depthwise rows: conformer_l's
# audio and visual calls in both dtypes, and ragged edges (d 196: a slab of
# 4 channels past 192; T 37: a part tile; K 7).
GLU_DWCONV_ROWS = (
    ("conformer_l audio", 64, 501, 512, 31, torch.bfloat16),
    ("conformer_l visual", 64, 200, 512, 31, torch.bfloat16),
    ("float32 conformer_l audio", 64, 501, 512, 31, torch.float32),
    ("ragged d196 T37 K7", 3, 37, 196, 7, torch.bfloat16),
    ("float32 ragged d196 T37 K7", 3, 37, 196, 7, torch.float32),
)


def _glu_dwconv_rows(record):
    """The GLU + depthwise kernels against their plain version (F.glu and
    the grouped conv1d in float32, no TF32, rounded once) at
    `GLU_DWCONV_ROWS`, forward then backward.  Tolerances: in float32 1e-5
    x the peak for y and du (31 products a sum), 1e-4 for dw and dbias (B T
    products a sum, in another order); in bf16 1 ulp of each stored element
    (both sides round the same float32 value, which their sums' orders move
    by ~1e-7 relative: across a rounding boundary now and then), or the
    float32 tolerance where that is larger (a sum near nought).  The
    backward twice, bit for bit (a fixed order of sums).  Bound: the bytes
    at 3.35 TB/s (`conformer_work`'s count); yardstick: PyTorch's own chain
    in the compute dtype (bf16 F.glu, cuDNN's grouped conv1d)."""
    import torch.nn.functional as F

    from av_separation_torch.ops.kernels.glu_dwconv import (
        glu_dwconv_bwd_cuda, glu_dwconv_fwd_cuda, glu_dwconv_torch)

    cg = torch.Generator(device="cuda").manual_seed(1)
    saved_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for label, b, t, d, k, dtype in GLU_DWCONV_ROWS:
            def rnd(*shape, scale=1.0):
                return (torch.randn(shape, device="cuda", generator=cg)
                        * scale).to(dtype)

            u = rnd(b, t, 2 * d, scale=2.0)
            w = rnd(d, 1, k, scale=1.0 / math.sqrt(k))
            bias = rnd(d, scale=0.1)
            dy = rnd(b, t, d)
            dt = "[bf16]" if dtype == torch.bfloat16 else ""
            size = u.element_size()
            row = f"{label} B{b} T{t} d{d} K{k}"
            tag = {"dtype": str(dtype).split(".")[-1],
                   "library": "PyTorch's chain in the compute dtype: F.glu, "
                              "cuDNN grouped conv1d"}

            def chain(uu, ww, bb):
                return F.conv1d(F.glu(uu, dim=-1).transpose(1, 2), ww, bb,
                                padding=(k - 1) // 2,
                                groups=d).transpose(1, 2)

            def err_of(got, want, rel=1e-5):
                scale = float(want.abs().max())
                if dtype == torch.float32:
                    return max_err(got, want), rel * scale, {}
                # In bf16: |diff| in units of the larger of the stored
                # value's ulp and `rel` x the peak (near nought the float32
                # sums' order moves a value by more than its own ulp).
                wf, diff = want.float(), (got.float() - want.float()).abs()
                ulp = torch.exp2(torch.floor(torch.log2(
                    wf.abs().clamp_min(1e-30))) - 7)
                units = diff / torch.clamp(ulp, min=rel * scale)
                return float(units.max()), 1.0, {
                    "differ_share": float((got != want).double().mean())}

            y_k = glu_dwconv_fwd_cuda(u, w, bias)
            y_p = glu_dwconv_torch(u, w, bias)
            err, tol, extra = err_of(y_k, y_p)
            record(f"glu_dwconv_fwd{dt}", row, err, tol, {},
                   lambda: glu_dwconv_fwd_cuda(u, w, bias),
                   lambda: glu_dwconv_torch(u, w, bias),
                   lambda: chain(u, w, bias),
                   b * t * 3 * d * size, 2.0 * b * t * d * k, 10,
                   op_rate="bf16", **tag, **extra)

            du_k, dw_k, db_k = glu_dwconv_bwd_cuda(u, w, dy)
            again = glu_dwconv_bwd_cuda(u, w, dy)
            same = all(torch.equal(x, y)
                       for x, y in zip((du_k, dw_k, db_k), again))
            leaves = [x.detach().requires_grad_() for x in (u, w, bias)]
            y_plain = glu_dwconv_torch(*leaves)
            du_p, dw_p, db_p = torch.autograd.grad(y_plain, leaves, dy,
                                                   retain_graph=True)
            y_lib = chain(*leaves)
            errs = {}
            for name, got, want, rel in (
                    ("du", du_k, du_p, 1e-5),
                    ("dw", dw_k, dw_p.reshape(d, k), 1e-4),
                    ("dbias", db_k, db_p, 1e-4)):
                e, tl, more = err_of(got, want, rel)
                errs[name] = (e, tl)
                extra = {**extra, **{f"{name}_{x}": v
                                     for x, v in more.items()}}
            e_du, t_du = errs.pop("du")
            record(f"glu_dwconv_bwd{dt}", row, e_du, t_du, errs,
                   lambda: glu_dwconv_bwd_cuda(u, w, dy),
                   lambda: torch.autograd.grad(y_plain, leaves, dy,
                                               retain_graph=True),
                   lambda: torch.autograd.grad(y_lib, leaves, dy,
                                               retain_graph=True),
                   b * t * 5 * d * size, 4.0 * b * t * d * k, 10,
                   op_rate="bf16", per_call=2, bit_identical=same, **tag,
                   **{x: v for x, v in extra.items()
                      if x.startswith(("du_", "dw_", "dbias_"))})
            del u, w, bias, dy, y_k, y_p, du_k, dw_k, db_k, again, leaves
            del y_plain, y_lib, du_p, dw_p, db_p
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved_tf32


# The DataConfigs the device_data phase generates on the card, derived
# from `scaled`: a 44.1 kHz front end (20 ms window, 10 ms hop: n_fft 882,
# an odd hop 441) and n_fft 514 (L 257, a prime: Rader over 256).
DATA_VARIANTS = {"scaled": {},
                 "44.1 kHz": dict(sample_rate=44100, n_fft=882,
                                  hop_length=441),
                 "n_fft 514 (Rader)": dict(n_fft=514)}


def _data_config(variant):
    import dataclasses

    from av_separation_torch.config import get_config
    return dataclasses.replace(get_config("scaled").data,
                               **DATA_VARIANTS[variant])


def _stft_rows(record, gen):
    """The STFT magnitude against its plain version.  Device batches of
    generated tones (B 8: [mixed; 2 clean] = 24 signals): scaled (n_fft
    512, and the mixed radix 400 / 160, radix 7 448 / 112, Rader 514 / 128
    (L 257 over 256) and 1154 / 577 (L 577 over 576), odd n_fft under
    Rader 401 / 160, prime radices 286 / 143 (L 143 = 11 13), Bluestein
    402 / 100 (L 201, P 405) and odd 1005 / 250 (P 2016), odd n_fft on
    prime radices 1001 / 250 (7 11 13) and on mixed 441 / 147), the 44.1
    kHz one (882 / 441, L 441 = 3^2 7^2 at an odd hop; prime radices
    1102 / 441, L 551 = 19 29) and demo's (512; Rader 62 / 30); noise
    at an odd shape (3 x 2,001, n_fft 128, hop 64) and beyond grid.y's
    65,535 (70,000 x 1,024, 128 / 64).  Above n_fft 4096,
    one frame a block: 8192 / 1024 and 16384 / 4096 on the scaled batch, 4410 /
    441 on the 44.1 kHz batch (mixed radix, L 2205) and 66,000 signals of
    one 4,098-sample frame (Bluestein at P 4116); the four-step FFT:
    8194 / 2048 (Bluestein, P 16384 = 8 x 2048) and 10125 / 2205 (odd
    n_fft, L = 5 x 2025) on the 44.1 kHz batch, 32768 / 8192 on 8 noise
    signals of 441,000 samples (L 16384 = 8 x 2048).  Float32 sums of
    n_fft windowed samples in another order: max abs error 2e-4 on the
    tone rows of 16 kHz and 8 kHz and the odd shape (peaks ~90-120), 2e-4
    x max(1, peak / 100) on the others, against the plain version.  Above
    n_fft 4096 the plain version's own float32 sums of n_fft products lie
    further than that from float64 (torch.stft in float64), so there the
    kernel is held against float64 at that tolerance and against the
    plain version at that tolerance plus the plain version's measured
    error against float64 (the triangle inequality's bound); each row
    records the kernel's, the plain version's and torch.stft's float32
    errors against float64.  Every row against float64 within
    tests/test_kernels.py's 5e-4 + 1e-4 relative.  Bound:
    the audio read once and the spectra written once, against the least
    work of a real FFT, 2.5 n_fft log2(n_fft) FLOPs a frame.  Library:
    torch.stft with the symmetric Hann window, no centering, on the
    zero-padded signal, then abs (cuFFT; timed only, never called by the
    port)."""
    import torch.nn.functional as F

    from av_separation_torch.config import get_config
    from av_separation_torch.data.device_synthetic import (clean_waveforms,
                                                           draw_variates,
                                                           step_generator)
    from av_separation_torch.ops.kernels.stft import (
        fft_plan, fft_tile_frames, four_step_plan, four_step_sequences,
        route, stft_magnitude_fwd, stft_magnitude_fwd_torch)
    from av_separation_torch.ops.stft import dft_basis

    def tones(cfg):
        v = draw_variates(step_generator(0, 0, "cuda"), cfg, 8)
        clean = clean_waveforms(v, cfg)
        audio = torch.cat([clean.sum(dim=1, keepdim=True), clean], dim=1)
        return audio.reshape(-1, cfg.num_samples_audio).contiguous()

    scaled = tones(_data_config("scaled"))
    k44 = tones(_data_config("44.1 kHz"))
    demo = tones(get_config("demo").data)
    odd = torch.randn(3, 2001, generator=gen).cuda()  # N % 4: 4-byte copies
    many = torch.randn(70000, 1024, generator=gen).cuda()
    # 66,000 signals of one 4,098-sample frame (1.1 GB), drawn on the card.
    frames1 = torch.randn(66000, 4098, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(1))
    # 8 signals of 441,000 samples (10 s at 44.1 kHz).
    long8 = torch.randn(8, 441000, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(2))
    # (label, audio, n_fft, hop, iters, tolerance rule[, frames]): "flat"
    # 2e-4, or "peak", 2e-4 scaled by the peak over 100; frames default to
    # 1 + N // hop.
    cases = [("scaled device batch", scaled, 512, 128, 20, "flat"),
             ("demo device batch", demo, 512, 128, 20, "flat"),
             ("odd", odd, 128, 64, 20, "flat"),
             ("scaled device batch, mixed radix", scaled, 400, 160, 20,
              "flat"),
             ("scaled device batch, radix 7", scaled, 448, 112, 20, "flat"),
             ("44.1 kHz device batch, radix 7, odd hop", k44, 882, 441, 20,
              "peak"),
             ("scaled device batch, odd n_fft, Rader", scaled, 401, 160, 20,
              "peak"),
             ("scaled device batch, Rader", scaled, 514, 128, 20, "peak"),
             ("44.1 kHz device batch, prime radices, odd hop", k44, 1102,
              441, 20, "peak"),
             ("demo device batch, Rader over 30", demo, 62, 30, 20, "peak"),
             ("scaled device batch, prime radices", scaled, 286, 143, 20,
              "peak"),
             ("scaled device batch, Rader over 576", scaled, 1154, 577, 20,
              "peak"),
             ("scaled device batch, Bluestein", scaled, 402, 100, 20,
              "peak"),
             ("scaled device batch, odd n_fft, Bluestein", scaled, 1005, 250,
              20, "peak"),
             ("scaled device batch, odd n_fft, prime radices", scaled, 1001,
              250, 20, "peak"),
             ("scaled device batch, odd n_fft, mixed radix", scaled, 441, 147,
              20, "peak"),
             ("70,000 signals", many, 128, 64, 20, "peak"),
             ("scaled device batch, one frame a block", scaled, 8192, 1024,
              10, "peak"),
             ("44.1 kHz device batch, 100 ms window, mixed radix", k44, 4410,
              441, 10, "peak"),
             ("scaled device batch, L 8192", scaled, 16384, 4096, 10,
              "peak"),
             ("44.1 kHz device batch, four-step Bluestein", k44, 8194, 2048,
              5, "peak"),
             ("44.1 kHz device batch, four-step, odd n_fft", k44, 10125,
              2205, 5, "peak"),
             ("8 x 10 s at 44.1 kHz, four-step", long8, 32768, 8192, 5,
              "peak"),
             # Last: a trace of a 1.1 GB call has left later traces short
             # of events.
             ("66,000 signals of one frame, Bluestein", frames1, 4098,
              4098, 5, "peak", 1)]
    for label, audio, n_fft, hop, iters, rule, *frames in cases:
        b, n = audio.shape
        frames = frames[0] if frames else None
        t = frames or 1 + n // hop
        f = n_fft // 2 + 1
        window = torch.hann_window(n_fft, periodic=False, device="cuda")
        pad = max(0, (t - 1) * hop + n_fft - n)

        def lib(audio=audio, n_fft=n_fft, hop=hop, window=window, pad=pad,
                t=t):
            return torch.stft(F.pad(audio, (0, pad)), n_fft, hop,
                              window=window, center=False,
                              return_complex=True)[..., :t].abs()

        k = stft_magnitude_fwd(audio, n_fft, hop, frames)
        p = stft_magnitude_fwd_torch(audio, n_fft, hop, frames)
        lib_out = lib()
        # float64 through cuFFT: tests/test_kernels.py's tolerance for the
        # Pallas kernel against float64 numpy, 5e-4 + 1e-4 relative.
        ref64 = lib(audio.double(), window=window.double())
        over64 = float(((k.double() - ref64).abs()
                        - 1e-4 * ref64.abs()).max())
        peak = float(ref64.max())
        tol = 2e-4 * (max(1.0, peak / 100.0) if rule == "peak" else 1.0)
        plain_err64 = max_err(p, ref64)
        checks = {"float64 excess over 1e-4 rel": (over64, 5e-4)}
        tol_plain = tol
        if n_fft > 4096:
            checks["float64 max abs"] = (max_err(k, ref64), tol)
            tol_plain = tol + plain_err64
        torch.cuda.synchronize()
        nbytes = 4 * (b * n + b * f * t)
        flops = 2.5 * n_fft * np.log2(n_fft) * t * b
        plan = fft_plan(n_fft)
        if route(n_fft) == "fft":
            name, per_call = "stft_mag_fwd", None
            transform = {"regime": "one block a tile of frames",
                         "kind": plan.kind, "length": plan.length,
                         "radices": list(plan.radices),
                         "bluestein_pad": plan.pad,
                         "frames_a_block": fft_tile_frames(
                             n_fft, hop, b, t,
                             torch.cuda.get_device_properties(0)
                             .multi_processor_count)}
        else:
            name = "stft_mag_4step_fwd"
            fs = four_step_plan(n_fft)
            seqs = b * four_step_sequences(n_fft, t)
            chunks = -(-seqs // min(seqs, fs.sequences))
            # Each chunk: the columns, under Bluestein the middle rows, and
            # the last pass (rows, or under Bluestein the columns).
            passes = (["columns", "rows_middle", "columns_last"] if fs.pad
                      else ["columns", "rows_last"])
            per_call = chunks * len(passes)
            transform = {"regime": "four-step", "length": fs.length,
                         "bluestein_pad": fs.pad,
                         "L1 x L2": f"{fs.n1} x {fs.n2}",
                         "radices": [list(fs.radices1),
                                     list(fs.radices2)],
                         "chunks": chunks,
                         "passes": passes}
        record(name, f"{label} B={b} N={n} n_fft={n_fft} hop={hop} T={t}",
               max_err(k, p), tol_plain, checks,
               lambda: stft_magnitude_fwd(audio, n_fft, hop, frames),
               lambda: stft_magnitude_fwd_torch(audio, n_fft, hop, frames),
               lib, nbytes, flops, iters, op_rate="float32",
               per_call=per_call, peak=peak,
               err_vs_float64=max_err(k, ref64),
               plain_err_vs_float64=plain_err64,
               library_err_vs_float64=max_err(lib_out, ref64),
               tol_rule=("2e-4" if rule == "flat"
                         else "2e-4 x max(1, peak / 100)")
               + (" + the plain version's error against float64"
                  if n_fft > 4096 else ""),
               transform=transform,
               library_max_abs_err=max_err(lib_out, p),
               library="torch.stft(center=False, symmetric Hann).abs()")
        del k, p, lib_out, ref64
        torch.cuda.empty_cache()
    del cases, frames1, many, long8
    dft_basis.cache_clear()     # 4.3 GB of host bases at n_fft 32768
    torch.cuda.empty_cache()


def phase_golden(state):
    from av_separation_torch.config import get_config
    from av_separation_torch.models.model import AVSeparationTransformer
    from av_separation_torch.ops import kernels
    from av_separation_torch.utils.transplant import load_reference_state_dict

    path = ROOT / "tests" / "golden" / "golden_model.npz"
    cfg = get_config("demo").model
    model = AVSeparationTransformer(cfg)
    model.load_state_dict(load_reference_state_dict(str(path)))
    model = model.eval().cuda()
    g = np.load(path)
    mixed = torch.from_numpy(g["mixed"]).cuda()
    frames = torch.from_numpy(g["frames"]).cuda()
    t = mixed.shape[-1]
    kernels.reset_launch_counts()
    with torch.inference_mode():
        separated, masks = model(mixed, frames)
        launches = dict(kernels.LAUNCHES)
        outs = {
            "masks": (masks, 2e-5),
            "separated": (separated, 2e-3),
            "audio_emb": (model.audio_encoder(mixed), 2e-4),
            "visual_emb": (model.visual_encoder(frames, t), 2e-4),
            "fused": (model.fusion(torch.from_numpy(g["audio_emb"]).cuda(),
                                   torch.from_numpy(g["visual_emb"]).cuda()),
                      2e-4),
        }
    errs, bad = {}, []
    for name, (out, atol) in outs.items():
        got = out.cpu().numpy()
        errs[name] = {"max_abs_err": float(np.abs(got - g[name]).max()),
                      "atol": atol, "rtol": 1e-4}
        if not within(got, g[name], atol, 1e-4):
            bad.append(name)
    want = want_launches({"flash_attn_fwd": 2 * cfg.num_encoder_layers
                          + cfg.num_fusion_layers, "audio_proj_fwd": 1,
                          "mask_decoder_fwd": 1})
    if launches != want:
        bad.append(f"launches {launches} != {want}")
    if bad:
        raise AssertionError(f"golden mismatch: {bad} {errs}")
    return {"errors": errs, "launches_per_forward": launches}


def phase_configs(state):
    """The reference's default model (ModelConfig(): d 256, 4 heads, dh
    64), the named configs three_speaker (S 3), lrs2 (96x96 lips, T 376)
    and multihost (d 1024, 8 heads, S 4, 12 + 8 layers), and odd_width
    (ModelConfig() at d 196, 4 heads: dh 49 and widths the kernels run
    zero-padded), wide_head (d 512, 2 heads: dh 256, the pair kernels)
    and wide_d1024 (d 1024, 2 heads: dh 512, a cluster of 4), at full
    width and
    depth with seeded weights: one eval
    forward at batch 2 on the card
    against the same model and batch on the CPU (masks 1e-4, separated
    1e-4 x the peak of the mixture, as `serve` holds the masks), with the
    launches of that forward counted from 0; then one train step of the
    default model, wide_head and wide_d1024 at dropout 0 and batch 2
    against float64 on the CPU, as `train` holds the scaled step, with its
    launches counted from 0."""
    import dataclasses

    from av_separation_torch.config import ExperimentConfig, get_config
    from av_separation_torch.data.loader import batch_iterator
    from av_separation_torch.data.synthetic import SyntheticAVDataset
    from av_separation_torch.models.model import build_model
    from av_separation_torch.ops import kernels

    def batch_of(cfg, n=2):
        data = dataclasses.replace(cfg.data, num_samples=n)
        return next(batch_iterator(SyntheticAVDataset(data), n, seed=0))

    out, bad = {}, []
    total = {name: 0 for name in kernels.LAUNCHES}
    default = ExperimentConfig()
    odd = dataclasses.replace(default, model=dataclasses.replace(
        default.model, d_model=196, nhead=4))  # dh 49, padded to 64
    wide = dataclasses.replace(default, model=dataclasses.replace(
        default.model, d_model=512, nhead=2))  # dh 256: the pair kernels
    # dh 512: q k^T summed over 128-column chunks, a cluster of 4 blocks
    wide512 = dataclasses.replace(default, model=dataclasses.replace(
        default.model, d_model=1024, nhead=2))
    cases = [("default", default)] + [
        (name, get_config(name))
        for name in ("three_speaker", "lrs2", "multihost")] + [
        ("odd_width", odd), ("wide_head", wide), ("wide_d1024", wide512)]
    for label, cfg in cases:
        m = cfg.model
        batch = batch_of(cfg)
        mixed, frames = (torch.as_tensor(batch[k])
                         for k in ("mixed_spec", "lip_frames"))
        ref = build_model(m, device="cpu", seed=0)
        card = build_model(m, device="cuda", seed=0)
        with torch.inference_mode():
            sep_r, mask_r = ref(mixed, frames)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            sep_c, mask_c = card(mixed.cuda(), frames.cuda())
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        del card
        for name, n in launches.items():
            total[name] += n
        want = want_launches(dict(
            flash_attn_fwd=2 * m.num_encoder_layers + m.num_fusion_layers,
            audio_proj_fwd=1, mask_decoder_fwd=1))
        mask_err = max_err(mask_c.cpu(), mask_r)
        sep_err = max_err(sep_c.cpu(), sep_r)
        peak = float(mixed.abs().max())
        row = {"d_model": m.d_model, "nhead": m.nhead,
               "dh": m.d_model // m.nhead,
               "layers": [m.num_encoder_layers, m.num_fusion_layers],
               "speakers": m.num_speakers,
               "mixed": list(mixed.shape), "lips": list(frames.shape),
               "mask_max_abs_err": [mask_err, 1e-4],
               "separated_max_abs_err": [sep_err, 1e-4 * peak],
               "launches": launches}
        if tuple(mask_c.shape) != tuple(mask_r.shape) \
                or not bool(torch.isfinite(mask_c).all()):
            bad.append(f"{label}: masks {tuple(mask_c.shape)} not finite "
                       f"or not {tuple(mask_r.shape)}")
        if mask_err > 1e-4 or sep_err > 1e-4 * peak:
            bad.append(f"{label}: vs CPU {row}")
        if launches != want:
            bad.append(f"{label}: launches {launches} != {want}")
        out[label] = row

    # One train step of the default model (dh 64: the flash backward at
    # dh 64, and the decoder's kernel, which runs in training at dropout 0),
    # of wide_head (dh 256) and of wide_d1024 (dh 512), each against
    # float64 on the CPU.
    checks = {}
    for label, base in (("default", default), ("wide_head", wide),
                        ("wide_d1024", wide512)):
        cfg0 = dataclasses.replace(
            base, model=dataclasses.replace(base.model, dropout=0.0),
            train=dataclasses.replace(base.train, batch_size=2))
        check = _train_cpu_check(bad, cfg0, batch_of(cfg0))
        m = cfg0.model
        per_step = 2 * m.num_encoder_layers + m.num_fusion_layers
        want = want_launches(dict(
            flash_attn_fwd=per_step, flash_attn_bwd=per_step,
            audio_proj_fwd=1, mask_decoder_fwd=1))
        if check["card_launches"] != want:
            bad.append(f"{label} train step: launches "
                       f"{check['card_launches']} != {want}")
        for name, n in check["card_launches"].items():
            total[name] += n
        checks[label] = check
    steps = _config_train_steps(bad, total)
    state["launches"]["configs"] = total
    if bad:
        raise AssertionError("; ".join(bad))
    return {"card": state["card"], "forwards_batch2": out,
            "default_train_step_dropout0_batch2": checks["default"],
            "wide_head_train_step_dropout0_batch2": checks["wide_head"],
            "wide_d1024_train_step_dropout0_batch2": checks["wide_d1024"],
            "train_steps": steps}


def _config_train_steps(bad: list, total: dict) -> dict:
    """One train step each of three_speaker, lrs2 and multihost on the
    card, at full width and depth, their own batch (8, 8, 16) and dropout
    0.1, on their synthetic data: loss and grad norm finite, launches per
    step (each flash forward twice under remat: once more in the
    backward's recompute).  multihost (remat in its config, as in JAX) is
    also run without remat from the same weights, generators and batch:
    loss and grad norm within 1e-6 relative (the recompute replays the
    dropout draws; the kernels have no atomics), with the peak device
    memory of each (max_memory_allocated over the step, the weights and
    the Adam state included)."""
    import dataclasses

    from av_separation_torch.config import get_config
    from av_separation_torch.data.loader import batch_iterator
    from av_separation_torch.data.synthetic import SyntheticAVDataset
    from av_separation_torch.ops import kernels
    from av_separation_torch.train import create_train_state, make_train_step

    out = {}
    for name in ("three_speaker", "lrs2", "multihost"):
        cfg = get_config(name)
        n = cfg.train.batch_size
        data = dataclasses.replace(cfg.data, num_samples=n)
        batch = next(batch_iterator(SyntheticAVDataset(data), n, seed=0))
        runs = [(name, cfg)]
        if name == "multihost":
            runs.append(("multihost_no_remat", dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, remat=False))))
        for label, c in runs:
            m = c.model
            ts = create_train_state(c, device="cuda")
            step = make_train_step(c)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            ts, met = step(ts, batch)
            loss, norm = float(met["loss"]), float(met["grad_norm"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = dict(kernels.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 1e9
            del ts, step, met
            torch.cuda.empty_cache()
            for k_, v_ in launches.items():
                total[k_] += v_
            per_step = 2 * m.num_encoder_layers + m.num_fusion_layers
            want = want_launches(dict(
                flash_attn_fwd=per_step * (2 if m.remat else 1),
                flash_attn_bwd=per_step, audio_proj_fwd=1)
                | dropout_launches(m))
            out[label] = {"batch": n, "remat": m.remat,
                          "dropout": m.dropout, "loss": loss,
                          "grad_norm": norm, "ms": ms,
                          "peak_mem_gb": peak, "launches": launches}
            if not (np.isfinite(loss) and np.isfinite(norm)):
                bad.append(f"{label} step: loss {loss}, grad norm {norm}")
            if launches != want:
                bad.append(f"{label} step: launches {launches} != {want}")
    r, p = out["multihost"], out["multihost_no_remat"]
    for key in ("loss", "grad_norm"):
        rel = abs(r[key] - p[key]) / abs(p[key])
        out[f"remat_vs_plain_{key}_rel"] = [rel, 1e-6]
        if rel > 1e-6:
            bad.append(f"multihost remat {key} {r[key]} vs {p[key]}")
    return out


def phase_serve(state):
    from av_separation_torch.config import get_config
    from av_separation_torch.data.synthetic import SyntheticAVDataset
    from av_separation_torch.inference import Separator
    from av_separation_torch.models.model import build_model
    from av_separation_torch.ops import kernels
    from av_separation_torch.serving import BatchingSeparatorServer

    cfg = get_config("scaled")
    state_dict = build_model(cfg.model, device="cpu", seed=0).state_dict()
    ds = SyntheticAVDataset(cfg.data)
    n_req, n_threads = 16, 4
    mixes, lips = [], []
    for i in range(n_req):
        audios, rng = ds.clean_audios(i)
        mixes.append(audios.sum(axis=0).astype(np.float32))
        lips.append(ds.lip_stream(audios, rng))

    sep = Separator(cfg.model, state_dict, cfg.data, device="cuda")
    server = BatchingSeparatorServer(sep, max_batch=8)
    try:
        server.warmup(batch_sizes=(1, 2, 4, 8), wave=True)
        torch.cuda.synchronize()
        results = [None] * n_req
        errors = []

        def client(tid):
            try:
                mine = list(range(tid, n_req, n_threads))
                handles = [(i, server.submit_waveform(mixes[i], lips[i]))
                           for i in mine]
                for i, handle in handles:
                    results[i] = handle.result(timeout=300)
            except Exception:  # noqa: BLE001 — reported by the phase
                errors.append(traceback.format_exc())

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        stats = server.stats.snapshot()
        latencies = sorted(server.stats.latency_ms)
    finally:
        server.close()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"client failures: {errors}")
    state["launches"]["serve"] = launches
    state["serve_batch"] = (sep, np.stack(mixes[:8]), np.stack(lips[:8]))

    s, n_audio = cfg.model.num_speakers, cfg.data.num_samples_audio
    bad = []
    for i, (waves, masks) in enumerate(results):
        if waves.shape != (s, n_audio) or not np.isfinite(waves).all():
            bad.append(f"request {i}: waveforms {waves.shape}")
        if not (np.isfinite(masks).all() and masks.min() >= 0.0
                and masks.max() <= 1.0):
            bad.append(f"request {i}: masks outside [0, 1]")
    batches = stats["batches"]
    want = want_launches({"flash_attn_fwd": 16 * batches,
                          "audio_proj_fwd": batches,
                          "mask_decoder_fwd": batches})
    per_forward = 2 * cfg.model.num_encoder_layers \
        + cfg.model.num_fusion_layers
    if per_forward != 16 or launches != want:
        bad.append(f"launches {launches} != {want} over {batches} forwards")
    if stats["max_batch"] <= 1:
        bad.append("the server never coalesced requests")

    # One full batch of the same requests through the same model on the CPU.
    n_ref = server.max_batch
    cpu = Separator(cfg.model, state_dict, cfg.data, device="cpu")
    ref = cpu.separate_waveform(np.stack(mixes[:n_ref]),
                                np.stack(lips[:n_ref]))
    got_w = np.stack([results[i][0] for i in range(n_ref)])
    got_m = np.stack([results[i][1] for i in range(n_ref)])
    mask_err = float(np.abs(got_m - ref["masks"]).max())
    peak = float(np.abs(ref["waveforms"]).max())
    wave_err = float(np.abs(got_w - ref["waveforms"]).max())
    if mask_err > 1e-4:
        bad.append(f"masks vs CPU {mask_err} > 1e-4")
    if wave_err > 1e-3 * peak:
        bad.append(f"waveforms vs CPU {wave_err} > 1e-3 * {peak}")
    if bad:
        raise AssertionError("; ".join(bad))
    audio_s = n_req * cfg.data.duration
    return {"config": "scaled", "card": state["card"], "requests": n_req,
            "client_threads": n_threads, "batches": batches,
            "max_batch": stats["max_batch"],
            "mean_batch": stats["mean_batch"], "launches": launches,
            "latency_ms_p50": stats["latency_ms_p50"],
            "latency_ms_p95": stats["latency_ms_p95"],
            "latency_ms_all": [round(x, 2) for x in latencies],
            "wall_s": wall, "audio_s_per_s": audio_s / wall,
            "cpu_check": {"requests": n_ref, "mask_max_abs_err": mask_err,
                          "wave_max_abs_err": wave_err, "wave_peak": peak}}


def phase_profile(state):
    """Where the time of one served batch goes: a batch of 8 waveform
    requests through the serve phase's Separator, timed (host clock around
    synchronised calls) and then traced with torch.profiler; device time is
    summed per kernel name from the CUDA kernel events."""
    from torch.profiler import ProfilerActivity, profile

    sep, audio, frames = state["serve_batch"]
    iters = 5
    sep.separate_waveform(audio, frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        sep.separate_waveform(audio, frames)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) / iters * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            sep.separate_waveform(audio, frames)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / iters * 1e3
    return {"config": "scaled", "batch": int(audio.shape[0]),
            "card": state["card"], "batch_ms": batch_ms,
            "traced_batch_ms": traced_ms,
            **device_split(prof, iters, "batch")}


def _long_requests(cfg, rows: int, segments: int):
    """`rows` mixtures of `segments` consecutive synthetic utterances each
    (the dataset's samples in order), with their lip streams in the
    dataset's layout: (rows, segments x N) audio and (rows, S x segments x
    N_f, H, W) frames."""
    from av_separation_torch.data.synthetic import SyntheticAVDataset

    ds = SyntheticAVDataset(cfg.data)
    d, s = cfg.data, cfg.model.num_speakers
    audio, lips = [], []
    for row in range(rows):
        parts, per = [], []
        for j in range(segments):
            clean, rng = ds.clean_audios(row * segments + j)
            parts.append(clean.sum(axis=0))
            per.append(ds.lip_stream(clean, rng).reshape(
                s, d.num_frames, d.frame_h, d.frame_w))
        audio.append(np.concatenate(parts))
        lips.append(np.concatenate(per, axis=1).reshape(
            -1, d.frame_h, d.frame_w))
    return np.stack(audio).astype(np.float32), np.stack(lips)


def phase_stream(state):
    """Streaming separation of 60 s mixtures at the scaled config's full
    width and depth (see the module docstring)."""
    from av_separation_torch.config import get_config
    from av_separation_torch.inference import Separator
    from av_separation_torch.models.model import build_model
    from av_separation_torch.ops import kernels

    cfg = get_config("scaled")
    m, d = cfg.model, cfg.data
    if (m.d_model, m.nhead, m.num_encoder_layers, m.num_fusion_layers) \
            != (512, 4, 6, 4):
        raise AssertionError(f"not the scaled config: {m}")
    weights = build_model(m, device="cpu", seed=0).state_dict()
    sep = Separator(m, weights, d, device="cuda")
    audio, lips = _long_requests(cfg, 2, 15)          # 2 x 60 s
    b, n = audio.shape
    spf = d.num_samples_audio // d.num_frames
    chunk, overlap = 4 * d.sample_rate, d.sample_rate  # 4 s, 1 s
    stride = chunk - overlap
    bad = []

    # A 10 s cut (3 chunks) on the card and on the CPU; the card's run
    # also warms the chunk shape up.
    short = int(10 * d.sample_rate)
    short_lips = lips.reshape(b, 2, -1, d.frame_h, d.frame_w)[
        :, :, :short // spf].reshape(b, -1, d.frame_h, d.frame_w)
    got10 = sep.separate_waveform_streaming(audio[:, :short], short_lips,
                                            4.0, 1.0)
    cpu = Separator(m, weights, d, device="cpu")
    ref10 = cpu.separate_waveform_streaming(audio[:, :short], short_lips,
                                            4.0, 1.0)
    first = (audio[:, :chunk], short_lips.reshape(
        b, 2, -1, d.frame_h, d.frame_w)[:, :, :chunk // spf].reshape(
        b, -1, d.frame_h, d.frame_w))
    mask_err = float(np.abs(sep.separate_waveform(*first)["masks"]
                            - cpu.separate_waveform(*first)["masks"]).max())
    peak10 = float(np.abs(ref10["waveforms"]).max())
    wave_err10 = float(np.abs(got10["waveforms"]
                              - ref10["waveforms"]).max())
    if int(got10["num_chunks"]) != 3 or int(ref10["num_chunks"]) != 3:
        bad.append(f"10 s: {got10['num_chunks']} chunks on the card, "
                   f"{ref10['num_chunks']} on the CPU, not 3")
    if mask_err > 1e-4 or wave_err10 > 1e-3 * peak10:
        bad.append(f"10 s vs CPU: masks {mask_err} (1e-4), waves "
                   f"{wave_err10} (1e-3 x {peak10})")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = sep.separate_waveform_streaming(audio, lips, 4.0, 1.0)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    state["launches"]["stream"] = launches
    waves, n_chunks = out["waveforms"], int(out["num_chunks"])
    if waves.shape != (b, m.num_speakers, n) or n_chunks != 20 \
            or not np.isfinite(waves).all():
        bad.append(f"output {waves.shape}, {n_chunks} chunks, finite "
                   f"{bool(np.isfinite(waves).all())}")
    want = want_launches(dict(flash_attn_fwd=16 * n_chunks,
                              audio_proj_fwd=n_chunks,
                              mask_decoder_fwd=n_chunks))
    if launches != want:
        bad.append(f"launches {launches} != {want}")

    # The same chunks one by one through separate_waveform on the card,
    # overlap-added in numpy under the same cross-fade.
    padded_n = (n_chunks - 1) * stride + chunk
    audio_p = np.pad(audio, ((0, 0), (0, padded_n - n)))
    lips_p = lips.reshape(b, 2, -1, d.frame_h, d.frame_w)
    lips_p = np.pad(lips_p, ((0, 0), (0, 0),
                             (0, padded_n // spf - lips_p.shape[2]),
                             (0, 0), (0, 0)))
    win = np.ones(chunk, np.float32)
    ramp = (np.arange(overlap, dtype=np.float32) + 1.0) / (overlap + 1)
    win[:overlap], win[-overlap:] = ramp, ramp[::-1]
    stitched = np.zeros((b, m.num_speakers, padded_n), np.float32)
    wsum = np.zeros(padded_n, np.float32)
    single = 0.0
    for k in range(n_chunks):
        a0 = k * stride
        alone = sep.separate_waveform(
            audio_p[:, a0:a0 + chunk],
            lips_p[:, :, a0 // spf:(a0 + chunk) // spf].reshape(
                b, -1, d.frame_h, d.frame_w))["waveforms"]
        stitched[:, :, a0:a0 + chunk] += alone * win
        wsum[a0:a0 + chunk] += win
        hi = min(chunk - overlap, n - a0)
        single = max(single, float(np.abs(
            waves[..., a0 + overlap:a0 + hi] - alone[..., overlap:hi]).max()))
    stitched = (stitched / np.maximum(wsum, 1e-8))[:, :, :n]
    peak = float(np.abs(stitched).max())
    stitch_err = float(np.abs(waves - stitched).max())
    if stitch_err > 1e-6 * peak or single > 1e-6 * peak:
        bad.append(f"stitching {stitch_err}, single-chunk regions {single} "
                   f"(1e-6 x {peak})")
    if bad:
        raise AssertionError("; ".join(bad))
    rate = {"stream_rate": {"card": state["card"], "wall_s": wall,
                            "audio_s_per_s": b * n / d.sample_rate / wall,
                            "chunks_per_s": n_chunks / wall}}
    emit(rate)
    return {"config": "scaled", "card": state["card"], "batch": b,
            "seconds_each": n / d.sample_rate, "chunk_s": 4.0,
            "overlap_s": 1.0, "num_chunks": n_chunks, "launches": launches,
            **rate["stream_rate"],
            "stitch_max_abs_err": [stitch_err, 1e-6 * peak],
            "single_chunk_max_abs_err": [single, 1e-6 * peak],
            "cpu_check_10s": {"num_chunks": int(got10["num_chunks"]),
                              "first_chunk_mask_max_abs_err":
                                  [mask_err, 1e-4],
                              "wave_max_abs_err": [wave_err10,
                                                   1e-3 * peak10]}}


def _http(port, method, path, body=None, headers=None, timeout=120.0):
    """One request to 127.0.0.1 -> (status, body bytes)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _raw_status(port, head: bytes, body: bytes = b"") -> str:
    """Bytes over a plain socket -> the status code of the reply."""
    import socket
    with socket.create_connection(("127.0.0.1", port), timeout=30) as sk:
        sk.sendall(head + body)
        return sk.makefile("rb").readline().decode().split()[1]


def _npz(**arrays) -> bytes:
    import io
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def phase_serve_http(state):
    """`cli serve` as a process on the card, driven over HTTP (see the
    module docstring)."""
    import io
    import os
    import signal
    import socket

    from av_separation_torch.config import get_config
    from av_separation_torch.data.synthetic import SyntheticAVDataset
    from av_separation_torch.inference import Separator
    from av_separation_torch.models.model import build_model

    cfg = get_config("scaled")
    token = "chip-smoke-token"
    auth = {"Authorization": f"Bearer {token}"}
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "av_separation_torch.cli", "serve",
         "--config", "scaled", "--serve-host", "127.0.0.1", "--serve-port",
         str(port), "--serve-max-batch", "8", "--serve-warmup", "1,2,4,8",
         "--serve-auth-token", token],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"cli serve exited {proc.returncode} "
                                     f"before /healthz")
            try:
                if _http(port, "GET", "/healthz", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > 180:
                raise AssertionError("no /healthz within 180 s")
            time.sleep(0.25)
        startup_s = time.perf_counter() - t0

        ds = SyntheticAVDataset(cfg.data)
        waves_in = []
        for i in range(16):
            clean, rng = ds.clean_audios(i)
            waves_in.append((clean.sum(axis=0).astype(np.float32),
                             ds.lip_stream(clean, rng)))
        specs_in = [(ds[i]["mixed_spec"], ds[i]["lip_frames"])
                    for i in range(16, 20)]
        results, lat, errors = {}, {}, []

        def client(tid):
            try:
                jobs = [("wave", i) for i in range(tid, 16, 4)] \
                    + [("spec", tid)]
                for kind, i in jobs:
                    if kind == "wave":
                        path = "/separate_waveform"
                        body = _npz(mixed_audio=waves_in[i][0],
                                    lip_frames=waves_in[i][1])
                    else:
                        path = "/separate"
                        body = _npz(mixed_spec=specs_in[i][0],
                                    lip_frames=specs_in[i][1])
                    t1 = time.perf_counter()
                    status, reply = _http(port, "POST", path, body, auth)
                    lat[(kind, i)] = (time.perf_counter() - t1) * 1e3
                    results[(kind, i)] = (status, reply)
            except Exception:  # noqa: BLE001 — reported by the phase
                errors.append(traceback.format_exc())

        t1 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t1
        bad = [f"client: {e}" for e in errors]
        codes = {f"{k} {i}": st for (k, i), (st, _) in results.items()}
        if len(codes) != 20 or any(c != 200 for c in codes.values()):
            bad.append(f"statuses {codes}")
        status, body = _http(port, "GET", "/stats", headers=auth)
        stats = json.loads(body) if status == 200 else {}
        if stats.get("max_batch", 0) <= 1:
            bad.append(f"/stats {status} {stats}: no coalescing")
        refusals = {
            "401 without token": _http(port, "GET", "/stats")[0],
            "413 over the cap": int(_raw_status(
                port, ("POST /separate_waveform HTTP/1.1\r\nHost: x\r\n"
                       f"Authorization: Bearer {token}\r\nContent-Length: "
                       f"{(64 << 20) + 1}\r\n\r\n").encode(),
                b"x" * (1 << 20))),
            "400 on Content-Length -1": int(_raw_status(
                port, ("POST /separate HTTP/1.1\r\nHost: x\r\n"
                       f"Authorization: Bearer {token}\r\n"
                       "Content-Length: -1\r\n\r\n").encode()))}
        if [refusals[k] for k in refusals] != [401, 413, 400]:
            bad.append(f"refusals {refusals}")

        t2 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=30)
        shutdown_s = time.perf_counter() - t2
    finally:
        if proc.poll() is None:  # not stopped by SIGINT: returncode -9
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        bad.append(f"cli serve exit {proc.returncode}")
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    launches = next((ln["kernel_launches"] for ln in lines
                     if "kernel_launches" in ln), None)
    state["launches"]["serve_http"] = launches or {}
    warm = next((ln for ln in out.splitlines()
                 if ln.startswith("avsep warmup:")), "")
    # Every forward of the process (warm-up batches and served ones)
    # launches 16 attention, 1 projection and 1 decoder kernel.
    forwards = stats.get("batches", 0) + int(warm.split()[2] or 0) \
        if warm else None
    want = want_launches({"flash_attn_fwd": 16 * forwards,
                          "audio_proj_fwd": forwards,
                          "mask_decoder_fwd": forwards}) \
        if forwards else None
    if launches is None or launches != want:
        bad.append(f"server launches {launches} != {want}")

    # Eight responses against a CPU Separator on cli serve's weights.
    state_dict = build_model(cfg.model, device="cpu",
                             seed=cfg.train.seed).state_dict()
    cpu = Separator(cfg.model, state_dict, cfg.data, device="cpu")
    ref = cpu.separate_waveform(np.stack([w for w, _ in waves_in[:8]]),
                                np.stack([lp for _, lp in waves_in[:8]]))
    got_w, got_m = [], []
    for i in range(8):
        reply = results.get(("wave", i), (0, b""))[1]
        if not reply.startswith(b"PK"):
            bad.append(f"response {i} is no npz")
            break
        with np.load(io.BytesIO(reply)) as z:
            got_w.append(z["waveforms"])
            got_m.append(z["masks"])
    mask_err = wave_err = peak = None
    if len(got_w) == 8:
        mask_err = float(np.abs(np.stack(got_m) - ref["masks"]).max())
        peak = float(np.abs(ref["waveforms"]).max())
        wave_err = float(np.abs(np.stack(got_w) - ref["waveforms"]).max())
        if mask_err > 1e-4 or wave_err > 1e-3 * peak:
            bad.append(f"vs CPU: masks {mask_err}, waves {wave_err} "
                       f"(1e-3 x {peak})")
    if bad:
        raise AssertionError("; ".join(bad))
    wave_lat = sorted(lat[("wave", i)] for i in range(16))
    return {"config": "scaled", "card": state["card"], "requests": 20,
            "client_threads": 4, "startup_s": startup_s,
            "shutdown_s": shutdown_s, "warmup": warm,
            "over_the_wire_audio_s_per_s": 20 * cfg.data.duration / wall,
            "wall_s": wall,
            "wave_latency_ms_p50": float(np.percentile(wave_lat, 50)),
            "wave_latency_ms_p95": float(np.percentile(wave_lat, 95)),
            "server_stats": stats, "refusals": refusals,
            "launches": launches,
            "cpu_check": {"requests": 8, "mask_max_abs_err": mask_err,
                          "wave_max_abs_err": wave_err, "wave_peak": peak}}


def _group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_attn_fwd (ours)"
    if "flash_bwd" in low:
        return "flash_attn_bwd (ours)"
    if "audio_proj" in low:
        return "audio_proj_fwd (ours)"
    if "mask_decoder" in low:
        return "mask_decoder_fwd (ours)"
    if "stft_fft" in low:
        return "stft_mag_fwd (ours)"
    if "stft_4step" in low:
        return "stft_mag_4step_fwd (ours)"
    if "memcpy" in low or "memset" in low:
        return "memcpy / memset"
    if "fprop" in low or "grad" in low or "conv" in low or "cudnn" in low:
        return "conv stem (cuDNN)"
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "matmul (cuBLAS)"
    if "norm" in low:
        return "layer norm"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer (foreach Adam)"
    return "other (elementwise, reductions, index_add)"


def device_split(prof, iters: int, unit: str) -> dict:
    """Device time per `unit` from a torch.profiler trace: summed per kernel
    name and per group (overlapping kernels each count in full)."""
    from torch.autograd import DeviceType

    by_name, launches = {}, 0
    for e in prof.events():
        # Kernels and copies only: a user annotation (such as
        # Optimizer.step) spans kernels that are already counted.
        if e.device_type == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            us = e.time_range.end - e.time_range.start
            by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / iters
            launches += 1
    if not by_name:
        return {f"device_ms_per_{unit}": "not measured"}
    device_ms = sum(by_name.values())
    groups = {}
    for name, ms in by_name.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    # Host side: the operators with the most self CPU time.
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / iters)
                   for e in prof.key_averages()),
                  key=lambda kv: -kv[1])[:8]
    return {f"device_ms_per_{unit}": device_ms,
            f"kernels_per_{unit}": launches / iters,
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": [[name[:90], ms] for name, ms in top],
            "host_self_cpu_ms": [[name[:60], ms] for name, ms in host]}


def _traced(fn, iters: int, unit: str) -> dict:
    """`device_split` of `iters` calls of fn() (after one untraced), with
    the flash kernels' share of the device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / iters
    split = device_split(prof, iters, unit)
    dev, groups = split[f"device_ms_per_{unit}"], split.get("groups_ms", {})
    flash = sum(ms for g, ms in groups.items() if g.startswith("flash_attn"))
    split["flash_ms"] = flash
    split["flash_share"] = flash / dev if isinstance(dev, float) \
        else "not measured"
    split["host_ms"] = traced_ms
    return split


def _scaled_train_setup(dropout: float, n_samples: int, batch: int):
    """The scaled config at `dropout` and its first `batch_iterator` batches
    over a cut of the synthetic dataset (`n_samples` of its 1000; widths,
    depths and the data geometry are the config's)."""
    import dataclasses

    from av_separation_torch.config import get_config
    from av_separation_torch.data.loader import batch_iterator
    from av_separation_torch.data.synthetic import SyntheticAVDataset

    cfg = get_config("scaled")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=dropout),
        data=dataclasses.replace(cfg.data, num_samples=n_samples),
        train=dataclasses.replace(cfg.train, batch_size=batch))
    return cfg, batch_iterator(SyntheticAVDataset(cfg.data), batch, seed=0)


def phase_train(state):
    from av_separation_torch.ops import kernels
    from av_separation_torch.train import create_train_state, make_train_step

    cfg, batches = _scaled_train_setup(0.1, 24, 8)
    m = cfg.model
    if (m.d_model, m.nhead, m.num_encoder_layers, m.num_fusion_layers) \
            != (512, 4, 6, 4):
        raise AssertionError(f"not the scaled config: {m}")
    ts = create_train_state(cfg, device="cuda")
    step = make_train_step(cfg)
    per_step = 2 * m.num_encoder_layers + m.num_fusion_layers
    want = want_launches({"flash_attn_fwd": per_step,
                          "flash_attn_bwd": per_step, "audio_proj_fwd": 1}
                         | dropout_launches(m))
    n_steps, rows, bad = 6, [], []
    total = {name: 0 for name in kernels.LAUNCHES}
    for i in range(n_steps):
        batch = next(batches)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ts, metrics = step(ts, batch)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.LAUNCHES)
        for name, n in launches.items():
            total[name] += n
        rows.append({"step": i, "loss": loss, "grad_norm": norm, "ms": ms,
                     "launches": launches})
        if not (np.isfinite(loss) and np.isfinite(norm)):
            bad.append(f"step {i}: loss {loss}, grad norm {norm}")
        if launches != want:
            bad.append(f"step {i}: launches {launches} != {want}")
    state["launches"]["train"] = total
    state["train"] = (cfg, ts, step, batch)
    # Step 0 pays cuBLAS / cuDNN set-up; the rate is over the others.
    step_ms = float(np.mean([r["ms"] for r in rows[1:]]))
    audio_s = cfg.train.batch_size * cfg.data.duration

    cfg0, batches0 = _scaled_train_setup(0.0, 8, 2)
    check = _train_cpu_check(bad, cfg0, next(batches0))
    if bad:
        raise AssertionError("; ".join(bad))
    return {"config": "scaled", "card": state["card"],
            "batch": cfg.train.batch_size, "dropout": m.dropout,
            "steps": rows, "ms_per_step": step_ms,
            "audio_s_per_s": audio_s / step_ms * 1e3,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "cpu_check_dropout0_batch2": check}


def _train_cpu_check(bad: list, cfg0, batch0) -> dict:
    """One step of `cfg0` (dropout 0) on `batch0` through make_train_step
    on the card, against the same weights and batch on the CPU in float64
    (forward, loss, backward, the same clip); the card step's launches are
    counted from 0.

    Float64 is the reference because the CPU's own float32 run can be the
    noisier side (its float32 loss reductions over 257k elements); its
    errors against float64 are reported beside the card's.  Tolerances:
    the loss (SI-SNR in dB plus L1) to 1e-3, the global norm to 1e-4
    relative, every clipped gradient element to 1e-3 of the largest."""
    from av_separation_torch.losses import separation_loss
    from av_separation_torch.ops import kernels
    from av_separation_torch.train import create_train_state, make_train_step

    ref = create_train_state(cfg0, device="cpu").model.double()
    mixed, frames, clean = (torch.as_tensor(batch0[k], dtype=torch.float64)
                            for k in ("mixed_spec", "lip_frames",
                                      "clean_specs"))
    lc = cfg0.loss
    loss_ref = separation_loss(ref(mixed, frames)[0], clean, lc.l1_weight,
                               lc.pit_mode, lc.eps)
    loss_ref.backward()
    g_ref = {n: p.grad for n, p in ref.named_parameters()}
    n_ref = float(torch.sqrt(sum(g.square().sum() for g in g_ref.values())))
    clip = min(1.0, cfg0.train.grad_clip_norm / n_ref)

    g_max = max(float(g.abs().max()) for g in g_ref.values()) * clip
    runs = {}
    for device in ("cuda", "cpu"):
        s0 = create_train_state(cfg0, device=device)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        s0, met = make_train_step(cfg0)(s0, batch0)
        torch.cuda.synchronize()
        if device == "cuda":
            launches = dict(kernels.LAUNCHES)
        runs[device] = (float(met["loss"]), float(met["grad_norm"]), max(
            float((p.grad.double().cpu() - g_ref[n] * clip).abs().max())
            for n, p in s0.model.named_parameters()))
    (l_g, n_g, g_err), (l_c, n_c, g_err_c) = runs["cuda"], runs["cpu"]
    l_r = float(loss_ref.detach())
    if abs(l_g - l_r) > 1e-3:
        bad.append(f"loss card {l_g} vs CPU float64 {l_r}")
    if abs(n_g - n_ref) > 1e-4 * n_ref:
        bad.append(f"grad norm card {n_g} vs CPU float64 {n_ref}")
    if g_err > 1e-3 * g_max:
        bad.append(f"gradients card vs CPU float64 {g_err} > 1e-3 * {g_max}")
    return {"reference": "CPU float64", "loss": [l_g, l_r, 1e-3],
            "grad_norm": [n_g, n_ref, 1e-4 * n_ref],
            "max_grad_err": [g_err, g_max, 1e-3 * g_max],
            "cpu_float32": {"loss": l_c, "grad_norm": n_c,
                            "max_grad_err": g_err_c},
            "card_launches": launches}


def phase_train_profile(state):
    """Where the time of one scaled train step goes: host-clock step time,
    then a torch.profiler trace of two steps summed per kernel and group."""
    from torch.profiler import ProfilerActivity, profile

    cfg, ts, step, batch = state["train"]
    iters = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            ts, metrics = step(ts, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / iters * 1e3
    return {"config": "scaled", "batch": cfg.train.batch_size,
            "card": state["card"], "traced_step_ms": traced_ms,
            **device_split(prof, iters, "step")}


def phase_device_data(state):
    """Batches generated on the card at each of DATA_VARIANTS: launches,
    contract, the CPU check on the same variates, and ms per batch; for
    the scaled config beside the host pipeline's."""
    import dataclasses

    from av_separation_torch.data.device_synthetic import (draw_variates,
                                                           generate_batch,
                                                           step_generator,
                                                           synthesize)
    from av_separation_torch.data.loader import batch_iterator
    from av_separation_torch.data.synthetic import SyntheticAVDataset
    from av_separation_torch.ops import kernels

    bs, bad = 8, []
    out = {"card": state["card"], "batch": bs}
    for variant in DATA_VARIANTS:
        cfg = _data_config(variant)
        key = "device_data" if variant == "scaled" else \
            f"device_data {variant}"
        s, f, t = cfg.num_speakers, cfg.freq_bins, cfg.num_stft_frames
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        batch = generate_batch(step_generator(0, 0, "cuda"), cfg, bs)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        state["launches"][key] = launches
        want = want_launches({"stft_mag_fwd": 1})
        if launches != want:
            bad.append(f"{variant}: launches {launches} != {want}")
        shapes = {"mixed_spec": (bs, f, t), "clean_specs": (bs, s, f, t),
                  "lip_frames": (bs, s * cfg.num_frames, cfg.frame_h,
                                 cfg.frame_w)}
        for name, shape in shapes.items():
            x = batch[name]
            if tuple(x.shape) != shape or x.device.type != "cuda" \
                    or not bool(torch.isfinite(x).all()):
                bad.append(f"{variant} {name}: {tuple(x.shape)} on "
                           f"{x.device}, finite "
                           f"{bool(torch.isfinite(x).all())}")
        lips = batch["lip_frames"]
        lip_range = [float(lips.min()), float(lips.max())]
        if lip_range[0] < 0.0 or lip_range[1] > 1.0:
            bad.append(f"{variant}: lip frames outside [0, 1]: {lip_range}")

        # The same variates (redrawn from the same generator seed), on the
        # CPU.
        variates = draw_variates(step_generator(0, 0, "cuda"), cfg, bs)
        ref = synthesize({k: v.cpu() for k, v in variates.items()}, cfg)
        errs = {}
        for name, atol, rtol in (("mixed_spec", 1e-3, 1e-5),
                                 ("clean_specs", 1e-3, 1e-5),
                                 ("lip_frames", 1e-5, 0.0)):
            got, want_ = batch[name].cpu(), ref[name]
            errs[name] = {"max_abs_err": max_err(got, want_), "atol": atol,
                          "rtol": rtol}
            if not within(got.numpy(), want_.numpy(), atol, rtol):
                bad.append(f"{variant} {name} card vs CPU {errs[name]}")
        gen = step_generator(0, 1, "cuda")
        out[variant] = {
            "sample_rate": cfg.sample_rate, "n_fft": cfg.n_fft,
            "hop": cfg.hop_length, "N": cfg.num_samples_audio, "F": f,
            "T": t, "launches": launches, "lip_range": lip_range,
            "peak_spectrum": float(batch["mixed_spec"].max()),
            "cpu_check": errs,
            "device_ms_per_batch": cuda_ms(
                lambda: generate_batch(gen, cfg, bs), iters=20)}
    if bad:
        raise AssertionError("; ".join(bad))

    host_cfg = dataclasses.replace(_data_config("scaled"), num_samples=bs)
    t0 = time.perf_counter()
    host = batch_iterator(SyntheticAVDataset(host_cfg), bs, seed=0)
    next(host)
    out["host_ms_per_batch_generated"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(10):
        next(host)
    out["host_ms_per_batch_cut_from_memory"] = \
        (time.perf_counter() - t0) / 10 * 1e3
    return out


def _run_cli(args):
    """cli.main(args) in process: its JSON stdout lines and the launches
    counted from 0 over the run."""
    import contextlib
    import io

    from av_separation_torch import cli
    from av_separation_torch.ops import kernels

    buf = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("{")]
    if rc != 0 or not lines or "final_step" not in lines[-1]:
        raise AssertionError(f"cli {args}: rc {rc}, lines {lines}")
    return lines, launches


def phase_train_device(state):
    import tempfile

    from av_separation_torch.config import get_config

    m = get_config("scaled").model
    if (m.d_model, m.nhead, m.num_encoder_layers, m.num_fusion_layers,
            m.dropout) != (512, 4, 6, 4, 0.1):
        raise AssertionError(f"not the scaled config: {m}")
    base = ["train", "--config", "scaled", "--batch", "8", "--data",
            "device"]
    per_step = want_launches({"flash_attn_fwd": 16, "flash_attn_bwd": 16,
                              "audio_proj_fwd": 1, "stft_mag_fwd": 1}
                             | dropout_launches(m))
    runs, bad = {}, []
    total = {name: 0 for name in per_step}
    for label, extra, steps in (("fused", ["--fused"], 20),
                                ("per_step", [], 6)):
        lines, launches = _run_cli(base + extra + ["--steps", str(steps)])
        final = lines[-1]
        for name, n in launches.items():
            total[name] += n
        got = {name: launches[name] / steps for name in per_step}
        if got != per_step:
            bad.append(f"{label}: launches per step {got} != {per_step}")
        if final["final_step"] != steps or not (
                np.isfinite(final["loss"])
                and np.isfinite(final["audio_s_per_s"])):
            bad.append(f"{label}: final line {final}")
        runs[label] = {"steps": steps, "lines": lines,
                       "launches_per_step": got,
                       "audio_s_per_s": final["audio_s_per_s"],
                       "ms_per_step": 8 * 4.0 / final["audio_s_per_s"] * 1e3}
    state["launches"]["train_device"] = total

    # Checkpoint and resume: 4 steps straight against 2 + resumed 2.  The
    # card's cuDNN backward is not guaranteed bit-deterministic, so the
    # losses are held to 1e-5 relative (the CPU test asserts equality).
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        every = ["--fused", "--checkpoint-every", "2"]
        straight, _ = _run_cli(base + every + [
            "--steps", "4", "--checkpoint-dir", f"{tmp}/straight"])
        _run_cli(base + every + ["--steps", "2", "--checkpoint-dir",
                                 f"{tmp}/resumed"])
        resumed, _ = _run_cli(base + every + [
            "--steps", "4", "--checkpoint-dir", f"{tmp}/resumed"])
        saved = sorted(p.name for p in Path(f"{tmp}/resumed").iterdir())
    l_straight, l_resumed = straight[-1]["loss"], resumed[-1]["loss"]
    rel = abs(l_straight - l_resumed) / abs(l_straight)
    if rel > 1e-5 or saved != ["2.pt", "4.pt"]:
        bad.append(f"resume: loss {l_resumed} vs {l_straight} (rel {rel}), "
                   f"files {saved}")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"config": "scaled", "card": state["card"], "batch": 8,
            "dropout": m.dropout, "runs": runs,
            "resume": {"loss_straight": l_straight,
                       "loss_resumed": l_resumed, "rel_diff": rel,
                       "tol": 1e-5, "files": saved}}


def phase_conformer(state):
    """conformer_l (17 + 17 conformer layers, d 512, 8 heads, K 31) through
    the port's entry points: `cli train --config conformer_l --data device
    --fused` in bf16 at batch 8, its launches a step (the flash pair, the
    projection, the STFT, 12 dropout sites a conformer layer pair each
    way, 34 GLU + depthwise calls each way); a float32 eval forward at
    batch 2 against the CPU (masks within 1e-4, as `configs` holds them);
    the Separator's masks against the model's own; one remat step at
    batch 2 moving each BatchNorm's running statistics once, as the step
    without remat moves them."""
    import dataclasses

    from av_separation_torch.config import get_config
    from av_separation_torch.inference import Separator
    from av_separation_torch.models.model import build_model
    from av_separation_torch.train import create_train_state, make_train_step

    cfg = get_config("conformer_l")
    m = dataclasses.replace(cfg.model, compute_dtype="bfloat16")
    if (m.encoder_block, m.d_model, m.nhead, m.num_encoder_layers,
            m.conv_kernel) != ("conformer", 512, 8, 17, 31):
        raise AssertionError(f"not the conformer_l config: {m}")
    bad, out = [], {}
    steps = 4
    lines, launches = _run_cli(["train", "--config", "conformer_l",
                                "--batch", "8", "--data", "device",
                                "--fused", "--dtype", "bfloat16",
                                "--steps", str(steps)])
    attn = 2 * m.num_encoder_layers + m.num_fusion_layers
    per_step = want_launches(
        {"flash_attn_fwd[bf16]": attn, "flash_attn_bwd[bf16]": attn,
         "audio_proj_fwd[bf16]": 1, "stft_mag_fwd": 1,
         "glu_dwconv_fwd[bf16]": 2 * m.num_encoder_layers,
         "glu_dwconv_bwd[bf16]": 2 * m.num_encoder_layers}
        | dropout_launches(m))
    got = {name: launches[name] / steps for name in per_step}
    if got != per_step:
        bad.append(f"launches per step {got} != {per_step}")
    final = lines[-1]
    if not np.isfinite(final["loss"]):
        bad.append(f"final line {final}")
    out["cli"] = {"final": final, "launches_per_step": got}
    state["launches"]["conformer"] = dict(launches)

    # float32 eval forward, card against the CPU.
    saved_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        data = dataclasses.replace(cfg.data, num_samples=2)
        from av_separation_torch.data.loader import batch_iterator
        from av_separation_torch.data.synthetic import SyntheticAVDataset
        b = next(batch_iterator(SyntheticAVDataset(data), 2, seed=0))
        net = build_model(cfg.model, device="cuda", seed=3)
        with torch.no_grad():
            _, masks = net(torch.as_tensor(b["mixed_spec"]).cuda(),
                           torch.as_tensor(b["lip_frames"]).cuda())
            cpu = build_model(cfg.model, device="cpu", seed=3)
            _, want = cpu(torch.as_tensor(b["mixed_spec"]),
                          torch.as_tensor(b["lip_frames"]))
        err = max_err(masks.cpu(), want)
        if err > 1e-4:
            bad.append(f"eval masks against the CPU: {err}")
        sep = Separator(cfg.model, net.state_dict(), cfg.data)
        _, sep_masks = sep.separate(b["mixed_spec"], b["lip_frames"])
        sep_err = max_err(torch.as_tensor(np.asarray(sep_masks)),
                          masks.cpu())
        if sep_err > 1e-6:
            bad.append(f"Separator masks against the model's: {sep_err}")
        out["eval"] = {"masks_err_vs_cpu": err, "tol": 1e-4,
                       "separator_err": sep_err}
        del net, cpu, sep
    finally:
        torch.backends.cudnn.allow_tf32 = saved_tf32

    # A remat step moves each BatchNorm once.
    stats = {}
    for remat in (False, True):
        mc = dataclasses.replace(m, remat=remat)
        # The same weights and generators from the config's seed.
        st = create_train_state(dataclasses.replace(cfg, model=mc))
        bb = next(batch_iterator(SyntheticAVDataset(data), 2, seed=1))
        make_train_step(dataclasses.replace(cfg, model=mc))(st, bb)
        stats[remat] = {k: v.detach().cpu()
                        for k, v in st.model.named_buffers()}
        del st
        torch.cuda.empty_cache()
    counts = {k: int(v) for k, v in stats[True].items()
              if k.endswith("num_batches_tracked")}
    moved_once = all(c == 1 for c in counts.values())
    same = all(torch.equal(v, stats[False][k])
               for k, v in stats[True].items())
    if not (moved_once and same and len(counts) == 3 + 2 * 17):
        bad.append(f"remat BatchNorm: counts {counts}, same as without "
                   f"remat {same}")
    out["remat"] = {"batch_norms": len(counts), "moved_once": moved_once,
                    "running_stats_as_without_remat": same}
    if bad:
        raise AssertionError("; ".join(bad))
    return out


def phase_train_device_profile(state):
    """Where the time of a fused device-data step goes, against the
    host-data step: the two run in turns (host, device, device, host), four
    steps each on the host clock with one read of the loss at the end, on
    two train states of the scaled config (batch 8, dropout 0.1); then two
    fused steps traced with torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from av_separation_torch.train import (create_train_state,
                                           make_fused_train_steps,
                                           make_train_step)

    cfg, batches = _scaled_train_setup(0.1, 24, 8)
    host_state = create_train_state(cfg, device="cuda")
    dev_state = create_train_state(cfg, device="cuda")
    step, two = make_train_step(cfg), make_fused_train_steps(cfg, 2)

    def host_steps(ts, n):
        for _ in range(n):
            ts, metrics = step(ts, next(batches))
        return ts, metrics["loss"]

    def device_steps(ts, n):
        for _ in range(n // 2):
            ts, loss = two(ts)
        return ts, loss

    def timed(fn, ts, n=4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, loss = fn(ts, n)
        float(loss)
        torch.cuda.synchronize()
        return ts, (time.perf_counter() - t0) / n * 1e3

    host_state, _ = timed(host_steps, host_state, 2)   # set-up
    dev_state, _ = timed(device_steps, dev_state, 2)
    turns = {"host": [], "device": []}
    for which in ("host", "device", "device", "host"):
        if which == "host":
            host_state, ms = timed(host_steps, host_state)
        else:
            dev_state, ms = timed(device_steps, dev_state)
        turns[which].append(ms)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dev_state, loss = two(dev_state)
        float(loss)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / 2 * 1e3
    return {"config": "scaled", "batch": 8, "card": state["card"],
            "host_data_ms_per_step": turns["host"],
            "device_data_fused_ms_per_step": turns["device"],
            "traced_step_ms": traced_ms,
            **device_split(prof, 2, "step")}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _resume_check(base: list, tmp: str, label: str, bad: list) -> dict:
    """4 CLI steps straight against 2 + resumed 2 (--checkpoint-every 2):
    final losses within 1e-5 relative (the card's cuDNN backward is not
    bit-deterministic; the CPU tests assert equality)."""
    every = base + ["--checkpoint-every", "2"]
    straight, _ = _run_cli(every + ["--steps", "4", "--checkpoint-dir",
                                    f"{tmp}/{label}_straight"])
    _run_cli(every + ["--steps", "2", "--checkpoint-dir",
                      f"{tmp}/{label}_resumed"])
    resumed, _ = _run_cli(every + ["--steps", "4", "--checkpoint-dir",
                                   f"{tmp}/{label}_resumed"])
    a, b = resumed[-1]["loss"], straight[-1]["loss"]
    if _rel(a, b) > 1e-5:
        bad.append(f"{label} resume: loss {a} vs {b}")
    return {"loss_straight": b, "loss_resumed": a, "rel_diff": _rel(a, b),
            "tol": 1e-5}


PIPELINES = ("host", "files", "files_dynamic", "native")


def _pipeline(name: str, cfg, corpus: str):
    """A fresh batch iterator (batch 8, seed 0) of one pipeline: the host
    dataset's 24 samples, the corpus static or remixed (4 threads), the
    native generator.  The caller closes it."""
    from av_separation_torch.data.files import (FileAVDataset,
                                                PrefetchIterator)
    from av_separation_torch.data.loader import batch_iterator
    from av_separation_torch.data.native_loader import NativeBatchIterator
    from av_separation_torch.data.synthetic import SyntheticAVDataset

    if name == "host":
        return batch_iterator(SyntheticAVDataset(cfg.data), 8, seed=0)
    if name == "native":
        return NativeBatchIterator(cfg.data, 8)
    return PrefetchIterator(FileAVDataset(
        corpus, cfg.data, dynamic_mix=name == "files_dynamic"), 8)


def phase_data_tiers(state):
    """The file-corpus and native tiers feeding scaled training (full
    width and depth, batch 8, dropout 0.1).

    - corpus: 24 scaled samples written by `write_synthetic_corpus`; the
      first 6 batches of PrefetchIterator(FileAVDataset, 8, seed 0, 4
      threads) equal the host batch_iterator's over the same 24 samples,
      bit for bit, and 6 steps fed by each give losses within 1e-5
      relative.
    - `cli train --data files` (static, then --dynamic-mix) and `--data
      native`, 6 steps each: 16 flash forwards, 16 backwards, 1
      projection and no STFT a step (the spectrograms come from the
      host); finite loss and audio-s/s; 4 steps straight against 2 +
      resumed 2 within 1e-5 relative in each mode.
    - `--dtype bfloat16 --data files`, 2 steps: only the bf16 instances.
    - `--debug-nans`: a clean 2-step run gives the loss of the run without
      it (1e-5 relative); one NaN in mixed_spec raises FloatingPointError
      naming audio_encoder.projection (the projection kernel's output),
      one in lip_frames naming visual_encoder.conv.0; the flag's cost in
      ms a step, in turns with the step without it.
    - timings, not gated: host ms a batch of 8 of each pipeline alone
      (24 batches after the first, host clock); the scaled step's ms fed
      by each, in turns (8 steps after 2, host clock, synchronised), and
      the device's busy share of 3 traced steps fed by each; every
      measurement on a fresh iterator."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from av_separation_torch.data.files import (FileAVDataset,
                                                PrefetchIterator,
                                                write_synthetic_corpus)
    from av_separation_torch.train import create_train_state, make_train_step
    from av_separation_torch.utils.debug import debug_nans

    cfg, host_batches = _scaled_train_setup(0.1, 24, 8)
    m = cfg.model
    if (m.d_model, m.nhead, m.num_encoder_layers, m.num_fusion_layers,
            m.dropout) != (512, 4, 6, 4, 0.1):
        raise AssertionError(f"not the scaled config: {m}")
    bad, out = [], {"config": "scaled", "card": state["card"], "batch": 8,
                    "dropout": m.dropout}
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        corpus = f"{tmp}/corpus"
        t0 = time.perf_counter()
        write_synthetic_corpus(corpus, cfg.data, 24)
        out["corpus"] = {"samples": 24, "write_s": time.perf_counter() - t0}

        # The files tier against the host pipeline on the same samples.
        files = PrefetchIterator(FileAVDataset(corpus, cfg.data), 8, seed=0,
                                 num_threads=4)
        try:
            fb = [next(files) for _ in range(6)]
        finally:
            files.close()
        hb = [next(host_batches) for _ in range(6)]
        same = all(np.array_equal(a[k], b[k]) for a, b in zip(fb, hb)
                   for k in a)
        if not same:
            bad.append("files batches differ from the host batches")
        losses = {}
        for label, batches in (("host", hb), ("files", fb)):
            ts, step = create_train_state(cfg, device="cuda"), \
                make_train_step(cfg)
            losses[label] = []
            for batch in batches:
                ts, metrics = step(ts, batch)
                losses[label].append(float(metrics["loss"]))
        rel = max(_rel(a, b) for a, b in zip(losses["files"],
                                             losses["host"]))
        if rel > 1e-5 or not np.all(np.isfinite(losses["files"])):
            bad.append(f"files-fed losses {losses['files']} vs host "
                       f"{losses['host']}")
        out["against_host"] = {"batches_bit_equal": same, "losses": losses,
                               "max_rel_diff": rel, "tol": 1e-5}

        # The command line, each tier.
        base = ["train", "--config", "scaled", "--batch", "8"]
        files_args = ["--data", "files", "--data-root", corpus]
        per_step = want_launches({"flash_attn_fwd": 16, "flash_attn_bwd": 16,
                                  "audio_proj_fwd": 1}
                                 | dropout_launches(m))
        total = {name: 0 for name in per_step}
        runs = {}
        for label, args in (("files", files_args),
                            ("files_dynamic", files_args + ["--dynamic-mix"]),
                            ("native", ["--data", "native"])):
            lines, launches = _run_cli(base + args + ["--steps", "6"])
            for name, n in launches.items():
                total[name] += n
            got = {name: launches[name] / 6 for name in per_step}
            final = lines[-1]
            if got != per_step:
                bad.append(f"{label}: launches per step {got}")
            if final["final_step"] != 6 or not (
                    np.isfinite(final["loss"])
                    and np.isfinite(final["audio_s_per_s"])):
                bad.append(f"{label}: final line {final}")
            runs[label] = {"final": final, "launches_per_step": got,
                           "resume": _resume_check(base + args, tmp, label,
                                                   bad)}
        lines, launches = _run_cli(base + files_args + [
            "--dtype", "bfloat16", "--steps", "2"])
        for name, n in launches.items():
            total[name] += n
        if not _bf16_instances_only(launches) or not np.isfinite(
                lines[-1]["loss"]):
            bad.append(f"bf16 files: launches {launches}, {lines[-1]}")
        runs["files_bf16"] = {"final": lines[-1], "launches": launches}
        state["launches"]["data_tiers"] = total
        out["cli"] = runs

        # --debug-nans: the same numbers on clean data, the producing
        # module named on poisoned data, and its cost.
        plain, _ = _run_cli(base + files_args + ["--steps", "2"])
        checked, _ = _run_cli(base + files_args + ["--steps", "2",
                                                   "--debug-nans"])
        a, b = checked[-1]["loss"], plain[-1]["loss"]
        if _rel(a, b) > 1e-5:
            bad.append(f"--debug-nans changed the loss: {a} vs {b}")
        named = {}
        for key, want in (("mixed_spec", "audio_encoder.projection"),
                          ("lip_frames", "visual_encoder.conv.0")):
            ts, step = create_train_state(cfg, device="cuda"), \
                make_train_step(cfg)
            batch = {k: v.copy() for k, v in fb[0].items()}
            batch[key][0].flat[0] = np.nan
            try:
                with debug_nans(ts.model):
                    step(ts, batch)
                named[key] = "no error"
            except FloatingPointError as e:
                named[key] = str(e)
            if f"module {want} " not in named[key]:
                bad.append(f"NaN in {key}: {named[key]}")
        ts, step = create_train_state(cfg, device="cuda"), \
            make_train_step(cfg)
        cost = {"off": [], "on": []}
        for which in ("off", "on", "on", "off"):
            ctx = debug_nans(ts.model) if which == "on" \
                else contextlib.nullcontext()
            with ctx:
                step(ts, fb[0])  # the first step in a mode is not timed
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for batch in fb[1:4]:
                    ts, metrics = step(ts, batch)
                float(metrics["loss"])
                torch.cuda.synchronize()
            cost[which].append((time.perf_counter() - t0) / 3 * 1e3)
        out["debug_nans"] = {
            "loss_with": a, "loss_without": b, "rel_diff": _rel(a, b),
            "tol": 1e-5, "errors": named, "ms_per_step": cost,
            "cost_ms_per_step": float(np.mean(cost["on"])
                                      - np.mean(cost["off"]))}

        # Timings.  A prefetcher banks finished batches (4 queued, 4 in
        # flight), so each measurement starts a fresh iterator and runs
        # long past that bank: 24 batches alone, 8 steps after 2.
        per_batch = {}
        for name in PIPELINES:
            it = _pipeline(name, cfg, corpus)
            try:
                next(it)
                t0 = time.perf_counter()
                for _ in range(24):
                    next(it)
                per_batch[name] = (time.perf_counter() - t0) / 24 * 1e3
            finally:
                it.close()
        ts, step = create_train_state(cfg, device="cuda"), \
            make_train_step(cfg)

        def fed(name, steps, trace=False):
            """ms a step (host clock) over `steps` steps fed by a fresh
            iterator of `name` after 2 steps, and the profiler's split
            when traced."""
            nonlocal ts
            it = _pipeline(name, cfg, corpus)
            try:
                for _ in range(2):
                    ts, metrics = step(ts, next(it))
                float(metrics["loss"])
                torch.cuda.synchronize()
                with (profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA])
                      if trace else contextlib.nullcontext()) as prof:
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        ts, metrics = step(ts, next(it))
                    float(metrics["loss"])
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) / steps * 1e3
            finally:
                it.close()
            if not trace:
                return ms
            split = device_split(prof, steps, "step")
            return {"traced_step_ms": ms,
                    "device_ms_per_step": split["device_ms_per_step"]}

        order = PIPELINES + PIPELINES[::-1]
        step_ms = {name: [] for name in PIPELINES}
        for name in order:
            step_ms[name].append(fed(name, 8))
        busy = {name: fed(name, 3, trace=True) for name in PIPELINES}
        out["timings"] = {
            "host_ms_per_batch": per_batch, "step_ms_in_turns": step_ms,
            "order": order, "traced": busy,
            "note": "host clock; each step or batch from a fresh iterator "
                    "past its first batches"}
    if bad:
        raise AssertionError("; ".join(bad))
    return out


# The bf16 train step against the float32 one, relative to the float32
# step's loss and grad norm.  An NVIDIA H100 80GB HBM3 at 700 W measured
# 1.06e-3 and 5.1e-4 (scaled config, batch 8, dropout 0.1; the forward is
# deterministic, so the loss's reading repeats).  A step faulted on half
# the batch or without the attention dropout must exceed one limit: the
# latter moved the loss 3.1e-3 and the grad norm only 4.8e-4.
TRAIN_BF16_RTOL = {"loss": 2e-3, "grad_norm": 2e-3}


def phase_bf16(state):
    """bfloat16 compute on the card (the JAX bench's dtype).

    - serve: the scaled config at full width and depth (seeded weights) at
      compute_dtype bfloat16 through a Separator on the card: one waveform
      batch of 8 (4 s, 200 lip frames), launches counted (16 flash, 1
      projection, 1 decoder, all bf16 but the float32 decoder).  Against
      the port's own bf16 forward on the CPU for the first 2 rows (masks
      within 2e-2: bf16 rounding flips that compound over 10 layers on
      each side; waveforms within 2e-2 x peak), and against the card's
      float32 Separator on all 8 (the JAX rule, tests/test_train.py:87-102:
      separated spectra within 0.5).
    - train: one scaled step at dropout 0.1 and batch 8, bf16 against
      float32 from the same weights, generators and batch (the same
      dropout draws): loss and grad norm finite and within
      `TRAIN_BF16_RTOL` of the float32 step's, launches per step
      16 / 16 / 1 / 0 and 51 / 51 dropout (the decoder's float32), all
      bf16 instances.  Two faulted bf16 steps (half
      the batch; no attention dropout) must fall outside those limits.
    - demo: the 100-step demo at bf16 must pass +35 dB.
    Launches are kept apart from the float32 paths' (the [bf16] kernel
    entries)."""
    import dataclasses

    from av_separation_torch import demo
    from av_separation_torch.config import get_config
    from av_separation_torch.data.synthetic import SyntheticAVDataset
    from av_separation_torch.inference import Separator
    from av_separation_torch.models.layers import MultiHeadAttention
    from av_separation_torch.models.model import build_model
    from av_separation_torch.ops import kernels
    from av_separation_torch.train import create_train_state, make_train_step

    bad, out = [], {}
    by_path = state["launches"]
    cfg = get_config("scaled")
    m16 = dataclasses.replace(cfg.model, compute_dtype="bfloat16")
    state_dict = build_model(cfg.model, device="cpu", seed=0).state_dict()
    ds = SyntheticAVDataset(cfg.data)
    mixes, lips = [], []
    for i in range(8):
        audios, rng = ds.clean_audios(i)
        mixes.append(audios.sum(axis=0).astype(np.float32))
        lips.append(ds.lip_stream(audios, rng))
    mixes, lips = np.stack(mixes), np.stack(lips)

    sep16 = Separator(m16, state_dict, cfg.data, device="cuda")
    sep16.separate_waveform(mixes, lips)  # warm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = sep16.separate_waveform(mixes, lips)
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    serve_trace = _traced(lambda: sep16.separate_waveform(mixes, lips), 3,
                          "batch")
    by_path["bf16_serve"] = launches
    want = want_launches({"flash_attn_fwd[bf16]": 16,
                          "audio_proj_fwd[bf16]": 1,
                          "mask_decoder_fwd": 1})
    if launches != want:
        bad.append(f"serve launches {launches} != {want}")
    f32 = Separator(cfg.model, state_dict, cfg.data,
                    device="cuda").separate_waveform(mixes, lips)
    cpu = Separator(m16, state_dict, cfg.data,
                    device="cpu").separate_waveform(mixes[:2], lips[:2])
    mask_err = float(np.abs(got["masks"][:2] - cpu["masks"]).max())
    wpeak = float(np.abs(cpu["waveforms"]).max())
    wave_err = float(np.abs(got["waveforms"][:2] - cpu["waveforms"]).max())
    sep = got["masks"] * got["mixed_spec"][:, None]
    sep32 = f32["masks"] * f32["mixed_spec"][:, None]
    rule_err = float(np.abs(sep - sep32).max())
    finite = all(np.isfinite(a).all() for a in got.values())
    if not finite or got["waveforms"].dtype != np.float32:
        bad.append("serve: outputs not finite float32")
    if mask_err > 2e-2 or wave_err > 2e-2 * wpeak:
        bad.append(f"serve vs CPU bf16: masks {mask_err}, waves {wave_err}")
    if rule_err > 0.5:
        bad.append(f"serve vs card float32: separated {rule_err} > 0.5")
    out["serve"] = {"batch": 8, "ms": batch_ms, "launches": launches,
                    "trace": serve_trace,
                    "vs_cpu_bf16_rows2": {"mask_max_abs_err": [mask_err,
                                                               2e-2],
                                          "wave_max_abs_err": [
                                              wave_err, 2e-2 * wpeak]},
                    "vs_card_float32_separated_max_abs_err": [rule_err,
                                                              0.5],
                    "vs_card_float32_mask_max_abs_err": float(np.abs(
                        got["masks"] - f32["masks"]).max())}

    cfg_t, batches = _scaled_train_setup(0.1, 8, 8)
    batch = next(batches)
    half = {k: v[:4] for k, v in batch.items()}

    def no_attn_dropout(model):
        for mod in model.modules():
            if isinstance(mod, MultiHeadAttention):
                mod.dropout = 0.0

    # The bf16 step, the float32 step, then two faulted bf16 steps that
    # the check must refuse: one on half the batch, one that skips the
    # attention dropout.
    runs = {}
    for label, dtype, data, fault in (
            ("bfloat16", "bfloat16", batch, None),
            ("float32", "float32", batch, None),
            ("control_half_batch", "bfloat16", half, None),
            ("control_no_attn_dropout", "bfloat16", batch,
             no_attn_dropout)):
        c = dataclasses.replace(cfg_t, model=dataclasses.replace(
            cfg_t.model, compute_dtype=dtype))
        ts = create_train_state(c, device="cuda")
        if fault is not None:
            fault(ts.model)
        step = make_train_step(c)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ts, met = step(ts, data)
        loss, norm = float(met["loss"]), float(met["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.LAUNCHES)
        if label == "bfloat16":
            by_path["bf16_train"] = launches
            # A second bf16 step: its time without the first's set-up.
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, met = step(ts, batch)
            float(met["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            held = [ts]

            def one_step():
                held[0], m_ = step(held[0], batch)
                float(m_["loss"])

            out["train_trace"] = _traced(one_step, 2, "step")
            ts = held[0]
        runs[label] = {"loss": loss, "grad_norm": norm, "ms": ms,
                       "launches": launches}
        del ts, step
    t16, t32 = runs["bfloat16"], runs["float32"]
    want = want_launches({"flash_attn_fwd[bf16]": 16,
                          "flash_attn_bwd[bf16]": 16,
                          "audio_proj_fwd[bf16]": 1}
                         | dropout_launches(dataclasses.replace(
                             cfg_t.model, compute_dtype="bfloat16")))
    if t16["launches"] != want:
        bad.append(f"train launches {t16['launches']} != {want}")
    if not (np.isfinite(t16["loss"]) and np.isfinite(t16["grad_norm"])):
        bad.append(f"train: {t16}")

    def rel_diffs(run):
        return {key: abs(run[key] - t32[key]) / abs(t32[key])
                for key in ("loss", "grad_norm")}

    checks = {label: rel_diffs(run) for label, run in runs.items()
              if label != "float32"}
    for label, diffs in checks.items():
        held = all(diffs[key] <= TRAIN_BF16_RTOL[key] for key in diffs)
        if held != (label == "bfloat16"):
            bad.append(f"train {label} vs float32: relative {diffs}, "
                       f"limits {TRAIN_BF16_RTOL} (all: {checks})")
    out["train"] = {"config": "scaled", "batch": 8, "dropout": 0.1,
                    **runs, "rel_diff_vs_float32": checks,
                    "rtol": TRAIN_BF16_RTOL}

    lines = []
    kernels.reset_launch_counts()
    res = demo.run(device="cuda", log=lines.append, dtype="bfloat16")
    launches = by_path["bf16_demo"] = dict(kernels.LAUNCHES)
    print("\n".join(lines), file=sys.stderr, flush=True)
    if not res["passed"]:
        bad.append(f"bf16 demo gate: {res}")
    if not _bf16_instances_only(launches):
        bad.append(f"bf16 demo launches {launches}")
    out["demo"] = {"gate_db": demo.PASS_DB, **res, "launches": launches}
    if bad:
        raise AssertionError("; ".join(bad))
    return {"card": state["card"], **out}


# The kernels with a bfloat16 instance: a bf16-compute run launches those
# instances and never the float32 ones (the decoder and the STFT stay
# float32 at every compute dtype), and one weight split a projection.
BF16_WRAPPERS = ("flash_attn_fwd", "flash_attn_bwd", "audio_proj_fwd",
                 "audio_proj_split")


def _splits_match(launches: dict) -> bool:
    return all(launches["audio_proj_split" + dt]
               == launches["audio_proj_fwd" + dt] for dt in ("", "[bf16]"))


def _bf16_instances_only(launches: dict) -> bool:
    return all(launches[n] == 0 and launches[n + "[bf16]"] > 0
               for n in BF16_WRAPPERS) and _splits_match(launches)


def _float32_instances_only(launches: dict) -> bool:
    return all(launches[n] > 0 and launches[n + "[bf16]"] == 0
               for n in BF16_WRAPPERS) and _splits_match(launches)


def phase_bench(state):
    """`python -m av_separation_torch.cli bench` in process: at the JAX
    bench's defaults (demo, batch 128, bfloat16, fused, 250 steps), then
    per_step and float32 at 50 steps each.  Each JSON line is printed; the
    line must carry the JAX keys and, on an H100, the roofline fields.
    The bf16 runs must launch the [bf16] instances of the flash pair and
    the projection and none of their float32 ones; the float32 run the
    reverse."""
    import contextlib
    import io

    from av_separation_torch import cli
    from av_separation_torch.ops import kernels

    out, bad = {}, []
    runs = (("defaults", []),
            ("per_step", ["--mode", "per_step", "--steps", "50"]),
            ("float32", ["--dtype", "float32", "--steps", "50"]))
    for label, extra in runs:
        buf = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["bench", *extra])
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("{")]
        print("\n".join(lines), flush=True)
        line = json.loads(lines[-1]) if lines else {}
        state["launches"]["bench_" + label] = launches
        only = _float32_instances_only if label == "float32" \
            else _bf16_instances_only
        if not only(launches):
            bad.append(f"bench {label}: launches {launches}")
        need = {"metric", "value", "unit", "vs_baseline"}
        if "H100" in torch.cuda.get_device_name(0):
            need |= {"device", "pct_peak_flops", "bound", "pct_roofline"}
        if rc != 0 or len(lines) != 1 or not need <= set(line):
            bad.append(f"bench {label}: rc {rc}, lines {lines}")
        out[label] = {"argv": ["bench", *extra], "line": line,
                      "wall_s": wall, "launches": launches}
    if bad:
        raise AssertionError("; ".join(bad))
    return {"card": state["card"], **out}


def phase_demo(state):
    from av_separation_torch import demo
    from av_separation_torch.ops import kernels

    lines = []
    kernels.reset_launch_counts()
    out = demo.run(device="cuda", log=lines.append)
    launches = dict(kernels.LAUNCHES)
    print("\n".join(lines), file=sys.stderr, flush=True)
    state["launches"]["demo"] = launches
    if not out["passed"]:
        raise AssertionError(f"demo gate failed: {out}")
    if not _float32_instances_only(launches):
        raise AssertionError(f"demo launches {launches}")
    return {"config": "demo", "card": state["card"], **out,
            "gate_db": demo.PASS_DB, "launches": launches}


def _parallel_one_rank(bad: list, state) -> dict:
    """multihost on a mesh of one rank over NCCL against the same step
    without a mesh; a full checkpoint into a one-device Separator."""
    import dataclasses
    import socket
    import tempfile

    from av_separation_torch.config import MeshConfig, get_config
    from av_separation_torch.data.loader import batch_iterator
    from av_separation_torch.data.synthetic import SyntheticAVDataset
    from av_separation_torch.inference import Separator
    from av_separation_torch.ops import kernels
    from av_separation_torch.parallel import distributed, shard
    from av_separation_torch.train import create_train_state, make_train_step
    from av_separation_torch.utils.checkpoint import save_checkpoint

    cfg = get_config("multihost")
    n = cfg.train.batch_size
    data = dataclasses.replace(cfg.data, num_samples=n)
    batch = next(batch_iterator(SyntheticAVDataset(data), n, seed=0))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = {}
    ref = create_train_state(cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref, met = make_train_step(cfg)(ref, batch)
    out["plain"] = {"loss": float(met["loss"]),
                    "grad_norm": float(met["grad_norm"]),
                    "cold_step_ms": (time.perf_counter() - t0) * 1e3,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del ref, met
    torch.cuda.empty_cache()
    distributed.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = distributed.global_mesh(MeshConfig())
        ts = create_train_state(cfg, device="cuda", mesh=mesh)
        step = make_train_step(cfg, mesh)
        local = distributed.host_local_batch_to_global(batch, mesh, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ts, met = step(ts, local)
        loss, norm = float(met["loss"]), float(met["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.LAUNCHES)
        state["launches"]["parallel"] = launches
        m = cfg.model
        per_step = 2 * m.num_encoder_layers + m.num_fusion_layers
        want = want_launches(dict(flash_attn_fwd=2 * per_step,
                                  flash_attn_bwd=per_step, audio_proj_fwd=1)
                             | dropout_launches(m))
        out["mesh_1x1x1x1"] = {
            "backend": torch.distributed.get_backend(), "loss": loss,
            "grad_norm": norm, "cold_step_ms": ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}
        for key, got in (("loss", loss), ("grad_norm", norm)):
            rel = _rel(got, out["plain"][key])
            out[f"{key}_rel"] = [rel, 1e-6]
            if rel > 1e-6:
                bad.append(f"one-rank mesh {key} {got} vs "
                           f"{out['plain'][key]}")
        if launches != want:
            bad.append(f"one-rank mesh launches {launches} != {want}")
        # A full checkpoint, read by a Separator on one device.
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            save_checkpoint(tmp, ts.step, ts, wait=True)
            full = shard.full_state_dict(ts.model, mesh)
            sep = Separator.from_checkpoint(tmp, cfg.model, cfg.data,
                                            device="cuda")
        same = all(torch.equal(v.cpu(), full[k].cpu())
                   for k, v in sep.model.state_dict().items())
        separated, _ = sep.separate(batch["mixed_spec"][:2],
                                    batch["lip_frames"][:2])
        out["checkpoint"] = {"separator_weights_equal": same,
                             "separated_finite":
                                 bool(np.isfinite(separated).all())}
        if not same or not np.isfinite(separated).all():
            bad.append(f"mesh checkpoint into a Separator: {out['checkpoint']}")
        del sep, full
        out["warm_step_ms_in_turns"] = _one_rank_turns(cfg, ts, step, local)
        del ts, step
    finally:
        distributed.shutdown()
        torch.cuda.empty_cache()
    return out


def _one_rank_turns(cfg, ts, mesh_step, local, rounds: int = 3) -> dict:
    """Warm step ms of the plain step and the mesh-of-one step on the same
    batch on the card: one untimed step each, then `rounds` rounds in
    turns (plain, mesh; mesh, plain; ...), so that neither side always
    runs first.  The first (cold) steps above are timed apart."""
    from av_separation_torch.train import create_train_state, make_train_step

    sides = {"plain": [create_train_state(cfg, device="cuda"),
                       make_train_step(cfg)],
             "mesh_1x1x1x1": [ts, mesh_step]}
    times = {name: [] for name in sides}

    def run(name, timed=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sides[name][0], met = sides[name][1](sides[name][0], local)
        float(met["loss"])
        torch.cuda.synchronize()
        if timed:
            times[name].append((time.perf_counter() - t0) * 1e3)

    for name in sides:
        run(name, timed=False)
    for i in range(rounds):
        for name in (list(sides) if i % 2 == 0 else list(sides)[::-1]):
            run(name)
    sides.clear()
    return times


def _shard_flash(bad, record, gen, label, cfg_axes, b, h, t, dh, dtype):
    """Every rank's flash call of one layer at its shard shape, kernel and
    plain, with the seeds folded by position (`shard_seed`): the assembled
    output and the gradients against the plain version's shard loop at
    dropout 0.1 and against one unsharded kernel call at dropout 0; rank
    0's block as the kernels phase's timed rows.  Each rank's q, k and v
    are column slices of its own packed projection (B/R, T/S, 3 d/M), d =
    h * dh, as the TP split of in_proj_weight lays them out; under 'seq'
    its K and V are the time blocks of every seq rank, gathered."""
    from av_separation_torch.config import MeshConfig
    from av_separation_torch.ops.attention import shard_seed, split_heads
    from av_separation_torch.ops.kernels.attention import (
        flash_attention, flash_attn_bwd_torch, flash_attn_fwd_torch)

    cfg = MeshConfig(**cfg_axes)
    nr = cfg.data * cfg.fsdp
    rows, heads, tq = b // nr, h // cfg.model, t // cfg.seq
    dl = heads * dh
    ranks = [(r, m, s) for r in range(nr) for m in range(cfg.model)
             for s in range(cfg.seq)]
    packed = {at: torch.randn(rows, tq, 3 * dl, generator=gen).to(dtype)
              .cuda() for at in ranks}
    do = torch.randn(b, h, t, dh, generator=gen).to(dtype).cuda()
    bf16 = dtype == torch.bfloat16

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, rate, seed):
            o, lse = flash_attn_fwd_torch(q, k, v, rate, seed)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.rs = (rate, seed)
            return o

        @staticmethod
        def backward(ctx, g):
            q, k, v, o, lse = ctx.saved_tensors
            return (*flash_attn_bwd_torch(q, k, v, o, g.contiguous(), lse,
                                          *ctx.rs), None, None)

    def qkv(leaves, r, m, s):
        """Rank (r, m, s)'s q, and its K and V gathered along time over
        'seq' (its own block when 'seq' is 1)."""
        q = split_heads(leaves[(r, m, s)][..., :dl], heads)
        kv = [torch.cat([leaves[(r, m, s_)][..., i * dl:(i + 1) * dl]
                         for s_ in range(cfg.seq)], dim=1)
              if cfg.seq > 1 else leaves[(r, m, s)][..., i * dl:(i + 1) * dl]
              for i in (1, 2)]
        return (q, *(split_heads(x, heads) for x in kv))

    def blocks(fn):
        """fn(r, m, s) -> (B/R, H/M, T/S, dh), laid out as (B, H, T, dh)."""
        return torch.cat([torch.cat([torch.cat(
            [fn(r, m, s) for s in range(cfg.seq)], dim=2)
            for m in range(cfg.model)], dim=1) for r in range(nr)], dim=0)

    def run(attend, rate, whole=False):
        leaves = {at: x.detach().requires_grad_() for at, x in packed.items()}
        if whole:  # one call over the global tensors
            q = blocks(lambda r, m, s: qkv(leaves, r, m, s)[0])
            k, v = (torch.cat([torch.cat(
                [qkv(leaves, r, m, 0)[i] for m in range(cfg.model)], dim=1)
                for r in range(nr)], dim=0) for i in (1, 2))
            o = attend(q, k, v, rate, ATTN_SEED)
        else:
            o = blocks(lambda r, m, s: attend(
                *qkv(leaves, r, m, s), rate, shard_seed(ATTN_SEED, cfg, dict(
                    data=r // cfg.fsdp, fsdp=r % cfg.fsdp, seq=s, model=m))))
        o.backward(do)
        return [o.detach()] + [leaves[at].grad for at in ranks]

    res = {}
    for rate in (0.1, 0.0):
        got = run(flash_attention, rate)
        ref = run(Plain.apply, rate) if rate \
            else run(flash_attention, 0.0, whole=True)
        errs = [max_err(x, y) for x, y in zip(got, ref)]
        tols = [bf16_tol(y) if bf16 else 3e-5 for y in ref]
        key = ("against the plain shard loop, dropout 0.1" if rate
               else "against one unsharded kernel call, dropout 0")
        res[key] = {"max_err_o": errs[0], "max_err_grads": max(errs[1:]),
                    "tol_o": tols[0], "ranks": len(ranks)}
        if any(e > tl for e, tl in zip(errs, tols)):
            bad.append(f"{label} {dtype} {key}: {errs} > {tols}")
    # Rank 0's call through the kernels phase's rows.
    q0, k0, v0 = qkv(packed, 0, 0, 0)
    for rate in (0.0, 0.1):
        _attn_rows(record, label, rate, q0, k0, v0, gen)
    return res


def phase_parallel(state):
    """The parallel tier on the card: one rank over NCCL at multihost,
    the kernels at shard shapes, two ranks on one card over gloo."""
    bad = []
    out = {"one_rank": _parallel_one_rank(bad, state)}
    results = state.setdefault("kernel_rows", {n: [] for n in KERNELS})
    failures = []
    record = make_record(results, failures)
    gen = torch.Generator().manual_seed(13)
    shard_rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        shard_rows[f"multihost TP {dt}"] = _shard_flash(
            bad, record, gen, "multihost TP rank (data 2 x model 4)",
            dict(data=2, model=4), 16, 8, 501, 128, dtype)
        shard_rows[f"scaled seq {dt}"] = _shard_flash(
            bad, record, gen, "scaled seq rank (seq 4, Tq 256)",
            dict(seq=4), 8, 4, 1024, 128, dtype)
        torch.cuda.empty_cache()
    _proj_rows(record, gen, [("multihost rank (8 of 16 rows)", 8, 501, 1024,
                              torch.float32),
                             ("multihost rank (8 of 16 rows)", 8, 501, 1024,
                              torch.bfloat16)])
    _decoder_rows(record, gen, (("multihost rank (8 of 16 rows)", 8, 501,
                                 1024, 4),))
    out["shard_kernels"] = shard_rows
    out["two_ranks_one_card"] = _parallel_two_ranks(bad)
    out["routes_on_card"] = sorted(PARALLEL_ROUTES_ON_CARD)
    out["routes_cpu_only"] = PARALLEL_ROUTES_CPU_ONLY
    bad += failures
    if bad:
        raise AssertionError(f"parallel checks failed: {bad}")
    return out


def _two_rank_cfg():
    """A demo-width model (d 128, 4 heads of 32) at T 64 (8,064 samples at
    hop 128), dropout 0, batch 4: each route's shapes divide."""
    import dataclasses

    from av_separation_torch.config import get_config
    cfg = get_config("demo")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=0.0),
        data=dataclasses.replace(cfg.data, sample_rate=8064, num_samples=4),
        train=dataclasses.replace(cfg.train, batch_size=4))


def _two_rank_batch(cfg):
    from av_separation_torch.data.loader import batch_iterator
    from av_separation_torch.data.synthetic import SyntheticAVDataset
    return next(batch_iterator(SyntheticAVDataset(cfg.data), 4, seed=0))


def _parallel_rank(route: str, rank: int, port: int, out_path: str) -> int:
    """One of two ranks on the card (gloo): a train step of route's mesh."""
    from av_separation_torch.config import MeshConfig
    from av_separation_torch.parallel import distributed
    from av_separation_torch.train import create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    try:
        cfg = _two_rank_cfg()
        mesh = distributed.global_mesh(
            MeshConfig(**PARALLEL_ROUTES_ON_CARD[route]))
        ts = create_train_state(cfg, device="cuda", mesh=mesh)
        step = make_train_step(cfg, mesh)
        local = distributed.host_local_batch_to_global(
            _two_rank_batch(cfg), mesh, "cuda")
        ts, met = step(ts, local)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, met2 = step(ts, local)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        with open(out_path, "w") as f:
            json.dump({"loss": float(met["loss"]),
                       "grad_norm": float(met["grad_norm"]),
                       "second_loss": float(met2["loss"]),
                       "second_step_ms": ms}, f)
        distributed.barrier(60.0)
    finally:
        distributed.shutdown()
    return 0


def _parallel_two_ranks(bad: list) -> dict:
    """Each route of PARALLEL_ROUTES_ON_CARD as two processes on the card
    against two one-process steps: each rank's first loss and its second
    (which the first step's reduced gradients moved) within atol 1e-4 +
    rtol 1e-5, its grad norm (the gradients' all-reduce, FSDP's and the
    K/V gather's reduce-scatters) within rtol 1e-5."""
    import socket
    import tempfile

    from av_separation_torch.train import create_train_state, make_train_step

    cfg = _two_rank_cfg()
    ts = create_train_state(cfg, device="cuda")
    step, batch = make_train_step(cfg), _two_rank_batch(cfg)
    ts, met = step(ts, batch)
    _, met2 = step(ts, batch)
    ref = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
           "second_loss": float(met2["loss"])}
    out = {"one_process": ref}
    for route in sorted(PARALLEL_ROUTES_ON_CARD):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            paths = [f"{tmp}/rank{r}.json" for r in range(2)]
            procs = [subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--parallel-rank", route, str(r), str(port), paths[r]],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(2)]
            errs = []
            for p in procs:
                try:
                    _, err = p.communicate(timeout=240)
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    _, err = p.communicate()
                    err = "timeout " + err
                if p.returncode != 0:
                    errs.append(err[-1500:])
            if errs:
                out[route] = {"ok": False, "error": errs}
                bad.append(f"two ranks on the card, route {route}: failed")
                continue
            ranks = [json.load(open(path)) for path in paths]
        ok = all(within(r[k], ref[k], 1e-4, 1e-5)
                 for r in ranks for k in ("loss", "second_loss")) \
            and all(within(r["grad_norm"], ref["grad_norm"], 0.0, 1e-5)
                    for r in ranks) \
            and ranks[0]["loss"] == ranks[1]["loss"]
        out[route] = {
            "ok": ok, "ranks": ranks,
            **{f"{k}_err": max(abs(r[k] - ref[k]) for r in ranks)
               for k in ("loss", "second_loss", "grad_norm")},
            "tol": "losses atol 1e-4 + rtol 1e-5, grad_norm rtol 1e-5"}
        if not ok:
            bad.append(f"two ranks on the card, route {route}: {ranks} vs "
                       f"{ref}")
    return out


def kernel_summary(state):
    """One entry per kernel (and per bf16 instance): errors are the worst
    over the shapes checked; times and the bound are those of the first
    scaled shape at the rate of the kernel's main path (serving at dropout
    0, the backward at the training rate 0.1); launches are summed over
    the paths' runs, each counted from 0 (configs, serve, stream,
    serve_http, train, device_data, train_device, data_tiers, bf16, bench
    and demo),
    and each wrapper counts a launch under its instance's entry."""
    rows = state.get("kernel_rows", {})
    out = []
    for name, meta in KERNELS.items():
        mine = rows.get(name, [])
        rate = meta.get("head_rate", 0.0)
        head = next((r for r in mine if r.get("dropout", 0.0) == rate),
                    mine[0] if mine else {})
        by_path = state.get("launches", {})
        out.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "also_replaces": meta["also_replaces"],
            "dtype": meta.get("dtype", "float32"),
            "launches": sum(p.get(name, 0) for p in by_path.values()),
            "launches_by_path": {path: p[name]
                                 for path, p in by_path.items()
                                 if p.get(name)},
            "max_abs_err": max((r["max_abs_err"] for r in mine),
                               default=None),
            "ms": head.get("ms"), "plain_ms": head.get("plain_ms"),
            "bound_ms": head.get("bound_ms"),
            "bound_by": head.get("bound_by"),
            "library_ms": head.get("library_ms"),
            "device_ms": head.get("device_ms"),
            "library_device_ms": head.get("library_device_ms"),
            "rate": head.get("rate"),
            "shape": head.get("shape"),
            **({"cluster_instances": CLUSTER_INSTANCES[name]}
               if name in CLUSTER_INSTANCES else {}),
            **({"pair_instances": PAIR_INSTANCES[name]}
               if name in PAIR_INSTANCES else {}),
            **({"note": meta["note"]} if "note" in meta else {}),
        })
    return {"kernels": out}


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--parallel-rank":
        sys.path.insert(0, str(ROOT))
        route, rank, port, out_path = sys.argv[2:6]
        return _parallel_rank(route, int(rank), int(port), out_path)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "av_separation_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    state = {"launches": {}}
    failed = []
    for name, phase in (("env", phase_env), ("build", phase_build),
                        ("kernels", phase_kernels), ("golden", phase_golden),
                        ("configs", phase_configs),
                        ("serve", phase_serve), ("profile", phase_profile),
                        ("stream", phase_stream),
                        ("serve_http", phase_serve_http),
                        ("train", phase_train),
                        ("train_profile", phase_train_profile),
                        ("device_data", phase_device_data),
                        ("train_device", phase_train_device),
                        ("train_device_profile", phase_train_device_profile),
                        ("data_tiers", phase_data_tiers),
                        ("bf16", phase_bf16), ("conformer", phase_conformer),
                        ("bench", phase_bench),
                        ("demo", phase_demo), ("parallel", phase_parallel)):
        t0 = time.perf_counter()
        try:
            info = phase(state)
            emit({"phase": name, "ok": True,
                  "s": round(time.perf_counter() - t0, 2), **info})
        except Exception as e:  # noqa: BLE001 — recorded, fails the run
            traceback.print_exc()
            failed.append(name)
            emit({"phase": name, "ok": False, "error": repr(e)[:2000]})
    emit(kernel_summary(state))
    print(card_line(), flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
