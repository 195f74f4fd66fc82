"""On-device synthetic AV batches (port of
`av_separation_tpu/data/device_synthetic.py`).

The host dataset (`data/synthetic.py`) builds every sample in NumPy; this
module draws the same *distribution* on the batch's device: amplitudes
U(0.3, 1), per-speaker frequency jitter U(0.95, 1.05), phase U(0, 2 pi),
reference-semantics STFT, lip patches from window energy with N(0, 0.05)
noise.  It is split in two:

  - ``draw_variates``: every random number of a batch, from a
    `torch.Generator` on the batch's device;
  - ``synthesize``: the deterministic rest, the JAX `generate_batch`'s
    arithmetic step for step, with one stacked STFT of [mixed; clean]
    through `stft_magnitude_fwd` (the CUDA kernel on the card, its plain
    version on the CPU).

A CUDA and a CPU generator draw different numbers from one seed, as JAX's
`rbg` and `threefry` streams do, so the contract is the distribution plus
the deterministic `synthesize`: the tests hand JAX's own variates to
`synthesize` and compare with JAX `generate_batch`.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator

import numpy as np
import torch

from av_separation_torch.config import DataConfig
from av_separation_torch.models.model import resolve_device
from av_separation_torch.ops.kernels.stft import stft_magnitude_fwd
from av_separation_torch.utils.profiling import span

Variates = Dict[str, torch.Tensor]


def _sine_factor_split(n: int) -> int:
    """Largest-divisor-near-sqrt split for the outer-product sine bank:
    returns L (inner length) such that L divides n and A+L is minimal with
    A = n//L.  Returns 0 when n has no useful split (prime / tiny)."""
    best, best_cost = 0, (n + 2, True, 0)
    i = 1
    while i * i <= n:
        if n % i == 0:
            for L in (i, n // i):
                a = n // L
                # tie-break toward an inner length that is a multiple of
                # 128, then the larger L
                cost = (a + L, L % 128 != 0, -L)
                if 1 < L < n and cost < best_cost:
                    best, best_cost = L, cost
        i += 1
    return best


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add rounds it
    (XLA contracts the JAX expression into one): the float32 product is
    exact in float64.  The phase angles reach ~1e4 rad, where float32's ulp
    is ~1e-3, so a second rounding would move the tones visibly."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def _lip_box(cfg: DataConfig):
    return (cfg.frame_h // 4, 3 * cfg.frame_h // 4,
            cfg.frame_w // 4, 3 * cfg.frame_w // 4)


def draw_variates(generator: torch.Generator, cfg: DataConfig,
                  batch_size: int) -> Variates:
    """The random numbers of one batch, on the generator's device:
    amps, jitter, phase (B, S) and the lip noise (B, S, nf, H/2, W/2)."""
    dev = generator.device
    shape = (batch_size, cfg.num_speakers)

    def uniform(lo, hi):
        return torch.empty(shape, device=dev).uniform_(lo, hi,
                                                       generator=generator)

    amps = uniform(0.3, 1.0)
    jitter = uniform(0.95, 1.05)
    phase = uniform(0.0, 2.0 * math.pi)
    h0, h1, w0, w1 = _lip_box(cfg)
    noise = 0.05 * torch.randn(shape + (cfg.num_frames, h1 - h0, w1 - w0),
                               generator=generator, device=dev)
    return {"amps": amps, "jitter": jitter, "phase": phase, "noise": noise}


def clean_waveforms(variates: Variates, cfg: DataConfig) -> torch.Tensor:
    """Per-speaker tones (B, S, N) float32 from the variates.

    The sine bank uses the angle-addition outer product
    sin(w*(a*L+b) + phi) = sin(w*L*a + phi) cos(w*b) + cos(w*L*a + phi) sin(w*b)
    over an (A, L) split of N (`_sine_factor_split`), so an N-sample tone
    costs ~2*(A+L) transcendentals; with no split (N prime or tiny) it
    evaluates sin directly on the float32 time axis, as the JAX module does.
    """
    amps, jitter, phase = (variates[k] for k in ("amps", "jitter", "phase"))
    dev = amps.device
    b, s = amps.shape
    n = cfg.num_samples_audio
    # (B, S), speaker by speaker: scalars need no host-to-device copy.
    freqs = torch.stack([float(f) * jitter[:, i]
                         for i, f in enumerate(cfg.speaker_freqs)], dim=1)
    dt = cfg.duration / n
    split = _sine_factor_split(n)
    if split:
        a_idx = torch.arange(n // split, dtype=torch.float32,
                             device=dev) * float(split)
        b_idx = torch.arange(split, dtype=torch.float32, device=dev)
        w = (2.0 * np.pi * dt) * freqs                          # rad/sample
        th_a = _fma(w[..., None], a_idx, phase[..., None])      # (B, S, A)
        th_b = w[..., None] * b_idx                             # (B, S, L)
        sa, ca = torch.sin(th_a), torch.cos(th_a)
        sb, cb = torch.sin(th_b), torch.cos(th_b)
        tone = (sa[..., :, None] * cb[..., None, :]
                + ca[..., :, None] * sb[..., None, :])
        return (amps[..., None, None] * tone).reshape(b, s, n)
    t_axis = torch.as_tensor(
        np.linspace(0.0, cfg.duration, n, endpoint=False,
                    dtype=np.float64).astype(np.float32), device=dev)
    return amps[..., None] * torch.sin(
        _fma(2.0 * np.pi * freqs[..., None], t_axis, phase[..., None]))


def synthesize(variates: Variates, cfg: DataConfig) -> Dict[str, torch.Tensor]:
    """The batch the variates determine, on their device: mixed_spec
    (B, F, T), lip_frames (B, S*nf, H, W), clean_specs (B, S, F, T)."""
    clean = clean_waveforms(variates, cfg)
    b, s, n = clean.shape
    nf = cfg.num_frames
    # One stacked STFT of [mixed; clean]: one launch per batch.
    mixed = clean.sum(dim=1, keepdim=True)                      # (B, 1, N)
    specs = stft_magnitude_fwd(torch.cat([mixed, clean], dim=1), cfg.n_fft,
                               cfg.hop_length, cfg.num_stft_frames)

    # Lip frames: per-video-frame mean-square energy of each speaker.
    step = n // nf
    energy = clean[..., :nf * step].reshape(b, s, nf, step).square() \
        .mean(dim=-1)
    brightness = torch.clamp(energy * 20.0, max=1.0)            # (B, S, nf)
    patch = torch.clamp(brightness[..., None, None] + variates["noise"],
                        0.0, 1.0)
    h0, h1, w0, w1 = _lip_box(cfg)
    frames = torch.zeros((b, s, nf, cfg.frame_h, cfg.frame_w),
                         dtype=torch.float32, device=clean.device)
    frames[..., h0:h1, w0:w1] = patch
    return {"mixed_spec": specs[:, 0], "lip_frames":
            frames.reshape(b, s * nf, cfg.frame_h, cfg.frame_w),
            "clean_specs": specs[:, 1:]}


def generate_batch(generator: torch.Generator, cfg: DataConfig,
                   batch_size: int, rows: slice = slice(None)
                   ) -> Dict[str, torch.Tensor]:
    """One training batch on the generator's device: mixed_spec (B, F, T),
    lip_frames (B, S*nf, H, W), clean_specs (B, S, F, T).  `rows` keeps
    those rows of the batch: the whole batch's variates are drawn, and
    only those rows are synthesized (a rank's share under a mesh; row i
    is the same whatever the slice).  Under a profiler the whole of it
    is the range `avsep.data.generate`."""
    with span("data.generate"):
        variates = draw_variates(generator, cfg, batch_size)
        return synthesize({k: v[rows] for k, v in variates.items()}, cfg)


def step_generator(seed: int, step: int,
                   device: torch.device | str) -> torch.Generator:
    """A generator on `device` seeded statelessly from (seed, step), the
    counterpart of `jax.random.fold_in(PRNGKey(seed), step)`."""
    word = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(word[0]) & 0x7FFF_FFFF_FFFF_FFFF)


def device_batch_iterator(cfg: DataConfig, batch_size: int, seed: int = 0,
                          start_step: int = 0,
                          device: torch.device | str = "cuda",
                          rows: slice = slice(None)
                          ) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite iterator of batches generated on `device` (the card unless
    the caller asks for 'cpu'), each cut to `rows` (`generate_batch`).
    Step i's generator comes from (seed, i) alone, so a run resumed at
    `start_step` replays exactly the stream an uninterrupted run sees
    from that step, with nothing to fast-forward."""
    device = resolve_device(device)
    step = start_step
    while True:
        yield generate_batch(step_generator(seed, step, device), cfg,
                             batch_size, rows)
        step += 1
