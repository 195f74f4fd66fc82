"""Training-throughput benchmark (port of the JAX package's `bench.py`):
prints ONE JSON line with the headline metric.

Metric: audio-seconds of mixture processed per second on one card by the
fwd+bwd+update training step, at the JAX bench's defaults: the demo config,
batch 128, bfloat16 compute, fused mode.

    python -m av_separation_torch.bench [--config demo] [--steps 250]
        [--batch 128] [--dtype bfloat16] [--mode fused|per_step] [--cpu]

- fused: batches generated on the device, K = max(10, steps // 5) steps a
  call of `make_fused_train_steps` (capped at `steps`, so that a short run
  times what it was asked to), steps // K calls timed after one warm
  call.
- per_step: one host batch of normal noise (seeded), made once and fed to
  `make_train_step` every step; 3 warm steps, then `steps` timed.

The timed window ends on the last loss read back to the host, which
depends on every step before it.  `vs_baseline` is against
REFERENCE_AUDIO_S_PER_S, the reference PyTorch implementation's CPU
training throughput (demo config, batch 8) that the JAX bench compares
with.  On a card the roofline table knows (`utils/roofline.py`), the line
also carries the roofline fields.  Runs on the CUDA device; `--cpu` runs
the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

# Reference torch CPU training throughput (audio-seconds/s), the JAX
# bench's baseline: demo config, batch 8 (bench.py at the repo root).
REFERENCE_AUDIO_S_PER_S = 36.08

DEFAULTS = {"config": "demo", "steps": 250, "batch": 128,
            "dtype": "bfloat16", "mode": "fused"}


def add_flags(p: argparse.ArgumentParser) -> None:
    """The bench's flags, with the JAX bench's defaults."""
    p.add_argument("--config", default=DEFAULTS["config"])
    p.add_argument("--steps", type=int, default=DEFAULTS["steps"])
    p.add_argument("--batch", type=int, default=DEFAULTS["batch"])
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default=DEFAULTS["dtype"])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    p.add_argument("--mode", choices=("fused", "per_step"),
                   default=DEFAULTS["mode"],
                   help="fused: on-device data, K steps a call; per_step: "
                        "one step a call on a host batch")


def run(config: str = DEFAULTS["config"], steps: int = DEFAULTS["steps"],
        batch: int = DEFAULTS["batch"], dtype: str = DEFAULTS["dtype"],
        mode: str = DEFAULTS["mode"], device: str = "cuda") -> dict:
    """One bench run -> the JSON line's dict."""
    import numpy as np
    import torch

    from av_separation_torch.config import get_config
    from av_separation_torch.models.model import resolve_device
    from av_separation_torch.train import (create_train_state,
                                           make_fused_train_steps,
                                           make_train_step)

    dev = resolve_device(device)
    cfg = get_config(config)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype),
        train=dataclasses.replace(cfg.train, batch_size=batch))
    d = cfg.data
    state = create_train_state(cfg, device=dev)

    def sync(loss) -> float:
        value = float(loss)  # a read back: every step before it has run
        if not np.isfinite(value):
            raise FloatingPointError(f"bench loss {value}")
        return value

    if mode == "fused":
        k = min(steps, max(10, steps // 5))
        fused = make_fused_train_steps(cfg, k)
        state, loss = fused(state)  # warm: cuBLAS / cuDNN set-up, builds
        sync(loss)
        n_calls = max(1, steps // k)
        t0 = time.perf_counter()
        for _ in range(n_calls):
            state, loss = fused(state)
        sync(loss)
        dt = time.perf_counter() - t0
        total_steps = n_calls * k
    elif mode == "per_step":
        rng = np.random.default_rng(0)
        host = {
            "mixed_spec": rng.normal(size=(batch, d.freq_bins,
                                           d.num_stft_frames)),
            "lip_frames": rng.normal(size=(batch, d.total_lip_frames,
                                           d.frame_h, d.frame_w)),
            "clean_specs": rng.normal(size=(batch, d.num_speakers,
                                            d.freq_bins, d.num_stft_frames)),
        }
        host = {key: v.astype(np.float32) for key, v in host.items()}
        step_fn = make_train_step(cfg)
        for _ in range(3):
            state, metrics = step_fn(state, host)
        sync(metrics["loss"])
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step_fn(state, host)
        sync(metrics["loss"])
        dt = time.perf_counter() - t0
        total_steps = steps
    else:
        raise ValueError(f"mode {mode!r}: fused or per_step")

    value = total_steps * batch * d.duration / dt
    result = {
        "metric": (f"audio-seconds/s/chip (fwd+bwd train step, {config} "
                   f"config, batch={batch}, {dtype})"),
        "value": round(value, 2),
        "unit": "audio-s/s/chip",
        "vs_baseline": round(value / REFERENCE_AUDIO_S_PER_S, 2),
    }
    if dev.type == "cuda":
        from av_separation_torch.utils.roofline import (roofline,
                                                        train_step_bytes,
                                                        train_step_flops)
        flops = train_step_flops(cfg, batch, include_data_gen=(
            mode == "fused")) * total_steps
        rl = roofline(flops, train_step_bytes(cfg, batch) * total_steps, dt,
                      dtype, torch.cuda.get_device_name(dev))
        if rl:
            rl["bytes_source"] = "analytic_model"
            result.update(rl)
    return result


def cmd(args: argparse.Namespace) -> int:
    """`run` at the parsed `add_flags` flags (`cli bench` and `main`);
    prints its JSON line.  An unknown config exits with the list."""
    from av_separation_torch.config import NAMED_CONFIGS

    if args.config not in NAMED_CONFIGS:
        sys.exit(f"avsep: unknown config '{args.config}'. "
                 f"Available: {', '.join(sorted(NAMED_CONFIGS))}")
    print(json.dumps(run(args.config, args.steps, args.batch, args.dtype,
                         args.mode, "cpu" if args.cpu else "cuda")),
          flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m av_separation_torch.bench")
    add_flags(ap)
    return cmd(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
