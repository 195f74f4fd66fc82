"""Proof of life: train 100 steps on the synthetic 2-speaker task and show a
large SNR improvement, as the root `demo.py` does for the JAX package
(reference demo.py:116-198; the reference gets +37 dB).

Usage:
    python -m av_separation_torch.demo                # on the card
    python -m av_separation_torch.demo --device cpu   # plain versions, CPU
    python -m av_separation_torch.demo --steps N --pit per_sample

Prints PASS and exits 0 when the improvement is above +35 dB and the masks
lie in [0, 1]; FAIL and exit 1 otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, Optional, Sequence

import torch

from av_separation_torch.config import get_config
from av_separation_torch.data.loader import batch_iterator, eval_batch
from av_separation_torch.data.synthetic import SyntheticAVDataset
from av_separation_torch.train import (create_train_state, make_eval_step,
                                       make_train_step)

PASS_DB = 35.0


def run(device: str = "cuda", steps: int = 100, pit: str = "global",
        log=print, dtype: str = "float32") -> Dict[str, float]:
    """Train the demo config at compute dtype `dtype`; returns the numbers
    the gate reads."""
    cfg = get_config("demo")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype),
        train=dataclasses.replace(cfg.train, steps=steps),
        loss=dataclasses.replace(cfg.loss, pit_mode=pit))
    t0 = time.perf_counter()
    ds = SyntheticAVDataset(cfg.data)
    ebatch = eval_batch(ds, 20)
    log(f"dataset: {len(ds)} samples (generated in "
        f"{time.perf_counter() - t0:.1f}s)")

    state = create_train_state(cfg, device=device)
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"model: d_model={cfg.model.d_model} params={n_params:,} "
        f"device={device} dtype={dtype}")
    eval_fn = make_eval_step()
    pre = eval_fn(state.model, ebatch)
    in_snr = float(pre["input_snr"])
    log(f"Input SNR (mixed):        {in_snr:6.2f} dB")
    log(f"Output SNR (untrained):   {float(pre['output_snr']):6.2f} dB")

    log(f"training {steps} steps (Adam lr={cfg.train.learning_rate}, "
        f"batch={cfg.train.batch_size}, clip={cfg.train.grad_clip_norm}, "
        f"pit={pit}) ...")
    step_fn = make_train_step(cfg)
    batches = batch_iterator(ds, cfg.train.batch_size, seed=cfg.train.seed)
    t0 = time.perf_counter()
    for i in range(steps):
        state, metrics = step_fn(state, next(batches))
        if (i + 1) % cfg.train.log_every == 0:
            log(f"  step {i + 1:4d}  loss {float(metrics['loss']):+8.3f}")
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    audio_s = steps * cfg.train.batch_size * cfg.data.duration
    log(f"  {dt:.1f}s  ({audio_s / dt:.1f} audio-seconds/s)")

    post = eval_fn(state.model, ebatch)
    out = {"input_snr": in_snr, "output_snr": float(post["output_snr"]),
           "mask_min": float(post["mask_min"]),
           "mask_max": float(post["mask_max"]), "train_s": dt,
           "final_loss": float(metrics["loss"])}
    out["improvement_db"] = out["output_snr"] - in_snr
    out["passed"] = (0.0 <= out["mask_min"] and out["mask_max"] <= 1.0
                     and out["improvement_db"] > PASS_DB)
    log(f"Output SNR (trained):     {out['output_snr']:6.2f} dB")
    log(f"SNR improvement:          {out['improvement_db']:+6.2f} dB")
    log(f"mask range: [{out['mask_min']:.3f}, {out['mask_max']:.3f}]")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card) or 'cpu'")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--pit", choices=("global", "per_sample"),
                    default="global")
    args = ap.parse_args(argv)
    out = run(args.device, args.steps, args.pit)
    print("PASS" if out["passed"]
          else f"FAIL (expected > +{PASS_DB:.0f} dB improvement)")
    return 0 if out["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
