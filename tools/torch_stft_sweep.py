#!/usr/bin/env python3
"""Device times of the PyTorch port's STFT kernel on one NVIDIA GPU.

Two modes, each printing one JSON line:

  python3 tools/torch_stft_sweep.py tiles
      the FFT kernel's device time at every tile (frames a block) whose
      block fits shared memory, beside the tile `fft_tile_frames` picks,
      at the shapes its rule was measured on.
  python3 tools/torch_stft_sweep.py rows --root DIR
      the device time of `stft_magnitude_fwd` of the checkout at DIR (this
      one by default) at the rows every version of the kernel runs, on the
      scaled and demo device batches.  Run it over two checkouts in turns
      (A, B, B, A) to compare them on one card.

Device times come from `chip_smoke.device_ms` (torch.profiler kernel
durations; a trace short of events is retaken).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _tones(name):
    import torch

    from av_separation_torch.config import get_config
    from av_separation_torch.data.device_synthetic import (clean_waveforms,
                                                           draw_variates,
                                                           step_generator)
    cfg = get_config(name).data
    v = draw_variates(step_generator(0, 0, "cuda"), cfg, 8)
    clean = clean_waveforms(v, cfg)
    audio = torch.cat([clean.sum(dim=1, keepdim=True), clean], dim=1)
    return audio.reshape(-1, cfg.num_samples_audio).contiguous()


def rows(smoke) -> dict:
    import torch

    from av_separation_torch.ops.kernels.stft import stft_magnitude_fwd
    scaled, demo = _tones("scaled"), _tones("demo")
    odd = torch.randn(3, 2001,
                      generator=torch.Generator().manual_seed(0)).cuda()
    out = {}
    for label, audio, n_fft, hop in [("scaled 512", scaled, 512, 128),
                                     ("demo 512", demo, 512, 128),
                                     ("odd 128", odd, 128, 64),
                                     ("scaled 400", scaled, 400, 160),
                                     ("scaled 448", scaled, 448, 112)]:
        fn = lambda: stft_magnitude_fwd(audio, n_fft, hop)  # noqa: E731
        out[label] = {"device_ms_runs": [smoke.device_ms(fn, 50, None)
                                         for _ in range(3)]}
    return out


def tiles(smoke) -> dict:
    import torch

    from av_separation_torch.ops.kernels import stft
    chosen = stft.fft_tile_frames
    gen = torch.Generator().manual_seed(0)
    out = {}
    try:
        for b, n, n_fft, hop in [(24, 64000, 512, 128), (24, 64000, 514, 128),
                                 (24, 176400, 1102, 441),
                                 (24, 64000, 401, 160),
                                 (24, 176400, 882, 441),
                                 (24, 64000, 4096, 1024),
                                 (24, 64000, 4093, 1000)]:
            audio = torch.randn(b, n, generator=gen).cuda()
            row = {"chosen": chosen(n_fft, hop, b, 1 + n // hop, 132)}
            for tile in (1, 2, 4, 8, 16):
                smem = stft.fft_smem_bytes(n_fft, hop, tile)
                if smem > stft.MAX_SMEM_BYTES:
                    continue
                stft.fft_tile_frames = lambda *a, tile=tile: tile
                fn = lambda: stft.stft_magnitude_fwd(  # noqa: E731
                    audio, n_fft, hop)
                row[str(tile)] = {"smem": smem, "device_ms": [
                    smoke.device_ms(fn, 30, None) for _ in range(2)]}
            out[f"{n_fft}/{hop}"] = row
    finally:
        stft.fft_tile_frames = chosen
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("tiles", "rows"))
    parser.add_argument("--root", default=str(Path(__file__).parents[1]))
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_stft_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from av_separation_torch.ops.kernels import _build
    _build.build(("stft_fft", "stft_mag"))
    result = (tiles if args.mode == "tiles" else rows)(chip_smoke)
    print(json.dumps({"mode": args.mode, "root": args.root,
                      "card": chip_smoke.card_line(), **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
