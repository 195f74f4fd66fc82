#!/usr/bin/env python3
"""Device times of the PyTorch port's STFT kernels on one NVIDIA GPU.

Three modes, each printing one JSON line:

  python3 tools/torch_stft_sweep.py tiles
      the one-block kernel's device time at every tile (frames a block)
      whose block fits shared memory, beside the tile `fft_tile_frames`
      picks, at the shapes its rule was measured on.
  python3 tools/torch_stft_sweep.py rows --root DIR
      the device time of `stft_magnitude_fwd` of the checkout at DIR (this
      one by default) at the rows every version of the kernel runs, on the
      scaled and demo device batches, and above n_fft 4096 (one frame a
      block, 66,000 one-frame signals under Bluestein, and the four-step
      FFT; a checkout that predates them runs what it has there), with
      torch.stft's beside each row above 4096.  Run it over two checkouts
      in turns (A, B, B, A) to compare them on one card.
  python3 tools/torch_stft_sweep.py variants --source FILE [--source
          FILE ...] [--rows small|large]
      builds other versions of `stft_fft.cu` (an earlier one, for example
      `git show HEAD~1:av_separation_torch/csrc/stft_fft.cu > FILE`, or a
      variant) with the same flags, and times the n_fft <= 4096 rows
      (`small`) or those above (`large`, each 'fft' row at tiles 1 and 2
      where they fit) through each and through this checkout's build in
      turns (this, 1, ..., n, n, ..., 1, this), in one process; every
      output is compared with this checkout's, bit for bit.

Device times come from `chip_smoke.device_ms` (torch.profiler kernel
durations; a trace short of events is retaken).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
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


def _small_rows():
    """The n_fft <= 4096 rows: (label, audio, n_fft, hop)."""
    import torch
    scaled, demo = _tones("scaled"), _tones("demo")
    odd = torch.randn(3, 2001,
                      generator=torch.Generator().manual_seed(0)).cuda()
    return [("scaled 512", scaled, 512, 128), ("demo 512", demo, 512, 128),
            ("odd 128", odd, 128, 64), ("scaled 400", scaled, 400, 160),
            ("scaled 448", scaled, 448, 112),
            ("scaled 514 Bluestein", scaled, 514, 128),
            ("scaled 401 odd", scaled, 401, 160)]


def _large_rows():
    """Rows above n_fft 4096 on the scaled batch, 24 noise signals of
    176,400 samples (4 s at 44.1 kHz) and 66,000 noise signals of one
    4,098-sample frame (chip_smoke.py's row: T 1, the fifth field)."""
    import torch
    scaled = _tones("scaled")
    k44 = torch.randn(24, 176400,
                      generator=torch.Generator().manual_seed(1)).cuda()
    frames1 = torch.randn(66000, 4098, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(1))
    return [("scaled 8192", scaled, 8192, 1024),
            ("scaled 16384", scaled, 16384, 4096),
            ("44.1 kHz 4410", k44, 4410, 441),
            ("66,000 x 4098 Bluestein", frames1, 4098, 4098, 1),
            ("44.1 kHz 8194 four-step Bluestein", k44, 8194, 2048),
            ("44.1 kHz 32768 four-step", k44, 32768, 8192)]


def rows(smoke) -> dict:
    from av_separation_torch.ops.kernels import stft
    out = {}
    for label, audio, n_fft, hop, *t in _small_rows() + _large_rows():
        t = t[0] if t else None
        fn = lambda: stft.stft_magnitude_fwd(  # noqa: E731
            audio, n_fft, hop, t)
        out[label] = {"device_ms_runs": [smoke.device_ms(fn, 20, None)
                                         for _ in range(3)]}
        if n_fft > 4096:
            out[label]["torch.stft_device_ms_runs"] = [
                smoke.device_ms(lambda: _torch_stft(audio, n_fft, hop, t),
                                20, None) for _ in range(3)]
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
                                 (24, 64000, 4093, 1000),
                                 (24, 64000, 8192, 1024)]:
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


def _large_noise_rows():
    """The 'large' rows of the variants mode: noise at the shapes of
    chip_smoke.py's rows above n_fft 4096 (6,600 rather than 66,000
    one-frame signals)."""
    import torch
    gen = torch.Generator().manual_seed(3)
    scaled = torch.randn(24, 64000, generator=gen).cuda()
    k44 = torch.randn(24, 176400, generator=gen).cuda()
    frames1 = torch.randn(6600, 4098, generator=gen).cuda()
    long8 = torch.randn(8, 441000, generator=gen).cuda()
    return [("scaled 8192", scaled, 8192, 1024),
            ("scaled 16384", scaled, 16384, 4096),
            ("44.1 kHz 4410", k44, 4410, 441),
            ("6,600 x 4098 Bluestein", frames1, 4098, 4098),
            ("44.1 kHz 8194 four-step Bluestein", k44, 8194, 2048),
            ("44.1 kHz 10125 four-step odd", k44, 10125, 2205),
            ("8 x 441,000 32768 four-step", long8, 32768, 8192)]


def _torch_stft(audio, n_fft: int, hop: int, t: int | None = None):
    """torch.stft with the symmetric Hann window, no centering, on the
    zero-padded signal, then abs, T frames (1 + N // hop by default):
    chip_smoke.py's yardstick."""
    import torch
    import torch.nn.functional as F
    n = audio.shape[-1]
    t = t or 1 + n // hop
    window = torch.hann_window(n_fft, periodic=False, device=audio.device)
    pad = max(0, (t - 1) * hop + n_fft - n)
    return torch.stft(F.pad(audio, (0, pad)), n_fft, hop, window=window,
                      center=False, return_complex=True)[..., :t].abs()


def variants(smoke, sources, which: str) -> dict:
    """Each row through this checkout's `stft_fft` library and through
    each of `sources` (built alike), in turns; the C entry points keep
    their signatures."""
    import ctypes

    import torch

    from av_separation_torch.ops.kernels import _build, stft
    mine = {"fft": stft._fft_entry(), "four_step": stft._four_step_entry()}
    libs = {"this": mine}
    for src in sources:
        target = _build.BUILD_DIR / f"variant_{src.stem}.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC_DIR), "-o", str(target), str(src)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(target))
        lib.avsep_error_string.argtypes = [ctypes.c_int]
        lib.avsep_error_string.restype = ctypes.c_char_p
        entries = {}
        for kind, symbol in (("fft", "avsep_stft_fft_fwd"),
                             ("four_step", "avsep_stft_4step_fwd")):
            if hasattr(lib, symbol):
                fn = getattr(lib, symbol)
                fn.argtypes = mine[kind][1].argtypes
                fn.restype = mine[kind][1].restype
                entries[kind] = (lib, fn)
        libs[src.stem] = entries
    names = list(libs)
    order = names + names[::-1]
    saved = (stft._fft_entry, stft._four_step_entry, stft.fft_tile_frames)
    rows = _small_rows() if which == "small" else _large_noise_rows()
    out = {}
    try:
        for label, audio, n_fft, hop in rows:
            regime = stft.route(n_fft)
            tiles = [None]
            if which == "large" and regime == "fft":
                tiles = [t for t in (1, 2) if stft.fft_smem_bytes(
                    n_fft, hop, t) <= stft.MAX_SMEM_BYTES]
            for tile in tiles:
                if tile is not None:
                    stft.fft_tile_frames = lambda *a, tile=tile: tile
                present = [n for n in names if regime in libs[n]]

                def run(name, audio=audio, n_fft=n_fft, hop=hop,
                        regime=regime):
                    entry = libs[name][regime]
                    stft._fft_entry = stft._four_step_entry = \
                        lambda: entry
                    return stft.stft_magnitude_fwd(audio, n_fft, hop)

                ref = run("this")
                same = {n: bool(torch.equal(ref, run(n))) for n in present}
                times = {n: [] for n in present}
                for name in [n for n in order if n in present]:
                    times[name].append(smoke.device_ms(
                        lambda: run(name), 20, None))
                key = label if tile is None else f"{label}, tile {tile}"
                out[key] = {"bit_identical": same, "device_ms": times}
            stft.fft_tile_frames = saved[2]
            if which == "large":
                out[label + ", torch.stft"] = smoke.device_ms(
                    lambda: _torch_stft(audio, n_fft, hop), 20, None)
    finally:
        stft._fft_entry, stft._four_step_entry, stft.fft_tile_frames = saved
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("tiles", "rows", "variants"))
    parser.add_argument("--root", default=str(Path(__file__).parents[1]))
    parser.add_argument("--source", type=Path, action="append", default=[],
                        help="variants mode: another stft_fft.cu")
    parser.add_argument("--rows", choices=("small", "large"),
                        default="small", help="variants mode: the rows")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_stft_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from av_separation_torch.ops.kernels import _build
    _build.build(("stft_fft",))
    if args.mode == "variants":
        result = variants(chip_smoke, [p.resolve() for p in args.source],
                          args.rows)
    else:
        result = (tiles if args.mode == "tiles" else rows)(chip_smoke)
    print(json.dumps({"mode": args.mode, "root": args.root,
                      "card": chip_smoke.card_line(), **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
